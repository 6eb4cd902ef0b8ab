"""Speculative (Medusa) decoding — counterpart of
whisper_medusa_tpu/decoding/speculative.py.

``speculative_generate`` at any batch size for the ``base_head``,
``medusa_block`` and ``vanilla`` variants — one decoder forward per
iteration over the candidate tree (the (heads + 1)-node chain by default,
one node for vanilla), verification, acceptance, the window commit, the
finish rule and the EOS backfill.  Greedy verification of a chain follows
the JAX package's ``auto`` rule:

  * B = 1: one pass of kernel K4 (``verify_hidden``) scores every (head,
    node) row, so the greedy tokens, the accepted drafts' log-probs and the
    next drafts come out of one embedding stream;
  * B >= 2 (two-pass): pass A scores only the B*N verification rows through
    K5 (``verify_rows``); pass B runs the draft heads at the accepted node
    and projects them through K3 (K7 at int8), as prefill does;
  * vanilla: no draft heads, the B hidden rows through K5, one token per
    iteration.

``base_head``: head 0 is the base head, so the verification rows are
head 0 of ``hidden`` and heads 1..K draft from ``hidden``.
``medusa_block``: the verification rows are ``hidden`` itself (K4's
``identity0`` rows at B = 1, no head rows in pass A) and all K heads draft
from ``block_hidden``, the output of the block layer that K2 runs after the
decoder stack on the cache's last slot.  The decoder forward is K2 at
B <= 8 and the per-op step (K10, K11) beyond (``whisper.decode_step``).

A user hook (``pcfg.custom``, ``generate(logits_processor=...)``), a
branching ``medusa_choices`` tree and ``temperature > 0`` cannot ride the
fused kernels, so with any of them the loop takes the unfused route of the
JAX package at every B: the (K + 1) x B x N rows (the verification row and
every draft head at every node) go through ``whisper.project_logits`` (K3,
or K7 at int8) into materialized f32 logits, and the processors, the hook,
the timestamp rules, the acceptance, the log-softmax and the next drafts
(the accepted node's head logits, the per-level top-k on a tree) are torch;
K4 and K5 do not run.

Trees: the decoder forward takes the tree's ancestor mask (``chunk_mask``)
and depths (``rel_positions``): K2 at B <= 8 and N <= 16, else the per-op
step, where K10's mask mode reads the mask as rows of chunk bits.  After
acceptance the accepted path's K/V rows (and int8 scales, and the
Medusa-Block slot's) are gathered into contiguous cache positions
(:func:`_compact_tree_cache`).  A tree may have fewer levels than the model
has draft heads: the first ``len(choices) - 1`` heads draft.

``temperature > 0``: typical acceptance (:func:`_typical_accept`, the
posterior threshold and alpha of ``GenerationConfig``); with an ``rng``
(a ``torch.Generator`` on the logits' device) the prefill root and every
node's next token are drawn from ``softmax(proc / temperature)`` by a
Gumbel-max over ``torch.rand`` (:func:`_sample`), else they are the argmax.
The draws cannot match the JAX package's threefry draws bit for bit: equal
generators give equal tokens, and the draws follow the tempered
distribution.  The sampler's generator is not the draft-corruption one
(``CORRUPTION_SEED``), so ``draft_corruption`` changes no token of a greedy
request.

Heads of more than one layer (``medusa_num_layers > 1``) verify in two
passes at every B: pass A's rows are head 0 of the hidden state through
``medusa_mod.apply_heads``, pass B drafts from the accepted node through the
same function.

Timestamps (``pcfg.timestamp_rules``): each node carries its history (its
last token, the token before it, the running max timestamp: on a tree from
the static parent / ancestor arrays) and the verification rows take the
Whisper timestamp rules inside K4 / K5's vocab pass (``ts_cfg``), or in
torch on the unfused route; draft rows and pass B keep the base
processors, as in the JAX package.  A prompt longer than
:data:`PREFILL_PIECE` tokens is prefilled in pieces of at most that many
(each causal over itself, seeing the earlier pieces through the cache, as a
decode chunk does), so every piece is a call K2 or the per-op step's mask
mode takes.  ``stop_len`` / ``resume_state`` / ``return_state`` decode in
segments (``generate_stream``).

State lives in device tensors; the loop reads ``finished`` on the host once
per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from whisper_medusa_tpu_torch.config import GenerationConfig, WhisperDims
from whisper_medusa_tpu_torch.decoding.buffers import MedusaBuffers
from whisper_medusa_tpu_torch.decoding.processors import (ProcessorConfig, apply_processors,
                                                           apply_timestamp_rules)
from whisper_medusa_tpu_torch.models import medusa as medusa_mod
from whisper_medusa_tpu_torch.models import whisper
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod
from whisper_medusa_tpu_torch.ops import verify as verify_mod

Params = Dict[str, Any]

CORRUPTION_SEED = 0x5EED
PREFILL_PIECE = 16      # prompt tokens a prefill call takes (K2's chunk, megastep.fits)


@dataclasses.dataclass
class SpecResult:
    tokens: torch.Tensor        # (B, max_length) padded, EOS-backfilled
    lengths: torch.Tensor       # (B,) committed lengths (clipped to max_length)
    steps: int                  # decoder iterations (prefill excluded)
    accepted: torch.Tensor      # (B,) accepted draft tokens
    first_logits: torch.Tensor  # (B, V) unprocessed base logits at the first position
    logprobs: torch.Tensor      # (B, max_length) processed log-prob of each token


@dataclasses.dataclass
class SpecState:
    """The loop's state between segments (``return_state`` / ``resume_state``)."""
    tokens: torch.Tensor        # (B, max_length + levels + 1) committed tokens
    cur_len: torch.Tensor       # (B,) committed length, the pending root included
    finished: torch.Tensor      # (B,) bool
    cache: Any                  # whisper.KVCache
    chunk: torch.Tensor         # (B, N) the next iteration's chain
    steps: int
    accepted: torch.Tensor      # (B,)
    prev2: torch.Tensor         # (B,) the token before the pending root
    max_ts: torch.Tensor        # (B,) highest committed timestamp (0: none)
    logprobs: torch.Tensor      # (B, max_length + levels + 1)
    gen_rng: torch.Generator    # draft corruption draws
    rng: Optional[torch.Generator] = None   # the sampler's draws (temperature > 0)


def prefill(params: Params, dims: WhisperDims, prompt: torch.Tensor, cache,
            block: Optional[Params] = None, cross_beam: int = 1) -> whisper.DecoderOutput:
    """The prompt (B, T0) into ``cache`` from offset 0, in pieces of at most
    :data:`PREFILL_PIECE` tokens: each piece causal over itself and over the
    earlier pieces through the cache.  Returns the last piece's output.
    ``cross_beam``: see ``whisper.decode_step`` (beam search's B * K rows)."""
    b, t0 = prompt.shape
    out = None
    for s0 in range(0, t0, PREFILL_PIECE):
        out = whisper.decode_step(
            params, dims, prompt[:, s0:s0 + PREFILL_PIECE], cache,
            torch.full((b,), s0, dtype=torch.int32, device=prompt.device), block=block,
            cross_beam=cross_beam)
    return out


def ts_val(tok: torch.Tensor, pcfg: ProcessorConfig) -> torch.Tensor:
    """The token where it is a timestamp, else 0."""
    return torch.where(tok >= pcfg.timestamp_begin, tok, torch.zeros_like(tok))


def _head_slice(medusa_params: Params, lo: int, hi: Optional[int]) -> Params:
    """Heads lo..hi; int8 heads ({"q", "s"}) are sliced alike."""
    h = medusa_params["heads"]
    return {"heads": {"w": qmm_mod.wmap(h["w"], lambda a: a[lo:hi]),
                      "b": h["b"][lo:hi]}}


def _base_logits_fn(params: Params, medusa_params: Optional[Params], variant: str):
    """base_head: logits = proj(head0(hidden)) — head 0 is the base head.
    medusa_block and vanilla: logits = proj(hidden)."""
    if medusa_params is None or variant != "base_head":
        return lambda hidden: whisper.project_logits(params, hidden)
    head0 = _head_slice(medusa_params, 0, 1)

    def fn(hidden):
        return whisper.project_logits(params, medusa_mod.apply_heads(head0, hidden)[0])
    return fn


def _greedy_accept(chunk, proc_argmax, retrieve):
    """Greedy longest-prefix-match acceptance over the candidate paths."""
    ptok = chunk[:, retrieve]                        # (B, P, Lv)
    pnxt = proc_argmax[:, retrieve]
    match = (ptok[:, :, 1:] == pnxt[:, :, :-1]).to(torch.int32)
    acc_len = torch.cumprod(match, dim=-1).sum(-1)   # (B, P)
    best = torch.argmax(acc_len, dim=-1)             # ties -> first path
    accept = acc_len.max(dim=-1).values
    return best, accept, ptok, pnxt


def _corrupt(drafts, draft_corruption, gen_rng, vocab_size):
    """Replace each draft by (draft + 1) % V with probability draft_corruption."""
    if draft_corruption is None:
        return drafts
    u = torch.rand(drafts.shape, generator=gen_rng, device=drafts.device)
    return torch.where(u < draft_corruption, (drafts + 1) % vocab_size, drafts)


def _compact_tree_cache(cache, offsets: torch.Tensor, path_nodes: torch.Tensor):
    """In place: gather the accepted path's self K/V rows (and int8 scales)
    of every slot into contiguous positions, row ``offsets[b] + i`` taking
    row ``offsets[b] + path_nodes[b, i]``; returns ``cache``.  The slabs are
    (L (+1), B, max_len, D), ``self_s`` (L (+1), B, max_len, 2H)."""
    b, lv = path_nodes.shape
    off = offsets.long()[:, None]
    src = off + path_nodes.long()
    dst = off + torch.arange(lv, device=off.device)[None, :]
    rows = torch.arange(b, device=off.device)[:, None]
    for buf in (cache.self_k, cache.self_v, cache.self_s):
        if buf is not None:
            buf[:, rows, dst] = buf[:, rows, src]
    return cache


def _typical_accept(chunk, proc, nxt, retrieve, temperature: float,
                    posterior_threshold: float, posterior_alpha: float):
    """Typical acceptance over the candidate paths (the JAX package's
    ``_typical_accept``): a path token is accepted while its probability
    under ``softmax(proc / temperature)`` at its parent node exceeds
    min(threshold, alpha * exp(-entropy)); among the longest accepted
    prefixes the one of highest summed log-probability wins (ties: the
    first path).  ``nxt`` (B, N) gives each node's next token."""
    ptok = chunk[:, retrieve]                                     # (B, P, Lv)
    plog = proc[torch.arange(chunk.shape[0], device=proc.device)[:, None, None],
                retrieve[None, :, :-1]]                           # (B, P, Lv-1, V)
    probs = torch.softmax(plog / temperature, dim=-1)
    cand = probs.gather(-1, ptok[:, :, 1:, None].long())[..., 0]  # (B, P, Lv-1)
    entropy = -torch.sum(probs * torch.log(probs + 1e-5), dim=-1)
    threshold = torch.minimum(torch.tensor(posterior_threshold, device=proc.device),
                              torch.exp(-entropy) * posterior_alpha)
    acc_len = torch.cumprod((cand > threshold).to(torch.int32), dim=-1).sum(-1)   # (B, P)
    max_acc = acc_len.max(dim=-1, keepdim=True).values
    idx = torch.arange(cand.shape[-1], device=proc.device)
    likelihood = torch.where(idx[None, None] < acc_len[..., None], torch.log(cand + 1e-30),
                             torch.zeros_like(cand)).sum(-1)
    score = torch.where(acc_len == max_acc, likelihood,
                        torch.full_like(likelihood, -float("inf")))
    best = torch.argmax(score, dim=-1)                            # ties -> first path
    return best, max_acc[:, 0], ptok, nxt[:, retrieve]


def _sample(proc: torch.Tensor, temperature: float, rng: torch.Generator) -> torch.Tensor:
    """One draw per row of ``softmax(proc / temperature)``: the Gumbel-max
    argmax(proc / T - log(-log u)), u ~ U(0, 1) from ``rng`` on proc's
    device (as ``jax.random.categorical``; suppressed -inf logits are never
    drawn).  int32, proc's leading shape."""
    u = torch.rand(proc.shape, generator=rng, device=proc.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2 ** -24)))
    return torch.argmax(proc / temperature + gumbel, dim=-1).to(torch.int32)


def _tree_history(buffers: MedusaBuffers, device):
    """A tree node's parent (-1 at the root) and its ancestor-or-self mask,
    the static structure its timestamp history reads."""
    pos, mask = buffers.position_ids, buffers.attn_mask
    parent = [-1] + [int(np.where(mask[n] & (pos == pos[n] - 1))[0][0])
                     for n in range(1, buffers.num_nodes)]
    return (torch.tensor(parent, dtype=torch.long, device=device),
            torch.as_tensor(mask, dtype=torch.bool, device=device))


def speculative_generate(params: Params, medusa_params: Optional[Params],
                         dims: WhisperDims, buffers: MedusaBuffers, pcfg: ProcessorConfig,
                         gen: GenerationConfig, enc_out: torch.Tensor,
                         prompt: torch.Tensor, variant: str = "base_head",
                         draft_corruption: Optional[float] = None,
                         resume_state: Optional[SpecState] = None,
                         stop_len: Optional[int] = None, return_state: bool = False,
                         rng: Optional[torch.Generator] = None):
    """The decode loop; a :class:`SpecResult` (with the :class:`SpecState`
    when ``return_state``).  ``stop_len`` pauses once every unfinished
    example's ``cur_len`` reaches it; ``resume_state`` continues a paused
    segment (no prefill; ``first_logits`` is then zeros; the state's
    sampler generator continues and ``rng`` is not read).  Segmented
    decoding commits the same tokens as one call.  ``rng``: with
    ``gen.temperature > 0``, a ``torch.Generator`` on ``enc_out``'s device
    that draws the tokens (sampling); without one the tokens are the argmax
    and typical acceptance decides."""
    from whisper_medusa_tpu_torch.decoding.beam import top_k

    if variant not in ("base_head", "medusa_block", "vanilla"):
        raise ValueError(f"unknown variant {variant!r}")
    vanilla = variant == "vanilla" or medusa_params is None
    # Medusa-Block: base logits from the hidden state, every head drafts
    # from the block layer's output.
    block = None if vanilla or variant != "medusa_block" else medusa_params["block"]
    first_head = 0 if block is not None else 1
    dev = enc_out.device
    b, t0 = prompt.shape
    eos, pad, max_length = gen.eos_token_id, gen.pad_token_id, gen.max_length
    num_heads = buffers.num_levels - 1
    n_nodes = buffers.num_nodes
    lv = buffers.num_levels
    vocab = dims.vocab_size
    embed = params["decoder"]["embed_tokens"]
    tree = not buffers.is_chain
    greedy = gen.temperature == 0.0
    if resume_state is not None:
        rng = resume_state.rng
    sample = not greedy and rng is not None
    n_head_layers = 1
    if vanilla:
        if num_heads:
            raise ValueError("vanilla decoding has no draft heads: medusa_choices (1,)")
        medusa_params = None
    else:
        hw = medusa_params["heads"]["w"]
        n_all, n_head_layers = (hw["q"] if qmm_mod.is_quantized(hw) else hw).shape[:2]
        if num_heads < 1 or n_all < num_heads + first_head:
            raise ValueError(
                f"medusa_choices of {lv} levels take {num_heads} draft heads and at least "
                f"one; the model has {n_all - first_head}")
        # The first len(choices) - 1 draft heads (and base_head's head 0).
        n_used = num_heads + first_head
        used_params = _head_slice(medusa_params, 0, n_used)
        draft_params = _head_slice(medusa_params, first_head, n_used)
        head0 = _head_slice(medusa_params, 0, 1)
    # A hook, a tree or temperature > 0 takes the unfused route
    # (materialized logits), as in the JAX package; else its auto rule: two
    # passes at B >= 2 (and for heads of more than one layer), one K4 pass at
    # B = 1 where K4 takes the rows (verify.hidden_available), else two
    # passes.
    unfused = pcfg.custom is not None or tree or not greedy
    two_pass = not vanilla and not unfused and (
        b >= 2 or n_head_layers > 1 or not verify_mod.hidden_available(
            b, n_nodes, n_used, block is not None, vocab, dims.d_model))
    kp1 = 1 if vanilla or two_pass else num_heads + 1
    if not (vanilla or unfused or two_pass):
        heads_w = qmm_mod.wmap(used_params["heads"]["w"], lambda a: a[:, 0])
        heads_b = used_params["heads"]["b"][:, 0]

    tree_idx = torch.as_tensor(buffers.tree_indices, dtype=torch.long, device=dev)
    pos_ids = torch.as_tensor(buffers.position_ids, dtype=torch.int32, device=dev)
    retrieve = torch.as_tensor(buffers.retrieve_indices, dtype=torch.long, device=dev)
    chunk_mask = (torch.as_tensor(buffers.attn_mask, dtype=torch.bool, device=dev)
                  if tree else None)
    sup_masks = verify_mod.masks_for(pcfg, dev)
    vkw = dict(begin_index=pcfg.begin_index, eos_id=pcfg.eos_token_id,
               decay=pcfg.exponential_decay_length_penalty)
    use_ts = pcfg.timestamp_rules
    ts_cfg = verify_mod.ts_cfg_for(pcfg) if use_ts else None
    if use_ts and tree:
        ts_parents, ts_anc = _tree_history(buffers, dev)
    arange_lv = torch.arange(lv, device=dev)[None, :]
    kp1_rows = torch.arange(kp1, dtype=torch.int32, device=dev)[:, None, None]
    batch_rows = torch.arange(b, device=dev)

    buf_len = max_length + lv + 1
    cache_len = max_length + n_nodes + 1

    def chunk_from_draft_logits(root, head_logits, new_len):
        """Next chunk from the heads' logits (B, K, V) at one position: head
        k's draft predicts position new_len + k - 1; level l takes its
        head's top choices[l] tokens (lax.top_k's order)."""
        draft_pos = new_len[:, None] + torch.arange(num_heads, dtype=torch.int32,
                                                    device=dev)[None, :]
        dproc = apply_processors(head_logits, draft_pos, pcfg)        # (B, K, V)
        if tree:
            drafts = torch.cat([top_k(dproc[:, l - 1], k)[1] if k > 1 else
                                torch.argmax(dproc[:, l - 1], dim=-1)[:, None]
                                for l, k in enumerate(buffers.choices) if l], dim=1)
        else:
            drafts = torch.argmax(dproc, dim=-1)
        drafts = _corrupt(drafts.to(torch.int32), draft_corruption, gen_rng, vocab)
        return torch.cat([root[:, None], drafts], dim=1)[:, tree_idx]

    def drafts_to_chunk(root, hidden_acc, new_len):
        """Next chunk from the draft heads at one position's hidden state."""
        if vanilla:
            return root[:, None]
        head_out = medusa_mod.apply_heads(draft_params, hidden_acc)   # (K, B, D)
        return chunk_from_draft_logits(
            root, whisper.project_logits(params, head_out).transpose(0, 1), new_len)

    def stack_rows(hidden, hsrc):
        """The unfused route's (kp1, B, N, D) rows: the verification row (the
        hidden state, or head 0 of it for base_head) then the draft heads."""
        if vanilla:
            return hidden[None]
        if block is None:
            return medusa_mod.apply_heads(used_params, hidden)
        return torch.cat([hidden[None], medusa_mod.apply_heads(draft_params, hsrc)])

    def next_tokens(proc):
        """Each row's next token: drawn at temperature > 0 with an rng, else
        the argmax."""
        if sample:
            return _sample(proc, gen.temperature, rng)
        return torch.argmax(proc, dim=-1).to(torch.int32)

    draft_src = lambda o: o.hidden if block is None else o.block_hidden

    # ---------------- prefill (skipped when resuming) ----------------
    if resume_state is None:
        gen_rng = torch.Generator(device=dev)
        gen_rng.manual_seed(CORRUPTION_SEED)
        prompt = prompt.to(device=dev, dtype=torch.int32)
        cache = whisper.init_cache(params, dims, enc_out, cache_len,
                                   extra_layers=int(block is not None))
        if block is not None:
            whisper.set_block_cross_kv(cache, block, enc_out, dims.decoder_attention_heads)
        out = prefill(params, dims, prompt, cache, block)
        h_last = out.hidden[:, -1]
        base = _base_logits_fn(params, medusa_params, variant)(h_last)    # (B, V) f32
        at_t0 = torch.full((b,), t0, dtype=torch.int32, device=dev)
        proc = apply_processors(base, at_t0, pcfg)
        if use_ts:
            proc = apply_timestamp_rules(
                proc, at_t0, prompt[:, -1], prompt[:, -2] if t0 >= 2 else prompt[:, -1],
                torch.zeros((b,), dtype=torch.int32, device=dev), pcfg)
        root0 = next_tokens(proc)
        tokens = torch.full((b, buf_len), pad, dtype=torch.int32, device=dev)
        tokens[:, :t0] = prompt
        tokens[:, t0] = root0
        cur_len = torch.full((b,), t0 + 1, dtype=torch.int32, device=dev)
        finished = (root0 == eos) | (cur_len + num_heads >= max_length)
        chunk = drafts_to_chunk(root0, draft_src(out)[:, -1], cur_len)
        logprobs = torch.zeros((b, buf_len), dtype=torch.float32, device=dev)
        logprobs[:, t0] = torch.log_softmax(proc, dim=-1).gather(
            1, root0.long()[:, None])[:, 0]
        accepted = torch.zeros((b,), dtype=torch.int32, device=dev)
        steps = 0
        prev2, max_ts = prompt[:, -1], ts_val(root0, pcfg)
    else:
        st = resume_state
        tokens, cur_len, finished, cache, chunk = (st.tokens, st.cur_len, st.finished,
                                                   st.cache, st.chunk)
        steps, accepted, prev2, max_ts = st.steps, st.accepted, st.prev2, st.max_ts
        logprobs, gen_rng = st.logprobs, st.gen_rng
        base = torch.zeros((b, vocab), dtype=torch.float32, device=dev)

    # ---------------- loop ----------------
    while True:
        active = ~finished
        if stop_len is not None:
            active = active & (cur_len < stop_len)
        if not bool(active.any()):
            break
        offsets = cur_len - 1
        out = whisper.decode_step(params, dims, chunk, cache, offsets,
                                  rel_positions=pos_ids, chunk_mask=chunk_mask, block=block)
        hidden = out.hidden                                           # (B, N, D)
        if use_ts:
            # Each node's history: its last token, the one before it and the
            # running max timestamp (on a tree along its ancestors).
            if tree:
                penult_nodes = torch.where(ts_parents[None, :] >= 0,
                                           chunk[:, ts_parents.clamp(min=0)], prev2[:, None])
                ts_chunk = ts_val(chunk, pcfg)
                path_max = torch.where(ts_anc[None], ts_chunk[:, None, :],
                                       torch.zeros_like(ts_chunk)[:, None, :]).amax(dim=2)
                node_max_ts = torch.maximum(max_ts[:, None], path_max)
            else:
                penult_nodes = torch.cat([prev2[:, None], chunk[:, :-1]], dim=1)
                node_max_ts = torch.maximum(
                    max_ts[:, None], torch.cummax(ts_val(chunk, pcfg), dim=1).values)
        if unfused:
            # Every row's logits materialized (K3 / K7), the rest in torch.
            logits = whisper.project_logits(params, stack_rows(hidden, draft_src(out)))
            pred_pos = cur_len[:, None] + pos_ids[None, :]
            proc = apply_processors(logits[0], pred_pos, pcfg)        # (B, N, V)
            if use_ts:
                proc = apply_timestamp_rules(proc, pred_pos, chunk, penult_nodes,
                                             node_max_ts, pcfg)
            nxt = next_tokens(proc)
        else:
            # Row (k, e, n) predicts absolute position cur_len[e] + n + k.
            pos_rows = (cur_len[None, :, None] + pos_ids[None, None, :]
                        + kp1_rows).reshape(-1)
            gcol_nodes = torch.cat([chunk[:, 1:], torch.zeros_like(chunk[:, :1])], dim=1)
            gcol_rows = torch.cat([
                gcol_nodes.reshape(-1),
                torch.zeros(((kp1 - 1) * b * n_nodes,), dtype=torch.int32, device=dev)])
            flat = hidden.reshape(b * n_nodes, -1)
            ts_kw = {}
            if use_ts:
                # Only the k = 0 verification rows read the history (draft
                # rows keep the base processors), zeros for the rest.
                zero_tail = torch.zeros(((kp1 - 1) * b * n_nodes,), dtype=torch.int32,
                                        device=dev)
                ts_kw = dict(ts_cfg=ts_cfg, n_verif=b * n_nodes,
                             last=torch.cat([chunk.reshape(-1), zero_tail]),
                             penult=torch.cat([penult_nodes.reshape(-1), zero_tail]),
                             maxts=torch.cat([node_max_ts.reshape(-1), zero_tail]))
            if vanilla:
                am, mx, lse, gth = verify_mod.verify_rows(
                    flat, embed, pos_rows, gcol_rows, sup_masks, **vkw, **ts_kw)
            elif two_pass:
                # Pass A: the verification rows only — the hidden rows
                # themselves (medusa_block), or head 0 of them (base_head:
                # for one-layer heads the GEMM mode of K4's stage A, with
                # the same bits).
                rows = flat if block is not None else medusa_mod.apply_heads(head0, flat)[0]
                am, mx, lse, gth = verify_mod.verify_rows(
                    rows, embed, pos_rows, gcol_rows, sup_masks, **vkw, **ts_kw)
            else:
                am, mx, lse, gth = verify_mod.verify_hidden(
                    hidden, draft_src(out), heads_w, heads_b, embed, pos_rows, gcol_rows,
                    sup_masks, identity0=block is not None, **vkw, **ts_kw)
            am, mx, lse, gth = (a.reshape(kp1, b, n_nodes) for a in (am, mx, lse, gth))
            nxt = am[0]

        if greedy:
            best, accept, ptok, pnxt = _greedy_accept(chunk, nxt, retrieve)
        else:
            best, accept, ptok, pnxt = _typical_accept(
                chunk, proc, nxt, retrieve, gen.temperature, gen.posterior_threshold,
                gen.posterior_alpha)
        best_tok = ptok[batch_rows, best]                             # (B, Lv)
        best_nxt = pnxt[batch_rows, best]
        acc_col = accept[:, None].long()
        bonus = best_nxt.gather(1, acc_col)[:, 0].to(torch.int32)

        shifted = torch.cat([best_tok[:, 1:], torch.zeros_like(best_tok[:, :1])], dim=1)
        window = torch.where(arange_lv < acc_col, shifted,
                             torch.where(arange_lv == acc_col, bonus[:, None],
                                         torch.full_like(shifted, pad)))
        cols = (cur_len[:, None].long() + arange_lv).clamp(max=buf_len - 1)
        tokens = torch.where(finished[:, None], tokens, tokens.scatter(1, cols, window))

        best_nodes = retrieve[best]                                   # (B, Lv)
        if unfused:
            # Committed token i is scored by path node i's processed logits.
            node_lp = torch.log_softmax(proc, dim=-1)[batch_rows[:, None], best_nodes]
            win_lp = node_lp.gather(2, window.clamp(min=0).long()[:, :, None])[..., 0]
        else:
            node_base = gth[0] - lse[0]                               # (B, N)
            node_bonus = mx[0] - lse[0]
            bonus_lp = node_bonus.gather(1, acc_col)
            win_lp = torch.where(arange_lv < acc_col, node_base, bonus_lp)
        win_lp = torch.where(arange_lv <= acc_col, win_lp, torch.zeros_like(win_lp))
        logprobs = torch.where(finished[:, None], logprobs,
                               logprobs.scatter(1, cols, win_lp))

        ncommit = torch.where(finished, torch.zeros_like(accept), accept + 1)
        new_len = (cur_len + ncommit).to(torch.int32)
        eos_hit = ((window == eos) & (arange_lv <= acc_col)).any(-1)
        accepted = accepted + torch.where(finished, torch.zeros_like(accept), accept)
        if tree:
            _compact_tree_cache(cache, offsets, best_nodes)

        if vanilla:
            chunk = bonus[:, None]
        elif unfused:
            # The draft heads' logits at the accepted node, already projected.
            acc_node = best_nodes.gather(1, acc_col)[:, 0]
            chunk = chunk_from_draft_logits(
                bonus, logits[1:, batch_rows, acc_node].transpose(0, 1), new_len)
        elif two_pass:
            # Pass B: the draft heads at the accepted node's hidden state (or
            # block output; chain: the accepted node is node `accept`), as in
            # prefill.
            chunk = drafts_to_chunk(bonus, draft_src(out)[batch_rows, accept.long()],
                                    new_len)
        else:
            # The accepted node's head rows, already scored by K4.
            drafts = am[1:].permute(1, 0, 2).gather(
                2, acc_col[:, None, :].expand(b, num_heads, 1))[:, :, 0]
            drafts = _corrupt(drafts, draft_corruption, gen_rng, vocab)
            chunk = torch.cat([bonus[:, None], drafts], dim=1)[:, tree_idx]

        # Timestamp history: the pending root is now the bonus token, the one
        # before it the last accepted token (the old root at accept 0).
        prev2 = torch.where(finished, prev2, best_tok.gather(1, acc_col)[:, 0])
        win_ts = torch.where(arange_lv <= acc_col, ts_val(window, pcfg),
                             torch.zeros_like(window))
        max_ts = torch.where(finished, max_ts, torch.maximum(max_ts, win_ts.max(-1).values))

        finished = finished | eos_hit | (new_len + num_heads >= max_length)
        cur_len = new_len
        steps += 1

    # ---------------- finalize ----------------
    pos = torch.arange(max_length, device=dev)[None, :]
    lengths = cur_len.clamp(max=max_length)
    out_tokens = torch.where(pos < lengths[:, None], tokens[:, :max_length],
                             torch.full_like(tokens[:, :max_length], pad))
    is_eos = out_tokens == eos
    first = torch.argmax(is_eos.to(torch.int32), dim=-1)
    backfill = is_eos.any(-1)[:, None] & (pos > first[:, None])
    out_tokens = torch.where(backfill, torch.full_like(out_tokens, eos), out_tokens)
    out_lp = torch.where(pos < lengths[:, None], logprobs[:, :max_length],
                         torch.zeros_like(logprobs[:, :max_length]))
    result = SpecResult(tokens=out_tokens, lengths=lengths, steps=steps,
                        accepted=accepted, first_logits=base, logprobs=out_lp)
    if return_state:
        return result, SpecState(tokens=tokens, cur_len=cur_len, finished=finished,
                                 cache=cache, chunk=chunk, steps=steps, accepted=accepted,
                                 prev2=prev2, max_ts=max_ts, logprobs=logprobs,
                                 gen_rng=gen_rng, rng=rng)
    return result
