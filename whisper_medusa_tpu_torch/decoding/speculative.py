"""Speculative (Medusa) greedy decoding — counterpart of
whisper_medusa_tpu/decoding/speculative.py.

Ported: the chain + greedy path of ``speculative_generate`` at any batch
size for the ``base_head``, ``medusa_block`` and ``vanilla`` variants — one decoder
forward per iteration over the (heads + 1)-node chain (one node for
vanilla), fused verification, longest-prefix acceptance, the window commit,
the finish rule and the EOS backfill.  Verification follows the JAX
package's ``auto`` rule:

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

State lives in device tensors; the loop reads ``finished`` on the host once
per iteration.  Branching trees, sampling, typical acceptance and timestamp
rules are not ported yet (they raise NotImplementedError).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from whisper_medusa_tpu_torch.config import GenerationConfig, WhisperDims
from whisper_medusa_tpu_torch.decoding.buffers import MedusaBuffers
from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig, apply_processors
from whisper_medusa_tpu_torch.models import medusa as medusa_mod
from whisper_medusa_tpu_torch.models import whisper
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod
from whisper_medusa_tpu_torch.ops import verify as verify_mod

Params = Dict[str, Any]

CORRUPTION_SEED = 0x5EED


@dataclasses.dataclass
class SpecResult:
    tokens: torch.Tensor        # (B, max_length) padded, EOS-backfilled
    lengths: torch.Tensor       # (B,) committed lengths (clipped to max_length)
    steps: int                  # decoder iterations (prefill excluded)
    accepted: torch.Tensor      # (B,) accepted draft tokens
    first_logits: torch.Tensor  # (B, V) unprocessed base logits at the first position
    logprobs: torch.Tensor      # (B, max_length) processed log-prob of each token


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


def speculative_generate(params: Params, medusa_params: Optional[Params],
                         dims: WhisperDims, buffers: MedusaBuffers, pcfg: ProcessorConfig,
                         gen: GenerationConfig, enc_out: torch.Tensor,
                         prompt: torch.Tensor, variant: str = "base_head",
                         draft_corruption: Optional[float] = None) -> SpecResult:
    if variant not in ("base_head", "medusa_block", "vanilla"):
        raise ValueError(f"unknown variant {variant!r}")
    vanilla = variant == "vanilla" or medusa_params is None
    # Medusa-Block: base logits from the hidden state, every head drafts
    # from the block layer's output.
    block = None if vanilla or variant != "medusa_block" else medusa_params["block"]
    first_head = 0 if block is not None else 1
    if not buffers.is_chain:
        raise NotImplementedError("branching medusa_choices trees are not ported "
                                  "yet (ROADMAP queue 1: remaining decode modes)")
    if gen.temperature != 0.0:
        raise NotImplementedError("sampling is not ported yet (ROADMAP queue 1: "
                                  "remaining decode modes)")
    dev = enc_out.device
    b, t0 = prompt.shape
    eos, pad, max_length = gen.eos_token_id, gen.pad_token_id, gen.max_length
    num_heads = buffers.num_levels - 1
    n_nodes = buffers.num_nodes
    lv = buffers.num_levels
    vocab = dims.vocab_size
    embed = params["decoder"]["embed_tokens"]
    if vanilla:
        if num_heads:
            raise ValueError("vanilla decoding has no draft heads: medusa_choices (1,)")
        medusa_params = None
    else:
        hw = medusa_params["heads"]["w"]
        shape = (hw["q"] if qmm_mod.is_quantized(hw) else hw).shape
        if shape[1] != 1 or shape[0] != num_heads + first_head or num_heads < 1:
            raise NotImplementedError(
                "fused verification takes single-layer heads, at least one draft "
                "head and a chain over every head")
        heads_w = qmm_mod.wmap(hw, lambda a: a[:, 0])
        heads_b = medusa_params["heads"]["b"][:, 0]
        draft_params = _head_slice(medusa_params, first_head, None)
    # The JAX package's auto rule: two passes at B >= 2, one K4 pass at B = 1
    # where K4 takes the rows (verify.hidden_available), else two passes.
    two_pass = not vanilla and (b >= 2 or not verify_mod.hidden_available(
        b, n_nodes, shape[0], block is not None, vocab, dims.d_model))
    kp1 = 1 if vanilla or two_pass else num_heads + 1

    tree_idx = torch.as_tensor(buffers.tree_indices, dtype=torch.long, device=dev)
    pos_ids = torch.as_tensor(buffers.position_ids, dtype=torch.int32, device=dev)
    retrieve = torch.as_tensor(buffers.retrieve_indices, dtype=torch.long, device=dev)
    sup_masks = verify_mod.masks_for(pcfg, dev)
    vkw = dict(begin_index=pcfg.begin_index, eos_id=pcfg.eos_token_id,
               decay=pcfg.exponential_decay_length_penalty)
    gen_rng = torch.Generator(device=dev)
    gen_rng.manual_seed(CORRUPTION_SEED)
    arange_lv = torch.arange(lv, device=dev)[None, :]
    kp1_rows = torch.arange(kp1, dtype=torch.int32, device=dev)[:, None, None]
    batch_rows = torch.arange(b, device=dev)

    buf_len = max_length + lv + 1
    cache_len = max_length + n_nodes + 1

    def drafts_to_chunk(root, hidden_acc, new_len):
        """Next chunk from the draft heads at one position's hidden state."""
        if vanilla:
            return root[:, None]
        head_out = medusa_mod.apply_heads(draft_params, hidden_acc)   # (K, B, D)
        head_logits = whisper.project_logits(params, head_out).transpose(0, 1)
        draft_pos = new_len[:, None] + torch.arange(num_heads, device=dev)[None, :]
        dproc = apply_processors(head_logits, draft_pos, pcfg)        # (B, K, V)
        drafts = torch.argmax(dproc, dim=-1).to(torch.int32)
        drafts = _corrupt(drafts, draft_corruption, gen_rng, vocab)
        return torch.cat([root[:, None], drafts], dim=1)[:, tree_idx]

    # ---------------- prefill ----------------
    prompt = prompt.to(device=dev, dtype=torch.int32)
    cache = whisper.init_cache(params, dims, enc_out, cache_len,
                               extra_layers=int(block is not None))
    if block is not None:
        whisper.set_block_cross_kv(cache, block, enc_out, dims.decoder_attention_heads)
    out = whisper.decode_step(params, dims, prompt, cache,
                              torch.zeros((b,), dtype=torch.int32, device=dev), block=block)
    h_last = out.hidden[:, -1]
    base = _base_logits_fn(params, medusa_params, variant)(h_last)    # (B, V) f32
    proc = apply_processors(base, torch.full((b,), t0, device=dev), pcfg)
    root0 = torch.argmax(proc, dim=-1).to(torch.int32)
    tokens = torch.full((b, buf_len), pad, dtype=torch.int32, device=dev)
    tokens[:, :t0] = prompt
    tokens[:, t0] = root0
    cur_len = torch.full((b,), t0 + 1, dtype=torch.int32, device=dev)
    finished = (root0 == eos) | (cur_len + num_heads >= max_length)
    draft_src = lambda o: o.hidden if block is None else o.block_hidden
    chunk = drafts_to_chunk(root0, draft_src(out)[:, -1], cur_len)
    logprobs = torch.zeros((b, buf_len), dtype=torch.float32, device=dev)
    logprobs[:, t0] = torch.log_softmax(proc, dim=-1).gather(
        1, root0.long()[:, None])[:, 0]
    accepted = torch.zeros((b,), dtype=torch.int32, device=dev)
    steps = 0

    # ---------------- loop ----------------
    while not bool(finished.all()):
        offsets = cur_len - 1
        out = whisper.decode_step(params, dims, chunk, cache, offsets,
                                  rel_positions=pos_ids, block=block)
        hidden = out.hidden                                           # (B, N, D)
        # Row (k, e, n) predicts absolute position cur_len[e] + n + k.
        pos_rows = (cur_len[None, :, None] + pos_ids[None, None, :]
                    + kp1_rows).reshape(-1)
        gcol_nodes = torch.cat([chunk[:, 1:], torch.zeros_like(chunk[:, :1])], dim=1)
        gcol_rows = torch.cat([
            gcol_nodes.reshape(-1),
            torch.zeros(((kp1 - 1) * b * n_nodes,), dtype=torch.int32, device=dev)])
        flat = hidden.reshape(b * n_nodes, -1)
        if vanilla:
            am, mx, lse, gth = verify_mod.verify_rows(
                flat, embed, pos_rows, gcol_rows, sup_masks, **vkw)
        elif two_pass:
            # Pass A: the verification rows only — the hidden rows themselves
            # (medusa_block), or head 0 of them built by the same GEMM mode
            # as K4's stage A (base_head), with the same bits.
            rows = flat if block is not None else verify_mod.head_rows(
                flat, qmm_mod.wmap(heads_w, lambda a: a[:1]), heads_b[:1])[0]
            am, mx, lse, gth = verify_mod.verify_rows(
                rows, embed, pos_rows, gcol_rows, sup_masks, **vkw)
        else:
            am, mx, lse, gth = verify_mod.verify_hidden(
                hidden, draft_src(out), heads_w, heads_b, embed, pos_rows, gcol_rows,
                sup_masks, identity0=block is not None, **vkw)
        am, mx, lse, gth = (a.reshape(kp1, b, n_nodes) for a in (am, mx, lse, gth))

        best, accept, ptok, pnxt = _greedy_accept(chunk, am[0], retrieve)
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

        node_base = gth[0] - lse[0]                                   # (B, N)
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

        if vanilla:
            chunk = bonus[:, None]
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
    return SpecResult(tokens=out_tokens, lengths=lengths, steps=steps,
                      accepted=accepted, first_logits=base, logprobs=out_lp)
