"""Beam search for the Whisper decoder — counterpart of
whisper_medusa_tpu/decoding/beam.py.

The alive / finished-set formulation of the JAX package, one host loop over
device tensors:

  * the beams are folded into the batch for the self cache (B * K rows,
    ``init_cache(self_batch=)``) while the cross K/V stay one row per example
    (``decode_step(cross_beam=K)`` folds each example's K beams' queries into
    one cross-attention block); beams advance one token a step, so the cache
    offset is one shared length;
  * each step takes the top 2K continuations of the alive beams; those that
    end in EOS are offered to the finished set, scored with the GNMT length
    penalty ``((5 + len) / 6) ** length_penalty``; the best K others stay
    alive, and their tokens and self-cache rows are gathered from their
    parent beams;
  * early stopping (HF ``early_stopping=True``): the loop ends once no alive
    beam, at its best possible normalization, can beat the worst kept
    finished score; the loop reads that one boolean on the host a step.

Every ranking goes through :func:`top_k`, which breaks ties to the lowest
index as ``lax.top_k`` does (the initial beams 1..K-1 and the empty finished
slots all score ``NEG``, so ties are common).  The decoder runs the per-op
step (``megastep.fits`` refuses ``cross_beam != 1``, as the JAX gate does).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from whisper_medusa_tpu_torch.config import GenerationConfig, WhisperDims
from whisper_medusa_tpu_torch.decoding.processors import (ProcessorConfig, apply_processors,
                                                           apply_timestamp_rules)
from whisper_medusa_tpu_torch.decoding.speculative import prefill, ts_val
from whisper_medusa_tpu_torch.models import whisper

Params = Dict[str, Any]

NEG = -1e9


@dataclasses.dataclass
class BeamState:
    alive_tokens: torch.Tensor  # (B, K, L)
    alive_lp: torch.Tensor      # (B, K) cumulative log-prob
    fin_tokens: torch.Tensor    # (B, K, L)
    fin_scores: torch.Tensor    # (B, K) length-normalized
    fin_lengths: torch.Tensor   # (B, K)
    cache: Any                  # whisper.KVCache, B * K self rows
    cur_len: int                # shared by every beam
    steps: int
    max_ts: torch.Tensor        # (B, K) running max timestamp token (0: none)


class BeamResult(NamedTuple):
    tokens: torch.Tensor        # (B, max_length) best hypothesis
    lengths: torch.Tensor       # (B,)
    scores: torch.Tensor        # (B,) length-normalized log-prob
    steps: int
    # n-best: the kept finished set, best first
    nbest_tokens: Optional[torch.Tensor] = None   # (B, K, max_length)
    nbest_scores: Optional[torch.Tensor] = None   # (B, K)
    nbest_lengths: Optional[torch.Tensor] = None  # (B, K)


def top_k(x: torch.Tensor, k: int):
    """The k largest entries of the last axis and their indices, best first,
    ties to the lowest index (``lax.top_k``'s order; ``torch.topk`` promises
    none): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _length_norm(length, length_penalty: float, device) -> torch.Tensor:
    return torch.pow((5.0 + torch.as_tensor(length, dtype=torch.float32, device=device))
                     / 6.0, length_penalty)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, M, L)[b, idx[b, j]] -> (B, J, L)."""
    return t.gather(1, idx[:, :, None].expand(-1, -1, t.shape[2]))


def beam_search(params: Params, dims: WhisperDims, pcfg: ProcessorConfig,
                gen: GenerationConfig, enc_out: torch.Tensor, prompt: torch.Tensor,
                num_beams: int = 5, length_penalty: float = 1.0) -> BeamResult:
    """Beam search from ``prompt`` (B, T0) over ``enc_out`` (B, S, D)."""
    b, t0 = prompt.shape
    k = num_beams
    bk = b * k
    dev = enc_out.device
    eos, pad, max_length = gen.eos_token_id, gen.pad_token_id, gen.max_length
    buf = max_length + 1
    use_ts = pcfg.timestamp_rules
    batch_base = (torch.arange(b, device=dev) * k)[:, None]

    cache = whisper.init_cache(params, dims, enc_out, max_length + 1, self_batch=bk)
    prompt = prompt.to(device=dev, dtype=torch.int32)
    prompt_rep = prompt.repeat_interleave(k, dim=0)                   # (BK, T0)
    out = prefill(params, dims, prompt_rep, cache, cross_beam=k)
    logits0 = whisper.project_logits(params, out.hidden[:, -1])       # (BK, V)
    at_t0 = torch.full((bk,), t0, dtype=torch.int32, device=dev)
    proc0 = apply_processors(logits0, at_t0, pcfg)
    if use_ts:
        proc0 = apply_timestamp_rules(
            proc0, at_t0, prompt_rep[:, -1],
            prompt_rep[:, -2] if t0 >= 2 else prompt_rep[:, -1],
            torch.zeros((bk,), dtype=torch.int32, device=dev), pcfg)
    first_lp = torch.log_softmax(proc0, dim=-1).reshape(b, k, -1)

    alive_tokens = torch.full((b, k, buf), pad, dtype=torch.int32, device=dev)
    alive_tokens[:, :, :t0] = prompt[:, None, :]
    # Only beam 0 is live at first (identical prompts would duplicate beams).
    alive_lp = torch.full((b, k), NEG, dtype=torch.float32, device=dev)
    alive_lp[:, 0] = 0.0
    state = BeamState(
        alive_tokens=alive_tokens, alive_lp=alive_lp,
        fin_tokens=torch.full((b, k, buf), pad, dtype=torch.int32, device=dev),
        fin_scores=torch.full((b, k), NEG, dtype=torch.float32, device=dev),
        fin_lengths=torch.zeros((b, k), dtype=torch.int32, device=dev),
        cache=cache, cur_len=t0, steps=0,
        max_ts=torch.zeros((b, k), dtype=torch.int32, device=dev))

    def expand(s: BeamState, step_lp: torch.Tensor):
        """One expansion from per-beam next-token log-probs (B, K, V); the
        new state and the alive beams' new tokens (B, K)."""
        v = step_lp.shape[-1]
        total = (s.alive_lp[:, :, None] + step_lp).reshape(b, k * v)
        top_lp, top_idx = top_k(total, 2 * k)                         # (B, 2K)
        parent = top_idx // v
        token = (top_idx % v).to(torch.int32)
        new_len = s.cur_len + 1
        is_eos = token == eos

        # EOS continuations are offered to the finished set.
        cand_score = torch.where(is_eos, top_lp / _length_norm(new_len, length_penalty, dev),
                                 torch.full_like(top_lp, NEG))
        cand_tokens = _rows(s.alive_tokens, parent)                  # (B, 2K, L)
        cand_tokens[:, :, s.cur_len] = token
        keep_s, keep_i = top_k(torch.cat([s.fin_scores, cand_score], dim=1), k)
        fin_tokens = _rows(torch.cat([s.fin_tokens, cand_tokens], dim=1), keep_i)
        fin_lengths = torch.cat([s.fin_lengths, torch.full_like(token, new_len)],
                                dim=1).gather(1, keep_i)

        # The best K other continuations stay alive.
        a_lp, a_i = top_k(torch.where(is_eos, torch.full_like(top_lp, NEG), top_lp), k)
        a_parent = parent.gather(1, a_i)
        a_token = token.gather(1, a_i)
        a_tokens = _rows(s.alive_tokens, a_parent)
        a_tokens[:, :, s.cur_len] = a_token

        # The self cache's rows by parent beam.  Only rows < cur_len hold
        # anything yet (the rest are written before any step reads them), so
        # only those are gathered: the same cache, a fraction of the copy.
        flat_parent = (batch_base + a_parent).reshape(-1)
        c = s.cache
        for slab in (c.self_k, c.self_v) + ((c.self_s,) if c.self_s is not None else ()):
            slab[:, :, :s.cur_len] = slab[:, flat_parent, :s.cur_len]
        max_ts = torch.maximum(s.max_ts.gather(1, a_parent), ts_val(a_token, pcfg))
        return dataclasses.replace(
            s, alive_tokens=a_tokens, alive_lp=a_lp, fin_tokens=fin_tokens,
            fin_scores=keep_s, fin_lengths=fin_lengths, cur_len=new_len,
            steps=s.steps + 1, max_ts=max_ts), a_token

    def improvable(s: BeamState) -> bool:
        """Whether an alive beam, at the best normalization it can reach,
        still beats the worst kept finished score (one host read)."""
        best_alive = (s.alive_lp / _length_norm(max_length, length_penalty, dev)).max(1).values
        return bool((best_alive > s.fin_scores.min(1).values).any())

    state, last = expand(state, first_lp)
    while state.cur_len < max_length and improvable(state):
        s = state
        offsets = torch.full((bk,), s.cur_len - 1, dtype=torch.int32, device=dev)
        out = whisper.decode_step(params, dims, last.reshape(bk, 1), s.cache, offsets,
                                  cross_beam=k)
        logits = whisper.project_logits(params, out.hidden[:, -1])
        pos = torch.full((bk,), s.cur_len, dtype=torch.int32, device=dev)
        proc = apply_processors(logits, pos, pcfg)
        if use_ts:
            # Each beam's history from its own token buffer.
            last_t = s.alive_tokens[:, :, s.cur_len - 1].reshape(bk)
            pen_t = s.alive_tokens[:, :, max(s.cur_len - 2, 0)].reshape(bk)
            proc = apply_timestamp_rules(proc, pos, last_t, pen_t, s.max_ts.reshape(bk), pcfg)
        state, last = expand(s, torch.log_softmax(proc, dim=-1).reshape(b, k, -1))

    # The best alive hypothesis where nothing finished.
    s = state
    none_fin = s.fin_scores[:, 0] <= NEG / 2
    alive_best = s.alive_tokens[:, 0].clone()
    alive_best[:, s.cur_len] = eos
    best_tokens = torch.where(none_fin[:, None], alive_best, s.fin_tokens[:, 0])
    best_len = torch.where(none_fin, torch.full_like(s.fin_lengths[:, 0], s.cur_len + 1),
                           s.fin_lengths[:, 0])
    best_score = torch.where(none_fin,
                             s.alive_lp[:, 0] / _length_norm(s.cur_len, length_penalty, dev),
                             s.fin_scores[:, 0])
    pos = torch.arange(buf, device=dev)[None, :]
    best_tokens = torch.where(pos < best_len[:, None], best_tokens,
                              torch.full_like(best_tokens, pad))
    nb_tokens = torch.where(pos[None] < s.fin_lengths[:, :, None], s.fin_tokens,
                            torch.full_like(s.fin_tokens, pad))
    return BeamResult(tokens=best_tokens[:, :max_length],
                      lengths=best_len.clamp(max=max_length), scores=best_score,
                      steps=s.steps, nbest_tokens=nb_tokens[:, :, :max_length],
                      nbest_scores=s.fin_scores,
                      nbest_lengths=s.fin_lengths.clamp(max=max_length))
