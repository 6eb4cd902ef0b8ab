"""Full per-position score stacks, recomputed post-hoc — counterpart of
whisper_medusa_tpu/decoding/scores.py.

The decode loop keeps only the committed tokens' processed log-probs
(``decoding/speculative.py``); ``generate(return_scores="full")`` is served
by ONE teacher-forced decoder pass over the final sequences.  Every logits
processor is a function of ``(logits, pred_pos, history)``
(``decoding/processors.py``), and the history at position ``p`` is fixed
by the committed tokens ``< p``, so the recomputed rows are the rows the
serving loop scored, up to rounding: on the card the pass runs K1 and
cuBLAS and the projection K3 (K7 at int8), where the loop ran K2 and K4 /
K5.

Memory: the (B, T_gen, V) float32 stack is built on the host from chunks
of ``chunk`` positions x B rows; the whole stack never lives on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from whisper_medusa_tpu_torch.config import WhisperDims
from whisper_medusa_tpu_torch.decoding.processors import (ProcessorConfig, apply_processors,
                                                          apply_timestamp_rules)
from whisper_medusa_tpu_torch.models import whisper
from whisper_medusa_tpu_torch.models.whisper import Params


def _timestamp_history(tokens: np.ndarray, begin_index: int, ts_begin: int) -> tuple:
    """Per-position (last, penult, max_ts) history, derived from the committed
    sequence: the values the loop tracked incrementally.

    For the prediction at absolute position ``p``: ``last = tokens[p-1]``,
    ``penult = tokens[p-2]`` and ``max_ts`` is the highest timestamp token among
    the *generated* tokens strictly before ``p`` (0 when none yet); column
    ``p - 1`` of each array holds position ``p``'s value.
    """
    b, t = tokens.shape
    last = tokens[:, :-1]
    penult = np.concatenate([np.zeros((b, 1), tokens.dtype), tokens[:, :-2]], axis=1)
    gen = np.where(np.arange(t - 1)[None, :] >= begin_index, tokens[:, :-1], 0)
    ts_val = np.where(gen >= ts_begin, gen, 0)
    max_ts = np.maximum.accumulate(ts_val, axis=1)
    return last, penult, max_ts


@torch.no_grad()
def full_scores(params: Params, dims: WhisperDims, tokens: np.ndarray, lengths: np.ndarray,
                enc_out: torch.Tensor, pcfg: ProcessorConfig, max_length: int,
                chunk: int = 64) -> np.ndarray:
    """Full processed score stack: (B, max_length - prompt_len, V) float32.

    Row ``i`` is the processed logits that predicted generated token ``i``
    (absolute position ``begin_index + i``), as log-probabilities; rows at or
    past each example's committed length are 0.  One :func:`whisper.decode_train`
    pass (K1 on the card; the int8 branch on a quantized model), then chunks
    of ``chunk`` positions through :func:`whisper.project_logits` (K3, or K7
    at int8), the processors (the ``custom`` hook included), the timestamp
    rules and ``log_softmax`` on the card, each chunk copied to the host.
    The verification rows come from the base hidden state, so Medusa-Block
    needs no block replay.
    """
    tokens = np.asarray(tokens)
    lengths = np.asarray(lengths)
    b = tokens.shape[0]
    begin = pcfg.begin_index
    t_gen = max_length - begin
    dev = enc_out.device
    hidden = whisper.decode_train(
        params, dims, torch.as_tensor(tokens[:, :max_length], dtype=torch.int32, device=dev),
        enc_out).hidden                                       # (B, T, D)
    hist = [torch.as_tensor(a, device=dev) for a in _timestamp_history(
        tokens[:, :max_length], begin, pcfg.timestamp_begin)]
    out = np.zeros((b, t_gen, dims.vocab_size), np.float32)
    for c0 in range(0, t_gen, chunk):
        c1 = min(c0 + chunk, t_gen)
        # The hidden state at absolute position p - 1 predicts position p.
        cols = slice(begin + c0 - 1, begin + c1 - 1)
        logits = whisper.project_logits(params, hidden[:, cols])      # (B, C, V) f32
        pred_pos = torch.arange(begin + c0, begin + c1, dtype=torch.int32,
                                device=dev)[None].expand(b, -1)
        proc = apply_processors(logits, pred_pos, pcfg)
        if pcfg.timestamp_rules:
            last, penult, max_ts = (h[:, cols] for h in hist)
            proc = apply_timestamp_rules(proc, pred_pos, last, penult, max_ts, pcfg)
        out[:, c0:c1] = torch.log_softmax(proc, dim=-1).cpu().numpy()
    gen_idx = np.arange(t_gen)[None, :]
    out[(begin + gen_idx) >= lengths[:, None]] = 0.0
    return out
