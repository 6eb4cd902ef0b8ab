"""Position-aware logits processors — counterpart of
whisper_medusa_tpu/decoding/processors.py.

Each processor is a function of ``(logits, pred_pos)`` where ``pred_pos`` is
the absolute index of the token being predicted, so speculative verification
applies exactly the rules a step-by-step loop would.  Ported: suppress,
begin-suppress, the exponential-decay length penalty, the user ``custom``
hook (the ``logits_processor`` of ``generate``) and the Whisper timestamp
rules (:func:`apply_timestamp_rules`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ProcessorConfig:
    vocab_size: int
    suppress_tokens: Optional[Tuple[int, ...]] = None
    begin_suppress_tokens: Optional[Tuple[int, ...]] = None
    begin_index: int = 0
    # (start, factor), start an absolute position (regulation_start + prompt_len).
    exponential_decay_length_penalty: Optional[Tuple[int, float]] = None
    eos_token_id: int = 0
    # The Whisper timestamp rules (apply_timestamp_rules).
    timestamp_rules: bool = False
    timestamp_begin: int = 50364          # <|0.00|>
    no_timestamps_id: int = 50363
    max_initial_timestamp_index: Optional[int] = 50   # 1.0 s
    # The user hook: a torch function ``(logits (..., V) float32, pred_pos
    # (...,) int32) -> logits`` on the logits' device, applied after the
    # built-ins at every scored position (prefill, verification and draft
    # rows, beams).  The fused verification kernels cannot run it, so a hook
    # routes verification through the materialized logits
    # (decoding/speculative.py).
    custom: Optional[Callable] = None

    def suppress_mask(self) -> Optional[np.ndarray]:
        if not self.suppress_tokens:
            return None
        m = np.zeros((self.vocab_size,), np.bool_)
        m[list(self.suppress_tokens)] = True
        return m

    def begin_suppress_mask(self) -> Optional[np.ndarray]:
        if not self.begin_suppress_tokens:
            return None
        m = np.zeros((self.vocab_size,), np.bool_)
        m[list(self.begin_suppress_tokens)] = True
        return m


def apply_processors(logits: torch.Tensor, pred_pos: torch.Tensor,
                     cfg: ProcessorConfig) -> torch.Tensor:
    """logits (..., V) float32; pred_pos (...,) int — the processed logits."""
    if logits.shape[-1] != cfg.vocab_size:
        raise ValueError(f"logits have {logits.shape[-1]} columns, the config "
                         f"{cfg.vocab_size}")
    dev = logits.device
    logits = logits.float()
    ninf = torch.tensor(-float("inf"), device=dev)
    sup = cfg.suppress_mask()
    if sup is not None:
        logits = torch.where(torch.from_numpy(sup).to(dev), ninf, logits)
    bsup = cfg.begin_suppress_mask()
    if bsup is not None:
        at_begin = (pred_pos == cfg.begin_index)[..., None]
        logits = torch.where(torch.from_numpy(bsup).to(dev) & at_begin, ninf, logits)
    if cfg.exponential_decay_length_penalty is not None:
        start, factor = cfg.exponential_decay_length_penalty
        idx = (pred_pos - start).clamp(min=0).float()
        eos = logits[..., cfg.eos_token_id]
        pen = eos.abs() * (torch.pow(torch.tensor(float(factor), device=dev), idx) - 1.0)
        logits = logits.clone()
        logits[..., cfg.eos_token_id] = torch.where(pred_pos > start, eos + pen, eos)
    if cfg.custom is not None:
        logits = cfg.custom(logits, pred_pos.to(torch.int32)).float()
    return logits


def apply_timestamp_rules(logits: torch.Tensor, pred_pos: torch.Tensor,
                          last_tok: torch.Tensor, penult_tok: torch.Tensor,
                          max_ts: torch.Tensor, cfg: ProcessorConfig) -> torch.Tensor:
    """The Whisper timestamp grammar on base-processed logits (..., V) f32,
    given each position's last token, the token before it and the highest
    timestamp emitted so far (0 for none): ``<|notimestamps|>`` barred;
    timestamps in pairs; timestamps non-decreasing; at the first generated
    position none past ``max_initial_timestamp_index``; and a timestamp
    forced where the timestamp columns' total probability beats the best
    text token.  Barred columns take -inf."""
    dev = logits.device
    v = logits.shape[-1]
    ts_begin = cfg.timestamp_begin
    vocab_ids = torch.arange(v, device=dev)
    is_ts = vocab_ids >= ts_begin
    ninf = torch.tensor(-float("inf"), device=dev)
    logits = logits.clone()
    logits[..., cfg.no_timestamps_id] = ninf

    gen_len = pred_pos - cfg.begin_index
    last_is_ts = (last_tok >= ts_begin) & (gen_len >= 1)
    penult_is_ts = (gen_len < 2) | (penult_tok >= ts_begin)
    sup_ts = (last_is_ts & penult_is_ts)[..., None]
    sup_text = (last_is_ts & ~penult_is_ts)[..., None]
    logits = torch.where((sup_ts & is_ts) | (sup_text & (vocab_ids < cfg.eos_token_id)),
                         ninf, logits)
    floor = torch.where(last_is_ts & ~penult_is_ts, max_ts, max_ts + 1)
    floor = torch.where(max_ts > 0, floor, torch.full_like(floor, ts_begin))
    logits = torch.where(is_ts & (vocab_ids < floor[..., None]), ninf, logits)
    if cfg.max_initial_timestamp_index is not None:
        cap = ts_begin + cfg.max_initial_timestamp_index
        at_begin = (pred_pos == cfg.begin_index)[..., None]
        logits = torch.where(at_begin & (vocab_ids > cap), ninf, logits)

    logprobs = torch.log_softmax(logits, dim=-1)
    ts_lp = torch.logsumexp(torch.where(is_ts, logprobs, ninf), dim=-1)
    max_text = torch.where(is_ts, ninf, logprobs).max(dim=-1).values
    force = (ts_lp > max_text)[..., None]
    return torch.where(force & ~is_ts, ninf, logits)
