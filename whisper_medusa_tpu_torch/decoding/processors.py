"""Position-aware logits processors — counterpart of
whisper_medusa_tpu/decoding/processors.py.

Each processor is a function of ``(logits, pred_pos)`` where ``pred_pos`` is
the absolute index of the token being predicted, so speculative verification
applies exactly the rules a step-by-step loop would.  Ported: suppress,
begin-suppress and the exponential-decay length penalty.  The timestamp rules
and the user ``custom`` hook are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    return logits
