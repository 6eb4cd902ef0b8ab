"""Exact (erf) GELU — counterpart of whisper_medusa_tpu/ops/gelu.py.

The JAX package evaluates erf with a Chebyshev fit because XLA's erf is slow
on the TPU's vector unit; ``torch.erf`` is exact and cheap on a GPU, so the
port uses it directly (the two agree to ~1e-6).
"""

from __future__ import annotations

import math

import torch

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU computed in float32, returned in ``x.dtype``."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * _INV_SQRT2))).to(x.dtype)
