"""Medusa residual heads — counterpart of whisper_medusa_tpu/models/medusa.py.

All heads live in one stacked tensor ``w`` (n_heads, n_layers, D, D) stored
(in, out), with biases ``b`` (n_heads, n_layers, D); each layer of a head is
``x + SiLU(x @ W + b)`` (the reference's MedusaResBlock).  Initialization
lives in models/bridge.py::from_random.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def apply_heads(medusa_params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., D) -> (n_heads, ..., D), float32 accumulation per layer.

    Each layer goes through ``ops/verify.py::head_rows``: on CUDA tensors the
    skinny GEMM of kernel K4's stage A (so a head row has the same bits for
    every batch size), on CPU tensors its plain version."""
    from whisper_medusa_tpu_torch.ops import verify as verify_mod

    w = medusa_params["heads"]["w"]
    b = medusa_params["heads"]["b"]
    n_heads, n_layers = w.shape[:2]
    d = x.shape[-1]
    h = verify_mod.head_rows(x.reshape(-1, d).contiguous(), w[:, 0].contiguous(),
                             b[:, 0].contiguous())                # (K, M, D)
    for layer in range(1, n_layers):
        h = torch.stack([verify_mod.head_rows(h[k], w[k:k + 1, layer].contiguous(),
                                              b[k:k + 1, layer].contiguous())[0]
                         for k in range(n_heads)])
    return h.reshape((n_heads,) + tuple(x.shape))
