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
    """x: (..., D) -> (n_heads, ..., D), float32 accumulation per layer."""
    w = medusa_params["heads"]["w"]
    b = medusa_params["heads"]["b"]
    n_heads, n_layers = w.shape[:2]
    h = x.unsqueeze(0).expand((n_heads,) + tuple(x.shape))
    bshape = (n_heads,) + (1,) * (h.dim() - 2) + (-1,)
    for layer in range(n_layers):
        flat = h.reshape(n_heads, -1, h.shape[-1]).float()
        pre = torch.bmm(flat, w[:, layer].float()).reshape(h.shape)
        pre = pre + b[:, layer].float().reshape(bshape)
        h = h + torch.nn.functional.silu(pre).to(h.dtype)
    return h
