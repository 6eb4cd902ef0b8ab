"""Medusa residual heads — counterpart of whisper_medusa_tpu/models/medusa.py.

All heads live in one stacked tensor ``w`` (n_heads, n_layers, D, D) stored
(in, out), with biases ``b`` (n_heads, n_layers, D); each layer of a head is
``x + SiLU(x @ W + b)`` (the reference's MedusaResBlock).  In int8 serving
``w`` is ``{"q": int8 (n_heads, n_layers, D, D), "s": f32 (n_heads,
n_layers, D)}`` and a layer is ``x + SiLU((x @ bf16(q)) * s + b)``.
Initialization lives in models/bridge.py::init_medusa_params, which also
makes the Medusa-Block variant's ``block`` layer (run by K2, not here).

:func:`apply_heads` serves (K4's stage A on CUDA, no backward);
:func:`apply_heads_train` is the differentiable stack training runs.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def apply_heads(medusa_params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., D) -> (n_heads, ..., D), float32 accumulation per layer.

    Each layer goes through ``ops/verify.py::head_rows``: on CUDA tensors
    kernel K4's stage A, the heads mode of the weight-streaming ``wgmma``
    GEMM, or for f32 heads the f32 GEMM (K slices from D alone in both, so a
    head row has the same bits for every batch size and every number of
    heads in the launch), on CPU tensors its plain version."""
    from whisper_medusa_tpu_torch.ops import qmm as qmm_mod
    from whisper_medusa_tpu_torch.ops import verify as verify_mod

    w = medusa_params["heads"]["w"]
    b = medusa_params["heads"]["b"]
    n_heads, n_layers = (w["q"] if qmm_mod.is_quantized(w) else w).shape[:2]
    d = x.shape[-1]

    def layer_of(sl):
        return qmm_mod.wmap(w, lambda a: a[sl].contiguous()), b[sl].contiguous()

    h = verify_mod.head_rows(x.reshape(-1, d).contiguous(),
                             *layer_of((slice(None), 0)))         # (K, M, D)
    for layer in range(1, n_layers):
        h = torch.stack([verify_mod.head_rows(h[k], *layer_of((slice(k, k + 1), layer)))[0]
                         for k in range(n_heads)])
    return h.reshape((n_heads,) + tuple(x.shape))


def apply_heads_train(medusa_params: Params, x: torch.Tensor) -> torch.Tensor:
    """Differentiable head stack for training, as JAX ``apply_heads`` runs
    it: x (..., D) -> (n_heads, ..., D); per layer ``h + SiLU(h @ W + b)``
    with the product and the bias in float32 (exact products of bf16
    operands), the SiLU branch rounded once to ``x.dtype``."""
    w = medusa_params["heads"]["w"]                     # (H, L, D, D)
    b = medusa_params["heads"]["b"]                     # (H, L, D)
    n_heads, n_layers, d = w.shape[0], w.shape[1], w.shape[-1]
    h = x.reshape(1, -1, d).expand(n_heads, -1, -1)     # (H, M, D)
    for layer in range(n_layers):
        pre = torch.bmm(h.float(), w[:, layer].float()) + b[:, layer, None].float()
        h = h + torch.nn.functional.silu(pre).to(h.dtype)
    return h.reshape((n_heads,) + tuple(x.shape))
