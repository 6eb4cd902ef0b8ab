"""Plain decode-step cross-attention and FFN — counterpart of
whisper_medusa_tpu/ops/decode_ops.py.

These are the per-layer math of ``models/whisper.py::decoder_layer_step``,
which is the plain version of the megastep kernel (ops/megastep.py).
Cross K is head-major (B, H, Dh, S), cross V head-flat (B, S, D), as in the
JAX package's KVCache; in int8 serving both are int8 with f32 per-(head,
position) scales, and the weights may be int8 (ops/qmm.py).
"""

from __future__ import annotations

import torch

from whisper_medusa_tpu_torch.ops import gelu as gelu_mod
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod

NEG_BIG = -0.7 * torch.finfo(torch.float32).max


def cross_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: int, k_s=None, v_s=None) -> torch.Tensor:
    """q (B, H, T, Dh) pre-scaled; k (B, H, Dh, S); v (B, S, D) -> (B, H, T, Dh).

    int8 K/V: the scores are multiplied by ``k_s`` (B, H, S) before the mask
    and softmax, the probabilities by ``v_s`` before the PV product (the
    softmax denominator stays unscaled)."""
    b, h, t, dh = q.shape
    s = torch.einsum("bhtd,bhds->bhts", q.float(), k.float())
    if k_s is not None:
        s = s * k_s[:, :, None, :]
    if kv_len < k.shape[3]:
        col = torch.arange(k.shape[3], device=q.device)
        s = torch.where(col < kv_len, s, torch.tensor(NEG_BIG, device=q.device))
    p = torch.softmax(s, dim=-1)
    if v_s is not None:
        p = p * v_s[:, :, None, :]
    vh = v.reshape(b, v.shape[1], h, dh)
    o = torch.einsum("bhts,bshd->bhtd", p.to(q.dtype).float(), vh.float())
    return o.to(q.dtype)


def ffn_decode(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """fc1 -> exact GELU (on the f32 sum) -> fc2 with f32 accumulation.
    x: (B, T, D); the weights may be int8."""
    h = gelu_mod.gelu(qmm_mod.matmul_plain(x, w1) + b1.float())
    y = qmm_mod.matmul_plain(h.to(x.dtype), w2)
    return (y + b2.float()).to(x.dtype)
