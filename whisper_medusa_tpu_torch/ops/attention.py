"""Full-sequence attention in (B, H, S, Dh) layout — kernel K1.

Replaces the TPU kernel ``whisper_medusa_tpu/ops/attention.py::_attention_kernel``
(launched by ``_attention_pallas``), which keeps a whole head's K/V resident in
VMEM and runs a one-pass softmax.  That design does not carry over: 1536 x 64
bf16 K plus V is 384 KB, more than an SM's 227 KB of shared memory.

The Hopper kernel (``csrc/attention.cu``) is a flash-style forward: one CTA
per (batch, head, 64-query block), K/V streamed through shared memory in
64-key tiles, QK^T and PV on the tensor cores (WMMA, bf16 in, f32 out), online
softmax in f32, bf16 output.  It masks ``key < kv_len`` (and causality) and
the ragged sequence edge itself, so the encoder runs its 1500 frames unpadded.
At the encoder's shapes (B=1, H=20, S=1500, Dh=64) it is bound by tensor-core
throughput and the softmax's exp/shuffle work, not by bytes (11.5 GFLOP against
15 MB of q/k/v/out per layer).
"""

from __future__ import annotations

from typing import Optional

import torch

from whisper_medusa_tpu_torch.ops import cuda_lib

NEG_BIG = -0.7 * torch.finfo(torch.float32).max

launches = 0     # kernel launches (not plain-version calls)


def attention_plain(q, k, v, kv_len: int, causal: bool) -> torch.Tensor:
    """Plain PyTorch version: same layout and masks, float32 softmax.

    Mirrors ``_attention_xla``: f32 scores, masked to NEG_BIG, softmax, the
    probabilities cast to the value dtype before PV with f32 accumulation."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    col = torch.arange(k.shape[2], device=q.device)
    mask = col[None, :] < kv_len
    if causal:
        row = torch.arange(q.shape[2], device=q.device)
        mask = mask & (col[None, :] <= row[:, None])
    s = torch.where(mask, s, torch.tensor(NEG_BIG, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype)


def attention_kernel(q, k, v, kv_len: int, causal: bool) -> torch.Tensor:
    """Launch K1.  q: (B, H, Sq, 64), k/v: (B, H, Skv, 64), bf16, contiguous."""
    global launches
    cuda_lib.require_cuda("attention", q, k, v)
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    if dh != 64 or k.shape != (b, h, skv, dh) or v.shape != k.shape:
        raise ValueError(f"attention kernel takes Dh=64 and matching K/V, got "
                         f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not 1 <= kv_len <= skv:
        raise ValueError(f"kv_len {kv_len} outside [1, {skv}]")
    out = torch.empty_like(q)
    cuda_lib.launch("wm_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), b, h, sq, skv, dh, kv_len,
                    int(causal))
    launches += 1
    return out


def full_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None,
                        causal: bool = False) -> torch.Tensor:
    """Attention over (B, H, S, Dh) tensors, q pre-scaled.

    CUDA tensors launch K1; CPU tensors take the plain version."""
    kv_len = k.shape[2] if kv_len is None else kv_len
    if q.is_cuda:
        return attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                                kv_len, causal)
    return attention_plain(q, k, v, kv_len, causal)
