"""Full-sequence attention in (B, H, S, Dh) layout — kernel K1 and its
backward, kernel K9.

K1 replaces the TPU kernel ``whisper_medusa_tpu/ops/attention.py::_attention_kernel``
(launched by ``_attention_pallas``), which keeps a whole head's K/V resident in
VMEM and runs a one-pass softmax.  That design does not carry over: 1536 x 64
bf16 K plus V is 384 KB, more than an SM's 227 KB of shared memory.

The Hopper kernel (``csrc/attention.cu``) is a flash-style forward on
``wgmma`` fed by a TMA ring: one CTA per (batch, head, 128-query block), two
consumer warpgroups of 64 query rows and one producer warp that streams
64-key tiles of K and V through a four-stage ring of shared-memory tiles
(``mbarrier``s, 3-D tensor maps over (B*H, S, 64), so rows past S read as
zeros); QK^T with both operands in shared memory, the online softmax in f32
on the accumulator registers, P as bf16 register operands of PV, bf16
output.  It masks ``key < kv_len`` (and causality) and the ragged sequence
edge itself, so the encoder runs its 1500 frames unpadded.  No split over
keys and no atomics: a (batch, head, query block) computes the same bits
whatever B is.  At the encoder's shapes (B=1, H=20, S=1500, Dh=64) it is
bound by tensor-core throughput, not by bytes (11.5 GFLOP against 15 MB of
q/k/v/out per layer).  The TMA maps need 16-byte-aligned tensors: the
wrapper checks and raises.

K9 replaces ``_attention_bwd_kernel`` (launched by ``_attention_bwd_pallas``),
the training backward, as one pass from the forward's statistics: K1 writes
each query row's f32 log-sum-exp when asked (``return_lse=True``); a row pass
computes Dsum = dO . O from the forward's output; one kernel per (batch,
head, 128-key block) recomputes P from the log-sum-exp and runs the five
products on the tensor cores (``mma.sync`` from registers, ``cp.async`` tile
ring), storing each key block's f32 dQ partial (one slot per 128 keys:
(ceil(Skv / 128), B, H, Sq, 64) f32 of scratch, 184 MB at the encoder's
(2, 20, 1500^2)); a cast pass adds the partials in key-block order and
rounds dQ.  dK and dV are written once and dQ is one fixed-order sum, so all
three are bitwise the same from run to run, as the JAX kernel's (no
atomics).

K1's f32 mode (``wm_attention_fwd_f32``, in the same source) serves f32
weights, the JAX package's default dtype: the TPU kernel's function on f32
q, k, v (P not rounded), in FFMA on the CUDA cores, since the tensor cores
take f32 only as TF32.  One CTA of 256 threads per (batch, head, 64-query
block), 64-key f32 tiles of K and V staged in shared memory, a 4 x 4
register tile of scores and of output a thread, the online softmax in f32;
it writes the log-sum-exp when asked, as the bf16 mode does.  No split
over keys: a row's bits do not depend on B.  Bound by the CUDA cores' 67
TFLOP/s at the encoder's shapes.  :class:`AttentionFn` ties the two together for autograd: on CUDA
its forward saves O and the log-sum-exp for the backward; serving never
builds a graph and calls K1 without the log-sum-exp as before.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from whisper_medusa_tpu_torch.ops import cuda_lib

NEG_BIG = -0.7 * torch.finfo(torch.float32).max

BWD_KEYS = 128   # keys of one K9 CTA (csrc/attention.cu BKB): one dQ partial each

launches = 0     # K1 launches (not plain-version calls)
f32_launches = 0   # K1's f32 mode
launches_bwd = collections.Counter()   # K9 launches by (Sq, Skv, causal)


def _scores_mask(q, k, kv_len: int, causal: bool) -> torch.Tensor:
    col = torch.arange(k.shape[2], device=q.device)
    mask = col[None, :] < kv_len
    if causal:
        row = torch.arange(q.shape[2], device=q.device)
        mask = mask & (col[None, :] <= row[:, None])
    return mask


def attention_probs(q, k, kv_len: int, causal: bool) -> torch.Tensor:
    """f32 softmax of the masked f32 scores, (B, H, Sq, Skv): the
    probabilities of :func:`attention_plain` (and of K1), which the
    decoder's capture pass returns (``models/whisper.py::self_attn_probs``)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = torch.where(_scores_mask(q, k, kv_len, causal), s,
                    torch.tensor(NEG_BIG, device=q.device))
    return torch.softmax(s, dim=-1)


def attention_lse_plain(q, k, kv_len: int, causal: bool) -> torch.Tensor:
    """Plain version of K1's log-sum-exp output: (B, H, Sq) f32 log-sum-exp
    of the masked f32 scores (the scores ``_probs`` uses)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = torch.where(_scores_mask(q, k, kv_len, causal), s,
                    torch.tensor(NEG_BIG, device=q.device))
    return torch.logsumexp(s, dim=-1)


def attention_plain(q, k, v, kv_len: int, causal: bool) -> torch.Tensor:
    """Plain PyTorch version: same layout and masks, float32 softmax.

    Mirrors ``_attention_xla``: f32 scores, masked to NEG_BIG, softmax, the
    probabilities cast to the value dtype before PV with f32 accumulation."""
    p = attention_probs(q, k, kv_len, causal)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype)


def attention_bwd_plain(q, k, v, g, kv_len: int, causal: bool):
    """Plain PyTorch version of K9: (dq, dk, dv) for upstream ``g``.

    The arithmetic of ``_attention_bwd_kernel``: f32 scores and P, dP = dO V^T
    and dsum = sum P * dP in f32, dS = P (dP - dsum) cast to the input dtype
    before both of its products, P cast to dO's dtype for dV, every product
    accumulated in f32."""
    p = attention_probs(q, k, kv_len, causal)
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    dsum = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - dsum)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype).float(), g.float()).to(v.dtype)
    return dq, dk, dv


def attention_bwd_lse_plain(q, k, v, o, lse, g, kv_len: int, causal: bool):
    """Plain version of the one-pass K9: (dq, dk, dv) from the forward's
    output ``o`` and log-sum-exp ``lse`` (B, H, Sq) f32.

    P = exp(S - lse) in f32 on the visible pairs (0 elsewhere), Dsum = sum_d
    dO * O in f32 (the identity sum_k P dP = dO . O), and the casts of
    :func:`attention_bwd_plain`: dS rounded to the input dtype before both of
    its products, P to dO's dtype for dV, every product in f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    mask = _scores_mask(q, k, kv_len, causal)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros((), device=q.device))
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    dsum = (g.float() * o.float()).sum(-1, keepdim=True)
    ds = (p * (dp - dsum)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype).float(), g.float()).to(v.dtype)
    return dq, dk, dv


def _check_shapes(name, q, k, v, kv_len):
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    if dh != 64 or k.shape != (b, h, skv, dh) or v.shape != k.shape:
        raise ValueError(f"{name} kernel takes Dh=64 and matching K/V, got "
                         f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not 1 <= kv_len <= skv:
        raise ValueError(f"kv_len {kv_len} outside [1, {skv}]")
    return b, h, sq, skv, dh


def attention_kernel(q, k, v, kv_len: int, causal: bool, return_lse: bool = False):
    """Launch K1.  q: (B, H, Sq, 64), k/v: (B, H, Skv, 64), bf16 (K1) or f32
    (its f32 mode), contiguous.  Returns the output, or (output, log-sum-exp
    (B, H, Sq) f32) with ``return_lse``."""
    global launches, f32_launches
    dt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    cuda_lib.require_cuda("attention", q, k, v, dtype=dt)
    f32 = dt == torch.float32
    b, h, sq, skv, dh = _check_shapes("attention", q, k, v, kv_len)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    cuda_lib.launch("wm_attention_fwd_f32" if f32 else "wm_attention_fwd", q.device,
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), b, h, sq, skv, dh, kv_len,
                    int(causal))
    if f32:
        f32_launches += 1
    else:
        launches += 1
    return (out, lse) if return_lse else out


def attention_bwd_kernel(q, k, v, g, kv_len: int, causal: bool, o=None, lse=None):
    """Launch K9.  q, g: (B, H, Sq, 64), k/v: (B, H, Skv, 64), bf16,
    contiguous; ``o`` (bf16, q's shape) and ``lse`` ((B, H, Sq) f32) are the
    forward's output and log-sum-exp, from K1 with ``return_lse=True`` (run
    here first when either is None).  Returns (dq, dk, dv), bf16."""
    cuda_lib.require_cuda("attention_bwd", q, k, v, g)
    b, h, sq, skv, dh = _check_shapes("attention_bwd", q, k, v, kv_len)
    if g.shape != q.shape:
        raise ValueError(f"attention_bwd: dO {tuple(g.shape)} != q {tuple(q.shape)}")
    if o is None or lse is None:
        o, lse = attention_kernel(q, k, v, kv_len, causal, return_lse=True)
    cuda_lib.require_cuda("attention_bwd", o, device=q.device)
    cuda_lib.require_cuda("attention_bwd", lse, dtype=torch.float32, device=q.device)
    if o.shape != q.shape or lse.shape != (b, h, sq):
        raise ValueError(f"attention_bwd: O {tuple(o.shape)} and LSE {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Scratch: Dsum = dO . O per row, and one f32 dQ partial per 128-key block
    # (csrc/attention.cu BKB), added in key-block order by the cast pass.
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq_part = torch.empty((-(-skv // BWD_KEYS), b, h, sq, dh), dtype=torch.float32,
                          device=q.device)
    cuda_lib.launch("wm_attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), lse.data_ptr(), g.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(),
                    dq_part.data_ptr(), b, h, sq, skv, dh, kv_len, int(causal))
    launches_bwd[(sq, skv, bool(causal))] += 1
    return dq, dk, dv


class AttentionFn(torch.autograd.Function):
    """Differentiable attention: K1 forward and K9 backward on CUDA tensors
    (the forward saves q, k, v, its output and its log-sum-exp), the plain
    versions on CPU tensors (saving q, k and v).  Never saves P."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len: int, causal: bool):
        q, k, v = (t.detach().contiguous() for t in (q, k, v))
        ctx.kv_len, ctx.causal = kv_len, causal
        if q.is_cuda:
            out, lse = attention_kernel(q, k, v, kv_len, causal, return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return attention_plain(q, k, v, kv_len, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, *fwd = ctx.saved_tensors
        g = g.detach().to(q.dtype).contiguous()
        if q.is_cuda:
            o, lse = fwd
            grads = attention_bwd_kernel(q, k, v, g, ctx.kv_len, ctx.causal, o=o, lse=lse)
        else:
            grads = attention_bwd_plain(q, k, v, g, ctx.kv_len, ctx.causal)
        return (*grads, None, None)


def full_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None,
                        causal: bool = False) -> torch.Tensor:
    """Attention over (B, H, S, Dh) tensors, q pre-scaled.

    Under grad mode with an input that requires grad it goes through
    :class:`AttentionFn` (K1 and K9 on CUDA).  Otherwise CUDA tensors launch
    K1 and CPU tensors take the plain version."""
    kv_len = k.shape[2] if kv_len is None else kv_len
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return AttentionFn.apply(q, k, v, kv_len, causal)
    if q.is_cuda:
        return attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                                kv_len, causal)
    return attention_plain(q, k, v, kv_len, causal)
