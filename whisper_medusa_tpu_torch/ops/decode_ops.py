"""Decode-step cross-attention (kernel K10) and FFN (kernel K11) —
counterpart of whisper_medusa_tpu/ops/decode_ops.py.

These are the per-layer math of the per-op decoder step
(``models/whisper.py::decoder_layers_ops``), the path that serves what K2
(ops/megastep.py) does not take: B > 8, T > 16 or widths off its scope.
Cross K is head-major (B, H, Dh, S), cross V head-flat (B, S, D), as in the
JAX package's KVCache; in int8 serving both are int8 with f32 per-(head,
position) scales.

K10 replaces the TPU kernel
``tools/decode_kernels_experiment.py::_cross_kernel`` (launched by
``_cross_pallas``), one program per example with the head loop unrolled.
``csrc/decode_ops.cu::wm_cross_decode`` runs one thread-block cluster per
(example, head): its C CTAs (C = min(8, ceil(S / 192)), from S alone:
:func:`cluster_split`) each take a contiguous slice of the keys, load it
with ``cp.async`` (K as one group, V as a second still in flight while the
scores run), compute their scores and later their partial PV on the tensor
cores (``mma.sync`` m16n8k16: the T <= 16 queries are one m16 tile, bf16
operands, f32 sums; int8 K/V converted exactly to bf16 on the way in),
exchange the row maxima and then the row sums through distributed shared
memory, normalise and round P to bf16 once, and add the C partials in
rank order: the whole-row softmax and the single rounding of P as in the
TPU kernel and the plain version, and each (example, head)'s sums in an
order that depends on S only, so an example's bits do not depend on the
batch.  int8 mode: scores times ``k_s`` before the max, probabilities times
``v_s`` before the bf16 rounding, the denominator unscaled.  Bound by
bytes: at large-v2 a call reads B x 7.68 MB of bf16 cross K/V (half that in
int8).

K10's mask mode, ``csrc/decode_ops.cu::wm_self_decode``, is the per-op
step's self-attention on the card (``models/whisper.py::decoder_layer_ops``):
the same kernel over the head-flat bf16 self slabs (B, max_len, D), with the
offsets and the chunk mask of ``models/whisper.py::make_step_mask`` in
place of ``kv_len``; keys at or past ``offsets[b] + T`` are neither read nor
counted, and the key slices come from ``max_len`` alone.  Its plain version
is ``models/whisper.py::attention`` with ``make_step_mask``
(:func:`self_attention_decode_plain`), which the step runs on the CPU.

K11 replaces ``tools/decode_kernels_experiment.py::_ffn_kernel`` (launched
by ``_ffn_pallas``), whose grid walks F / 512 column blocks sequentially
into an f32 scratch.  ``csrc/decode_ops.cu::wm_ffn_decode`` runs fc1 with
its exact-erf GELU epilogue and then fc2 with its bias, each through the
skinny tensor-core GEMM of ``csrc/common.cuh`` (each weight read once per
128-row block, K split over 16 warps and summed in a fixed order), so every
row's arithmetic is independent of the others and of M.  bf16 weights
only: int8 serving runs the FFN through ``models/whisper.py::ffn`` (K6),
as the JAX package does.  Bound: 26.2 MB of weights per call at large-v2.

The plain versions (``*_plain``) are the math the megastep's plain version
(``models/whisper.py::decoder_layer_step``) runs on every device; the
wrappers launch the kernel on CUDA tensors and take the plain version only
for CPU tensors.
"""

from __future__ import annotations

import torch

from typing import Optional, Tuple

from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import gelu as gelu_mod
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod

NEG_BIG = -0.7 * torch.finfo(torch.float32).max
HEAD_DIM = 64            # csrc/decode_ops.cu CD_DH
MAX_T = 16               # csrc/decode_ops.cu CD_MAXT
FFN_ROWS = 128           # csrc/common.cuh SK_MAX_ROWS: K11's rows per block
CLUSTER_KEYS = 192       # csrc/decode_ops.cu CD_KEYS: keys a CTA takes before C grows
MAX_CLUSTER = 8          # csrc/decode_ops.cu CD_MAXC
MAX_SLICE = 384          # csrc/decode_ops.cu CD_MAXSLICE: keys a CTA holds at most

cross_launches = 0       # K10, bf16 K/V
q_cross_launches = 0     # K10, int8 K/V
self_launches = 0        # K10's mask mode (the per-op step's self-attention)
ffn_launches = 0         # K11 (bf16 weights)


def cross_attention_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
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


def ffn_decode_plain(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """fc1 -> exact GELU (on the f32 sum) -> fc2 with f32 accumulation.
    x: (..., D); the weights may be int8."""
    h = gelu_mod.gelu(qmm_mod.matmul_plain(x, w1) + b1.float())
    y = qmm_mod.matmul_plain(h.to(x.dtype), w2)
    return (y + b2.float()).to(x.dtype)


def cluster_split(s: int) -> Tuple[int, int]:
    """K10's key split of S keys (csrc/decode_ops.cu ``cd_split``): (C, SC),
    C = min(8, ceil(S / 192)) CTAs of a cluster, rank r taking keys
    [r * SC, (r + 1) * SC), SC = ceil(S / C) rounded up to 16."""
    c = min(MAX_CLUSTER, -(-s // CLUSTER_KEYS))
    return c, -(-(-(-s // c)) // 16) * 16


def self_attention_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                offsets: torch.Tensor,
                                chunk_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The function of K10's mask mode: q (B, T, H, Dh) pre-scaled; k, v the
    head-flat self slabs (B, max_len, H * Dh) -> (B, T, H, Dh), exactly
    ``models/whisper.py::attention`` with ``make_step_mask``."""
    from whisper_medusa_tpu_torch.models import whisper

    b, t, h, dh = q.shape
    mask = whisper.make_step_mask(offsets, t, k.shape[1], chunk_mask)
    split = lambda x: x.reshape(b, x.shape[1], h, dh)
    return whisper.attention(q, split(k), split(v), mask)


_CAUSAL_BITS = {}


def chunk_bits(chunk_mask: Optional[torch.Tensor], t: int, device) -> torch.Tensor:
    """(T,) int32 rows of a (T, T) chunk mask as bits (bit j of row i: query
    i sees chunk key j), K10's mask-mode operand; ``None`` is the causal
    mask.  A given mask must have its diagonal set (every query sees
    itself), so that no query row is left without a key."""
    device = torch.device(device)
    if chunk_mask is None:
        key = (t, device)
        if key not in _CAUSAL_BITS:
            _CAUSAL_BITS[key] = torch.tensor([(1 << (i + 1)) - 1 for i in range(t)],
                                             dtype=torch.int32, device=device)
        return _CAUSAL_BITS[key]
    if chunk_mask.shape != (t, t) or not bool(chunk_mask.diagonal().all()):
        raise ValueError(f"K10's mask mode takes a ({t}, {t}) chunk mask with its "
                         "diagonal set")
    weights = 1 << torch.arange(t, device=chunk_mask.device, dtype=torch.int32)
    return (chunk_mask.to(torch.int32) * weights).sum(1).to(device=device,
                                                           dtype=torch.int32)


def cross_attention_decode_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  kv_len: int, k_s=None, v_s=None) -> torch.Tensor:
    """Launch K10: q (B, H, T <= 16, 64) bf16; k (B, H, 64, S) and v (B, S,
    H * 64) bf16, or int8 with f32 (B, H, S) scales ``k_s`` and ``v_s``;
    S % 4 == 0, 1 <= kv_len <= S -> (B, H, T, 64) bf16."""
    global cross_launches, q_cross_launches
    b, h, t, dh = q.shape
    s = k.shape[3]
    quant = k_s is not None
    cuda_lib.require_cuda("cross_attention_decode", q)
    kv_dt = torch.int8 if quant else torch.bfloat16
    cuda_lib.require_cuda("cross_attention_decode", k, v, dtype=kv_dt, device=q.device)
    if quant:
        if v_s is None:
            raise ValueError("cross_attention_decode kernel: int8 K/V take k_s and v_s")
        cuda_lib.require_cuda("cross_attention_decode", k_s, v_s, dtype=torch.float32,
                              device=q.device)
        if k_s.shape != (b, h, s) or v_s.shape != (b, h, s):
            raise ValueError("cross_attention_decode kernel: scales must be (B, H, S)")
    if (dh != HEAD_DIM or not 1 <= t <= MAX_T or k.shape != (b, h, dh, s)
            or v.shape != (b, s, h * dh) or s % 4 or not 1 <= kv_len <= s
            or cluster_split(s)[1] > MAX_SLICE):
        raise ValueError(
            f"cross_attention_decode kernel takes q (B, H, T <= {MAX_T}, {HEAD_DIM}), K "
            f"(B, H, {HEAD_DIM}, S), V (B, S, H*{HEAD_DIM}), S % 4 == 0, "
            f"S <= {MAX_CLUSTER * MAX_SLICE}, 1 <= kv_len <= S; got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, kv_len {kv_len}")
    out = torch.empty_like(q)
    cuda_lib.launch("wm_cross_decode", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    k_s.data_ptr() if quant else None, v_s.data_ptr() if quant else None,
                    out.data_ptr(), b, h, t, s, kv_len)
    if quant:
        q_cross_launches += 1
    else:
        cross_launches += 1
    return out


def self_attention_decode_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 offsets: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Launch K10's mask mode: q (B, T <= 16, H, 64) bf16, pre-scaled; k, v
    (B, max_len, H * 64) bf16 self slabs; ``offsets`` (B,) int32; ``bits``
    (T,) int32 (:func:`chunk_bits`) -> (B, T, H, 64) bf16."""
    global self_launches
    b, t, h, dh = q.shape
    cuda_lib.require_cuda("self_attention_decode", q, k, v)
    cuda_lib.require_cuda("self_attention_decode", offsets, bits, dtype=torch.int32,
                          device=q.device, aligned=False)
    s = k.shape[1]
    if (dh != HEAD_DIM or not 1 <= t <= MAX_T or k.shape != (b, s, h * dh)
            or v.shape != k.shape or s < t or cluster_split(s)[1] > MAX_SLICE
            or offsets.shape != (b,) or bits.shape != (t,)):
        raise ValueError(
            f"self_attention_decode kernel takes q (B, T <= {MAX_T}, H, {HEAD_DIM}), K "
            f"and V (B, T <= S <= {MAX_CLUSTER * MAX_SLICE}, H*{HEAD_DIM}), offsets (B,) "
            f"and bits (T,); got q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, offsets {tuple(offsets.shape)}, bits {tuple(bits.shape)}")
    out = torch.empty_like(q)
    cuda_lib.launch("wm_self_decode", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    offsets.data_ptr(), bits.data_ptr(), out.data_ptr(), b, h, t, s)
    self_launches += 1
    return out


def ffn_decode_kernel(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Launch K11: x (M, D) bf16, w1 (D, F), b1 (F,), w2 (F, D), b2 (D,) bf16,
    D and F multiples of 64 -> (M, D) bf16.  Rows go in blocks of 128, one
    launch each."""
    global ffn_launches
    if qmm_mod.is_quantized(w1) or qmm_mod.is_quantized(w2):
        raise ValueError("ffn_decode kernel takes bf16 weights (int8 serving runs the "
                         "FFN through models/whisper.py::ffn, K6)")
    cuda_lib.require_cuda("ffn_decode", x, w1, b1, w2, b2)
    m, d = x.shape
    f = w1.shape[1]
    if (m < 1 or d % 64 or f % 64 or w1.shape != (d, f) or w2.shape != (f, d)
            or b1.shape != (f,) or b2.shape != (d,)):
        raise ValueError(f"ffn_decode kernel takes D and F multiples of 64; got x "
                         f"{tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    bf = dict(dtype=torch.bfloat16, device=x.device)
    out = torch.empty((m, d), **bf)
    rows = min(m, FFN_ROWS)
    m16 = -(-rows // 16) * 16             # the skinny GEMM reads 16-row tiles
    xbuf = torch.zeros((m16, d), **bf)
    hbuf = torch.empty((m16, f), **bf)
    ybuf = torch.empty((m16, d), **bf)
    for r0 in range(0, m, FFN_ROWS):
        n = min(FFN_ROWS, m - r0)
        xbuf[:n] = x[r0:r0 + n]
        cuda_lib.launch("wm_ffn_decode", x.device, xbuf.data_ptr(), w1.data_ptr(),
                        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), hbuf.data_ptr(),
                        ybuf.data_ptr(), n, d, f)
        ffn_launches += 1
        out[r0:r0 + n] = ybuf[:n]
    return out


def cross_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: int, k_s=None, v_s=None) -> torch.Tensor:
    """Decode-chunk cross-attention over the cross K/V slabs of one layer:
    q (B, H, T, Dh) pre-scaled -> (B, H, T, Dh).  CUDA tensors launch K10;
    CPU tensors take the plain version."""
    if q.is_cuda:
        return cross_attention_decode_kernel(q.contiguous(), k, v, kv_len, k_s, v_s)
    return cross_attention_decode_plain(q, k, v, kv_len, k_s, v_s)


def ffn_decode(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """fc1 -> exact GELU -> fc2 for a decode chunk, x (..., D).  CUDA tensors
    launch K11; CPU tensors take the plain version."""
    if not x.is_cuda:
        return ffn_decode_plain(x, w1, b1, w2, b2)
    d = x.shape[-1]
    y = ffn_decode_kernel(x.reshape(-1, d).contiguous(), w1, b1, w2, b2)
    return y.reshape(x.shape)
