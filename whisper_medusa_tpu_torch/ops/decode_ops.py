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
(example, head) (the body in ``csrc/cluster_attn.cuh``, which K2's
attention shares): its C CTAs (C = min(8, ceil(S / 192)), from S alone:
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
int8).  A launch takes T <= 16 queries (one m16 tile); the wrappers send a
longer chunk (a chain of 16 or more heads) in 16-row blocks, one launch
each on the same K/V (:func:`cross_attention_blocked`,
:func:`self_attention_blocked`).  Beam search folds each example's K beams'
T queries into one block of K * T rows over the example's one cross row
(``models/whisper.py::decode_step``'s ``cross_beam``), so the int8 scales
stay (B, H, S), one per example; 20 rows (K = 5, a 4-token prompt) are two
launches.

K10's mask mode, ``csrc/decode_ops.cu::wm_self_decode``, is the per-op
step's self-attention on the card (``models/whisper.py::decoder_layer_ops``):
the same kernel over the head-flat bf16 self slabs (B, max_len, D), with the
offsets and the chunk mask of ``models/whisper.py::make_step_mask`` in
place of ``kv_len``; keys at or past ``offsets[b] + T`` are neither read nor
counted, and the key slices come from ``max_len`` alone.  Its plain version
is ``models/whisper.py::attention`` with ``make_step_mask``
(:func:`self_attention_decode_plain`), which the step runs on the CPU; a
16-row block of a longer chunk keeps its own rows of chunk bits over all T
columns at the same offsets (:func:`self_attention_block_plain` is one
launch's function).  A row of chunk bits is W = ceil(T / 32) int32 words
(:func:`chunk_bits`), so a chunk may be as wide as the slab: a 39-node
tree is three launches a layer, each reading its rows' two words.

K11 replaces ``tools/decode_kernels_experiment.py::_ffn_kernel`` (launched
by ``_ffn_pallas``), whose grid walks F / 512 column blocks sequentially
into an f32 scratch.  ``csrc/decode_ops.cu::wm_ffn_decode`` runs K2's
weight-streaming ``wgmma`` GEMM (``csrc/wgemm.cuh``, shared with
``csrc/megastep.cu``) twice under programmatic dependent launch: fc1 with
its exact-erf GELU epilogue into an (M, F) bf16 scratch, then fc2 with its
bias, so fc2's weights stream while fc1 finishes.  A launch takes up to 192
rows (one m64nNk16 product of N = the rows rounded up to 16 a step), read
through a TMA tensor map over exactly M rows and zero-filled past them, so
the wrapper copies nothing and B = 16's 176-row chunk reads each weight
once; rows past 192 go in blocks (:func:`ffn_decode_blocked`).  K is cut
into slices and the ring into stages from (K, N) alone (:func:`ffn_plan`),
the slices added in rank order across a thread-block cluster, so every
row's arithmetic is independent of the others and of M.  bf16 weights
only: int8 serving runs the FFN through ``models/whisper.py::ffn`` (K6), as
the JAX package does.  Bound: 26.2 MB of weights per call at large-v2.

The f32 modes serve f32 weights, the JAX package's default dtype (whose
f32 decoder step is its scan, K2 refusing f32): f32 products and sums in
FFMA on the CUDA cores, since the tensor cores take f32 only as TF32.
K10's f32 mode (``wm_cross_decode_f32``, ``wm_self_decode_f32``) cuts the
keys by the same :func:`cluster_split` and, like the bf16 mode, runs one
thread-block cluster per (example, head) (``csrc/ffma_attn.cuh``): each CTA
stages its K and V slice (the cross modes' by TMA, one box each, the mask
mode's rows by ``cp.async``; :func:`f32_attention_plan`), computes FFMA
scores in register tiles over (keys x query rows) for 1, 4, 8 or 16 rows (:func:`f32_rows`,
from T: a T = 1 step computes one row), the row maxima and then the row
sums are merged through distributed shared memory, and each row's owner
rank adds the PV partials in rank order and divides by the sum: one launch
a call, no scratch (P is not rounded, as the TPU kernel's P at f32).  K11's
f32 mode (``wm_ffn_decode_f32``) and the f32 head rows and projections
(``wm_gemm_f32``, :func:`gemm_f32`) run ``csrc/ffma_gemm.cuh``'s f32
weight stream, one launch a product: a CTA per (64 columns, K slice, head,
group of up to 4 passes of up to 32 rows), the slices from (K, N) alone
(:func:`f32_gemm_plan`) one thread-block cluster, added in rank order
through distributed shared memory with the bias and the epilogue in the
same kernel (no scratch), so a row's bits do not depend on M.  The f32
wrappers take any M in one call.

W8A32 (the int8 copy of an f32 model, whose per-op step is JAX's scan at
f32 rows): K10's W8A32 mode (``wm_cross_decode_w8a32``) is the f32 body
(``csrc/ffma_attn.cuh``) on int8 cross K/V staged as int8, each value
converted exactly, a score times its key's scale before the mask and a
probability times its value's scale before the PV product, as
:func:`cross_attention_decode_plain` (counted in ``w8a32_cross_launches``);
:func:`gemm_w8a32_launch` is ``csrc/ffma_gemm.cuh``'s weight stream in its
int8-weight mode (the W8A32 head rows; K2's W8A32 projections and K4
W8A32's stage A run it too): the same plan as the f32 GEMM
(:func:`f32_gemm_plan` with ``w8``), 2 KB int8 W chunks converted exactly
to f32 as they are read, the column's scale on the slices' sum before the
bias, one launch and no scratch.  The step's projections
and FFN stay on K6 (JAX's ``qmm`` rounds the rows to bf16), and its
self-attention reads the bf16-dequantized slab widened to f32 through
K10's f32 mask mode (``models/whisper.py::_attend_ops``).

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
from whisper_medusa_tpu_torch.ops import megastep as megastep_mod
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod

NEG_BIG = -0.7 * torch.finfo(torch.float32).max
HEAD_DIM = 64            # csrc/cluster_attn.cuh CD_DH
MAX_T = 16               # csrc/cluster_attn.cuh CD_MAXT: query rows of one launch
BITS_PER_WORD = 32       # chunk bits of one int32 word of a mask-mode row
FFN_ROWS = 192           # csrc/wgemm.cuh G_MAX_MT * 16: K11's rows per launch
FFN_MAX_STAGES = 3       # csrc/decode_ops.cu FFN_MAX_STAGES
CLUSTER_KEYS = 192       # csrc/cluster_attn.cuh CD_KEYS: keys a CTA takes before C grows
MAX_CLUSTER = 8          # csrc/cluster_attn.cuh CD_MAXC
MAX_SLICE = 384          # csrc/cluster_attn.cuh CD_MAXSLICE: keys a CTA holds at most

cross_launches = 0       # K10, bf16 K/V
q_cross_launches = 0     # K10, int8 K/V
self_launches = 0        # K10's mask mode (the per-op step's self-attention)
self_wide_launches = 0   # those of its launches over a chunk wider than 32 (W >= 2 words)
ffn_launches = 0         # K11 (bf16 weights)
f32_cross_launches = 0   # K10's f32 mode
f32_self_launches = 0    # its f32 mask mode
f32_ffn_launches = 0     # K11's f32 mode
f32_gemm_launches = 0    # the f32 GEMM alone (wm_gemm_f32): the per-op step's projections
w8a32_cross_launches = 0  # K10's W8A32 mode (f32 queries, int8 K/V)
w8a32_gemm_launches = 0  # the W8A32 GEMM alone (wm_gemm_w8a32): the int8 head rows
GEMM32_COLS = 64         # csrc/ffma_gemm.cuh FG_COLS: W columns a CTA
GEMM32_KC = 32           # csrc/ffma_gemm.cuh FG_KC: K a stage holds
GEMM32_KG = 8            # csrc/ffma_gemm.cuh FG_KG: k groups (4 k of a chunk each)
GEMM32_MAX_RQ = 8        # csrc/ffma_gemm.cuh FG_MAX_RQ: 4-row groups a pass (32 rows)
GEMM32_MAX_PG = 4        # csrc/ffma_gemm.cuh FG_MAX_PG: passes a CTA takes
GEMM32_CTAS = 132        # csrc/ffma_gemm.cuh FG_CTAS: CTAs the K slices aim for
GEMM32_WAVE = 264        # csrc/ffma_gemm.cuh FG_WAVE: CTAs the pass groups aim for
GEMM32_MAX_SLICES = 4    # csrc/ffma_gemm.cuh FG_MAX_SLICES: the CTAs of one cluster
GEMM32_RING = 61440      # csrc/ffma_gemm.cuh FG_RING: ring bytes a CTA
GEMM32_PRODUCER_RQ = 4   # csrc/ffma_gemm.cuh FG_PRODUCER_RQ: a producer warp to 16 rows
GEMM32_RP = 68           # csrc/ffma_gemm.cuh FG_RP: f32 pitch of the sums' rows
GEMM32_MAX_JOBS = 3      # csrc/ffma_gemm.cuh FG_MAX_JOBS: K2's q / k / v on one X
ATTN32_THREADS = 256     # csrc/ffma_attn.cuh DA_THREADS: a CTA of the f32 attention
ATTN32_KP = 68           # csrc/ffma_attn.cuh DA_KP: f32 pitch of a mask-mode K row
ATTN32_MAX_SMEM = 232448  # a CTA's shared memory on the H100 (227 KB)
EPI_BIAS, EPI_SILU_RESID = 0, 4   # csrc/common.cuh Epi: the f32 GEMM's epilogues here


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
    """K10's key split of S keys (csrc/cluster_attn.cuh ``cd_split``, K2's
    too): (C, SC), C = min(8, ceil(S / 192)) CTAs of a cluster, rank r
    taking keys [r * SC, (r + 1) * SC), SC = ceil(S / C) rounded up to 16."""
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


def self_attention_block_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               offsets: torch.Tensor, bits: torch.Tensor,
                               t_chunk: int) -> torch.Tensor:
    """The function of one K10 mask-mode launch: q (B, Tb, H, Dh), a block
    of a chunk's query rows, pre-scaled; ``bits`` (Tb, W) those rows' chunk
    bits over the chunk's ``t_chunk`` columns (:func:`chunk_bits`); key j is
    visible to a row iff j < offsets[b], or 0 <= j - offsets[b] < t_chunk
    and bit (j - offsets[b]) % 32 of the row's word (j - offsets[b]) // 32
    is set."""
    from whisper_medusa_tpu_torch.models import whisper

    b, t, h, dh = q.shape
    key = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    rel = key - offsets.to(q.device)[:, None, None, None].long()
    col = rel.clamp(0, t_chunk - 1)
    words = bits.to(device=q.device, dtype=torch.int64) & 0xFFFFFFFF          # (Tb, W)
    word = words[torch.arange(t, device=q.device)[None, None, :, None], col // BITS_PER_WORD]
    bit = (word >> (col % BITS_PER_WORD)) & 1
    mask = (rel < 0) | ((rel < t_chunk) & (bit == 1))
    split = lambda x: x.reshape(b, x.shape[1], h, dh)
    return whisper.attention(q, split(k), split(v), mask)


def row_blocks(t: int):
    """The (first row, rows) of each launch of a T-row chunk: 16-row blocks."""
    return row_blocks_of(t, MAX_T)


def cross_attention_blocked(q: torch.Tensor, block_fn) -> torch.Tensor:
    """Cross-attention of q (B, H, T, Dh) as ``block_fn(q_block)`` over
    16-row blocks of T (the rows are independent), concatenated."""
    t = q.shape[2]
    if t <= MAX_T:
        return block_fn(q)
    return torch.cat([block_fn(q[:, :, r0:r0 + n].contiguous()) for r0, n in row_blocks(t)],
                     dim=2)


def self_attention_blocked(q: torch.Tensor, bits: torch.Tensor, block_fn) -> torch.Tensor:
    """The mask mode over q (B, T, H, Dh) as ``block_fn(q_block, bits_block,
    T)`` over 16-row blocks of T: each block keeps its own rows of chunk bits
    over all T chunk columns, at the same offsets."""
    t = q.shape[1]
    if t <= MAX_T:
        return block_fn(q, bits, t)
    return torch.cat([block_fn(q[:, r0:r0 + n].contiguous(), bits[r0:r0 + n].contiguous(), t)
                      for r0, n in row_blocks(t)], dim=1)


_CAUSAL_BITS = {}


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as the int32 of the same 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def chunk_bits(chunk_mask: Optional[torch.Tensor], t: int, device,
               max_len: Optional[int] = None) -> torch.Tensor:
    """(T, W) int32 rows of a (T, T) chunk mask as bits, W = ceil(T / 32)
    words a row (bit j % 32 of word j // 32 of row i: query i sees chunk
    key j), K10's mask-mode operand; ``None`` is the causal mask.  A given
    mask must have its diagonal set (every query sees itself), so that no
    query row is left without a key.  ``max_len``: the self slab's length;
    a chunk wider than the slab raises ValueError."""
    if max_len is not None and t > max_len:
        raise ValueError(f"K10's mask mode takes a chunk of at most the self slab's "
                         f"{max_len} rows, got T = {t}")
    device = torch.device(device)
    w = -(-t // BITS_PER_WORD)
    if chunk_mask is None:
        key = (t, device)
        if key not in _CAUSAL_BITS:
            _CAUSAL_BITS[key] = chunk_bits(torch.tril(torch.ones((t, t), dtype=torch.bool)),
                                           t, device)
        return _CAUSAL_BITS[key]
    if chunk_mask.shape != (t, t) or not bool(chunk_mask.diagonal().all()):
        raise ValueError(f"K10's mask mode takes a ({t}, {t}) chunk mask with its "
                         "diagonal set")
    cols = torch.nn.functional.pad(chunk_mask.to(torch.int64), (0, w * BITS_PER_WORD - t))
    weights = 1 << torch.arange(BITS_PER_WORD, device=chunk_mask.device, dtype=torch.int64)
    rows = (cols.reshape(t, w, BITS_PER_WORD) * weights).sum(-1)
    return _as_int32_bits(rows).to(device).contiguous()


def f32_rows(t: int) -> int:
    """The query rows one launch of K10's f32 modes computes for T <= 16
    rows (csrc/ffma_attn.cuh ``da_rows``): 1, 4, 8 or 16."""
    return 1 if t <= 1 else 4 if t <= 4 else 8 if t <= 8 else 16


def f32_attention_plan(s: int, t: int, self_mode: bool, int8: bool = False):
    """The launch of K10's f32 modes and of K2 W8A32's attention over S
    keys and T <= 16 query rows (csrc/ffma_attn.cuh ``da_plan``): the
    cluster of C CTAs and each rank's SC keys (:func:`cluster_split`, from S
    alone), the NR query rows (:func:`f32_rows`), the keys of a K / V box
    (the slice, or half of it past 256 keys: one TMA load each), the PV key groups (16 d
    quads x NR / RR row groups x KG = 256 threads, RR = 4 rows a tile, 1 at
    NR = 1), the rows each rank owns in the merge, and the shared memory of
    a CTA (``da_smem``: region A, which holds the K slice, then the scores
    and p, then the PV key groups' partials; V; q transposed; the int8
    modes' scales; the PV rows pushed by the other ranks; their maxima and
    sums; two mbarriers; 128-byte aligned)."""
    c, sc = cluster_split(s)
    nr = f32_rows(t)
    rr = 4 if nr >= 4 else 1
    es = 1 if int8 and not self_mode else 4
    r128 = lambda x: -(-x // 128) * 128
    kb = sc * ATTN32_KP * 4 if self_mode else HEAD_DIM * sc * es
    region_a = max(kb, nr * (sc + 4) * 4, 16 * rr * HEAD_DIM * 4)
    own = -(-nr // c)
    qp = 1 if nr == 1 else nr + 4
    smem = (128 + r128(region_a) + r128(sc * HEAD_DIM * es) + r128(HEAD_DIM * qp * 4)
            + r128(2 * sc * 4) + r128(c * own * HEAD_DIM * 4)
            + r128(2 * MAX_CLUSTER * MAX_T * 4) + 16)
    return dict(c=c, sc=sc, nr=nr, rr=rr, key_box=sc if sc <= 256 else sc // 2,
                key_groups=16 // (nr // rr), own=own, smem=smem, region_a=region_a)


def cross_attention_decode_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  kv_len: int, k_s=None, v_s=None) -> torch.Tensor:
    """Launch K10: q (B, H, T, 64) bf16; k (B, H, 64, S) and v (B, S, H * 64)
    bf16, or int8 with f32 (B, H, S) scales ``k_s`` and ``v_s``; S % 4 == 0,
    1 <= kv_len <= S -> (B, H, T, 64) bf16; all f32 (q, k, v) launch the f32
    mode, f32 q on int8 K/V the W8A32 mode (f32 out).  One launch takes 16
    query rows: past T = 16 the rows go in 16-row blocks, one launch each."""
    b, h, t, dh = q.shape
    s = k.shape[3]
    quant = k_s is not None
    dt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    cuda_lib.require_cuda("cross_attention_decode", q, dtype=dt)
    f32 = dt == torch.float32
    kv_dt = torch.int8 if quant else q.dtype
    cuda_lib.require_cuda("cross_attention_decode", k, v, dtype=kv_dt, device=q.device)
    if quant:
        if v_s is None:
            raise ValueError("cross_attention_decode kernel: int8 K/V take k_s and v_s")
        cuda_lib.require_cuda("cross_attention_decode", k_s, v_s, dtype=torch.float32,
                              device=q.device)
        if k_s.shape != (b, h, s) or v_s.shape != (b, h, s):
            raise ValueError("cross_attention_decode kernel: scales must be (B, H, S)")
    if (dh != HEAD_DIM or t < 1 or k.shape != (b, h, dh, s)
            or v.shape != (b, s, h * dh) or s % 4 or not 1 <= kv_len <= s
            or cluster_split(s)[1] > MAX_SLICE):
        raise ValueError(
            f"cross_attention_decode kernel takes q (B, H, T, {HEAD_DIM}), K "
            f"(B, H, {HEAD_DIM}, S), V (B, S, H*{HEAD_DIM}), S % 4 == 0, "
            f"S <= {MAX_CLUSTER * MAX_SLICE}, 1 <= kv_len <= S; got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, kv_len {kv_len}")

    if f32 and quant:
        def launch_w8a32(qb):
            global w8a32_cross_launches
            out = torch.empty_like(qb)
            cuda_lib.launch("wm_cross_decode_w8a32", q.device, qb.data_ptr(), k.data_ptr(),
                            v.data_ptr(), k_s.data_ptr(), v_s.data_ptr(), out.data_ptr(), b, h,
                            qb.shape[2], s, kv_len)
            w8a32_cross_launches += 1
            return out

        return cross_attention_blocked(q, launch_w8a32)
    if f32:
        def launch_f32(qb):
            global f32_cross_launches
            out = torch.empty_like(qb)
            cuda_lib.launch("wm_cross_decode_f32", q.device, qb.data_ptr(), k.data_ptr(),
                            v.data_ptr(), out.data_ptr(), b, h, qb.shape[2], s, kv_len)
            f32_cross_launches += 1
            return out

        return cross_attention_blocked(q, launch_f32)

    def launch(qb):
        global cross_launches, q_cross_launches
        out = torch.empty_like(qb)
        cuda_lib.launch("wm_cross_decode", q.device, qb.data_ptr(), k.data_ptr(),
                        v.data_ptr(), k_s.data_ptr() if quant else None,
                        v_s.data_ptr() if quant else None, out.data_ptr(), b, h,
                        qb.shape[2], s, kv_len)
        if quant:
            q_cross_launches += 1
        else:
            cross_launches += 1
        return out

    return cross_attention_blocked(q, launch)


def self_attention_decode_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 offsets: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Launch K10's mask mode: q (B, T, H, 64) bf16, pre-scaled; k, v
    (B, max_len >= T, H * 64) bf16 self slabs; ``offsets`` (B,) int32;
    ``bits`` (T, ceil(T / 32)) int32 (:func:`chunk_bits`) -> (B, T, H, 64)
    bf16; f32 q and slabs launch the f32 mode.  Past T = 16 the rows go in
    16-row blocks, one launch each, every block over the whole chunk's T
    columns."""
    b, t, h, dh = q.shape
    dt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    cuda_lib.require_cuda("self_attention_decode", q, k, v, dtype=dt)
    f32 = dt == torch.float32
    cuda_lib.require_cuda("self_attention_decode", offsets, bits, dtype=torch.int32,
                          device=q.device, aligned=False)
    s = k.shape[1]
    if (dh != HEAD_DIM or t < 1 or k.shape != (b, s, h * dh)
            or v.shape != k.shape or s < t or cluster_split(s)[1] > MAX_SLICE
            or offsets.shape != (b,) or bits.shape != (t, -(-t // BITS_PER_WORD))):
        raise ValueError(
            f"self_attention_decode kernel takes q (B, T, H, {HEAD_DIM}), K and V (B, "
            f"T <= S <= {MAX_CLUSTER * MAX_SLICE}, H*{HEAD_DIM}), offsets (B,) and bits "
            f"(T, ceil(T / {BITS_PER_WORD})); got q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, offsets {tuple(offsets.shape)}, bits {tuple(bits.shape)}")

    def launch(qb, bb, t_chunk):
        global self_launches, self_wide_launches, f32_self_launches
        out = torch.empty_like(qb)
        if f32:
            cuda_lib.launch("wm_self_decode_f32", q.device, qb.data_ptr(), k.data_ptr(),
                            v.data_ptr(), offsets.data_ptr(), bb.data_ptr(), out.data_ptr(), b,
                            h, qb.shape[1], s, t_chunk)
            f32_self_launches += 1
            return out
        cuda_lib.launch("wm_self_decode", q.device, qb.data_ptr(), k.data_ptr(),
                        v.data_ptr(), offsets.data_ptr(), bb.data_ptr(), out.data_ptr(), b,
                        h, qb.shape[1], s, t_chunk)
        self_launches += 1
        self_wide_launches += t_chunk > BITS_PER_WORD
        return out

    return self_attention_blocked(q, bits, launch)


def ffn_plan(m: int, d: int, f: int):
    """K11's plan at M rows of width D through (D, F) and (F, D) weights
    (csrc/decode_ops.cu ``wm_ffn_decode``): the row blocks of up to 192
    rows, one call each, and for fc1 and fc2 the GEMM's plan (K slices,
    their 64-wide chunk ranges, ``megastep.gemm_plan``) and ring stages.
    Only the blocks and the 16-row tiles of a block follow M; every sum's
    slices, chunks and order come from the weight's (K, N) alone."""
    def gemm(k, n):
        slices, ranges, _ = megastep_mod.gemm_plan(1, k, n)
        longest = max(e - b for b, e in ranges)
        return dict(slices=slices, ranges=ranges, stages=min(max(longest, 2), FFN_MAX_STAGES))

    return dict(blocks=row_blocks_of(m, FFN_ROWS), fc1=gemm(d, f), fc2=gemm(f, d))


def f32_gemm_plan(m: int, k: int, n: int, nh: int = 1, w8: bool = False):
    """The f32 GEMM's launch (csrc/ffma_gemm.cuh ``fg_plan``) over M rows
    through (nh, K, N) weights, f32 or (``w8``, the W8A32 GEMM) int8: the K
    slices (``fg_slices``: enough for 132 CTAs over the N / 64 column
    tiles, at most 4, one cluster) and their 32-deep chunk ranges
    (wgemm.cuh's ``gemm_slice_begin`` cut, as ``megastep._slice_ranges``),
    from (K, N) alone; the passes of up to 32 rows and the rows R of each
    (``fg_passes``, ``fg_rq``), from M alone; the passes a CTA takes, at
    most 4 and fewer where that brings the launch towards 264 CTAs
    (``fg_pg``; nh counts the outputs: K2's q / k / v are 3), and the
    groups of them (``fg_groups``); the ring's stages (a W chunk of 32 K x
    64 columns, 8 KB in f32, 2 KB in int8, then the pass's X rows), a CTA's
    threads (a producer warp beside the eight product warps up to 16 rows a
    pass, ``fg_threads``), its shared memory and the grid.  Only the slices
    and their chunks enter a row's arithmetic; the passes, groups and
    stages do not."""
    chunks, tiles = k // GEMM32_KC, n // GEMM32_COLS
    slices = max(1, min(-(-GEMM32_CTAS // tiles), GEMM32_MAX_SLICES, chunks))
    passes = -(-m // (4 * GEMM32_MAX_RQ))
    rq = -(-(-(-m // passes)) // 4)
    groups = -(-passes // GEMM32_MAX_PG)
    fill = -(-GEMM32_WAVE // (tiles * slices * nh))
    if groups < fill:
        groups = min(fill, passes)
    pg = -(-passes // groups)
    groups = -(-passes // pg)
    stage = GEMM32_KC * GEMM32_COLS * (1 if w8 else 4) + -(-4 * rq // 8) * 8 * GEMM32_KC * 4
    stages = GEMM32_RING // stage
    threads = 32 * (8 + (rq <= GEMM32_PRODUCER_RQ))
    smem = 1024 + stages * stage + (1 + pg) * 4 * rq * GEMM32_RP * 4 + 16 * stages
    return dict(slices=slices, ranges=megastep_mod._slice_ranges(chunks, slices),
                passes=passes, rows=4 * rq, groups=groups, pg=pg, stage=stage,
                stages=stages, threads=threads, smem=smem, grid=(slices, tiles * groups, nh))


def gemm_f32_launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], epi: int,
                    resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``wm_gemm_f32``: x (M, K) f32, w (nh, K, N) f32, b (nh, N) f32
    or None; resid (M, N) for EPI_SILU_RESID -> (nh, M, N) f32
    ``epi(x @ w + b)``, one launch and no scratch.  The caller counts the
    launch."""
    cuda_lib.require_cuda("gemm_f32", x, w, dtype=torch.float32)
    extra = [t for t in (b, resid) if t is not None]
    if extra:
        cuda_lib.require_cuda("gemm_f32", *extra, dtype=torch.float32, device=x.device)
    m, k = x.shape
    nh, _, n = w.shape
    if (k % GEMM32_KC or n % GEMM32_COLS or w.shape[1] != k
            or (b is not None and b.shape != (nh, n))
            or (resid is not None and resid.shape != (m, n))):
        raise ValueError(f"gemm_f32 takes K % {GEMM32_KC} == 0, N % {GEMM32_COLS} == 0, bias "
                         f"(nh, N) and resid (M, N); got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    out = torch.empty((nh, m, n), dtype=torch.float32, device=x.device)
    cuda_lib.launch("wm_gemm_f32", x.device, x.data_ptr(), w.data_ptr(),
                    None if b is None else b.data_ptr(),
                    None if resid is None else resid.data_ptr(), out.data_ptr(), m, k, n, nh,
                    epi)
    return out


def gemm_w8a32_launch(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                      b: Optional[torch.Tensor], epi: int,
                      resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``wm_gemm_w8a32``: x (M, K) f32 through int8 weights wq (nh,
    K, N) with f32 scales ws (nh, N), b (nh, N) f32 or None; resid (M, N)
    for EPI_SILU_RESID -> (nh, M, N) f32 ``epi(x @ (wq * ws) + b)``, the
    scale on the sum before the bias, one launch and no scratch
    (:func:`f32_gemm_plan` with ``w8``), counted in ``w8a32_gemm_launches``
    (the caller counts it too, as its own function's launch)."""
    global w8a32_gemm_launches
    cuda_lib.require_cuda("gemm_w8a32", x, ws, dtype=torch.float32)
    cuda_lib.require_cuda("gemm_w8a32", wq, dtype=torch.int8, device=x.device)
    extra = [t for t in (b, resid) if t is not None]
    if extra:
        cuda_lib.require_cuda("gemm_w8a32", *extra, dtype=torch.float32, device=x.device)
    m, k = x.shape
    nh, _, n = wq.shape
    if (k % GEMM32_KC or n % GEMM32_COLS or wq.shape[1] != k or ws.shape != (nh, n)
            or (b is not None and b.shape != (nh, n))
            or (resid is not None and resid.shape != (m, n))):
        raise ValueError(f"gemm_w8a32 takes K % {GEMM32_KC} == 0, N % {GEMM32_COLS} == 0, "
                         f"scales and bias (nh, N), resid (M, N); got x {tuple(x.shape)}, w "
                         f"{tuple(wq.shape)}")
    out = torch.empty((nh, m, n), dtype=torch.float32, device=x.device)
    cuda_lib.launch("wm_gemm_w8a32", x.device, x.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                    None if b is None else b.data_ptr(),
                    None if resid is None else resid.data_ptr(), out.data_ptr(), m, k, n, nh,
                    epi)
    w8a32_gemm_launches += 1
    return out


def gemm_f32(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """``x @ w + b`` in f32 through the f32 GEMM: x (..., K), w (K, N), b
    (N,) -> (..., N); a row's bits do not depend on how many rows the call
    has (the per-op step's f32 projections on the card)."""
    global f32_gemm_launches
    k, n = w.shape
    y = gemm_f32_launch(x.reshape(-1, k).contiguous(), w.reshape(1, k, n),
                        None if b is None else b.reshape(1, n), EPI_BIAS)
    f32_gemm_launches += 1
    return y.reshape(*x.shape[:-1], n)


def row_blocks_of(m: int, rows: int):
    """The (first row, rows) of each launch over M rows, ``rows`` a launch."""
    return [(r0, min(rows, m - r0)) for r0 in range(0, m, rows)]


def ffn_decode_blocked(x: torch.Tensor, block_fn) -> torch.Tensor:
    """The FFN of x (M, D) as ``block_fn(x_block, y_block)`` over K11's row
    blocks (:func:`ffn_plan`), each writing its rows of the output in place;
    a block of a contiguous x and of the output is a view, never a copy."""
    out = torch.empty_like(x)
    for r0, n in row_blocks_of(x.shape[0], FFN_ROWS):
        block_fn(x[r0:r0 + n], out[r0:r0 + n])
    return out


def ffn_decode_kernel(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Launch K11: x (M, D) bf16, w1 (D, F), b1 (F,), w2 (F, D), b2 (D,) bf16,
    D and F multiples of 64 -> (M, D) bf16.  Rows go in blocks of up to 192,
    one launch each, straight from x into the output (no staging copies).
    All-f32 operands launch the f32 mode once over all M rows."""
    if qmm_mod.is_quantized(w1) or qmm_mod.is_quantized(w2):
        raise ValueError("ffn_decode kernel takes bf16 or f32 weights (int8 serving runs "
                         "the FFN through models/whisper.py::ffn, K6)")
    dt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    cuda_lib.require_cuda("ffn_decode", x, w1, b1, w2, b2, dtype=dt)
    m, d = x.shape
    f = w1.shape[1]
    if (m < 1 or d % 64 or f % 64 or w1.shape != (d, f) or w2.shape != (f, d)
            or b1.shape != (f,) or b2.shape != (d,)):
        raise ValueError(f"ffn_decode kernel takes D and F multiples of 64; got x "
                         f"{tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if dt == torch.float32:
        return _ffn_decode_f32(x, w1, b1, w2, b2)
    h = torch.empty((min(m, FFN_ROWS), f), dtype=torch.bfloat16, device=x.device)

    def launch(xb, yb):
        global ffn_launches
        cuda_lib.launch("wm_ffn_decode", x.device, xb.data_ptr(), w1.data_ptr(),
                        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), h.data_ptr(),
                        yb.data_ptr(), xb.shape[0], d, f)
        ffn_launches += 1

    return ffn_decode_blocked(x, launch)


def _ffn_decode_f32(x, w1, b1, w2, b2) -> torch.Tensor:
    """K11's f32 mode over all M rows in one call: fc1 + GELU into an (M, F)
    f32 scratch, then fc2 + bias, each one launch of the f32 GEMM."""
    global f32_ffn_launches
    m, d = x.shape
    f = w1.shape[1]
    h = torch.empty((m, f), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    cuda_lib.launch("wm_ffn_decode_f32", x.device, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), h.data_ptr(), y.data_ptr(), m, d, f)
    f32_ffn_launches += 1
    return y


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
