"""The whole decoder stack over one decode chunk — kernel K2.

Replaces the TPU kernel ``whisper_medusa_tpu/ops/megastep.py::_kernel``
(launched by ``fused_decoder_layers``): one pallas_call over a (layers,
phases) grid that streams every decoder weight through VMEM while the hidden
state stays resident.

The Hopper version (``csrc/megastep.cu``) is one C entry, ``wm_megastep_step``,
that launches eight kernels per layer on the current stream — a
weight-streaming GEMM for q/k/v (and o, cross q/o, fc1, fc2) with fused bias
/ scale / GELU / residual epilogues, self-attention with the in-place K/V
commit, and cross-attention — so Python makes one ctypes call per decode
step; the entry ends with the final layer norm (``ln_post``) into a second
buffer.  The layer's three norms run inside the q/k/v, cross-q and fc1
GEMMs (their LN mode): those read the residual stream, each CTA takes its K
slice's per-row (mean, M2) in f32, the slices' partials are combined in rank
order across the cluster (:func:`ln_fold_stats` mirrors the arithmetic), and
every X tile is normalized in shared memory before its products.  It is
bound by bytes:
at large-v2 a step reads 1.47 GB of bf16 weights whatever B is, and
B x 246 MB of cross K/V (counted from the shapes).  The GEMM computes
Y^T = W^T X^T on ``wgmma`` (``csrc/wgemm.cuh``, shared with K11): a CTA
streams 64 weight columns of one K slice through a TMA ring (the weight
tile wgmma's 64-row side, the chunk's rows, rounded up to 16, its N side),
the K slices of a column tile are one thread-block cluster whose partials
are added in rank order
through distributed shared memory (:func:`gemm_slices`: from (K, N, jobs)
alone, enough slices for the 132 SMs), and every kernel of the step is
launched with programmatic dependent launch, so a GEMM's first weight
tiles load while the kernels before it finish.  The self- and
cross-attention run K10's thread-block-cluster body
(``csrc/cluster_attn.cuh``, shared with ``csrc/decode_ops.cu``): one
cluster per (head, example) whose CTAs take slices of the keys chosen from
the key count alone (:func:`attention_plan`: 8 x 192 of large-v2's 1500
cross keys, 3 x 160 of a 460-row self slab), ``mma.sync`` scores and PV,
row statistics merged in rank order through distributed shared memory and P
rounded to bf16 once after the whole-row softmax, as the plain version
rounds it.  The cross-attention issues its K/V copies before it waits for
the cross-q projection; the self-attention (the body's mask mode) commits
the chunk's K/V rows, each by the rank whose slice holds its position, and
attends the chunk's own keys from the fresh projection rows.  Every
kernel's per-row arithmetic is independent of B*T, so an example decodes
to the same bits alone or in a batch of eight.

int8 serving (the JAX kernel's ``quant`` / ``kv_quant`` / ``skv_quant``
mode) is a mode of the same entry: the eight streamed weights are int8 with
f32 per-column scales (W8A16: the GEMM converts each int8 weight tile
exactly to bf16 in shared memory and multiplies the f32 sum by the column's
scale before the bias), the cross K/V are int8 with f32 per-(head,
position) scales (scores times the K scale before the softmax,
probabilities times the V scale before the PV product), and the self slabs
are int8 with bf16 per-(position, head) scales: the commit quantizes each
64-lane row with ``sc = max(amax, 1e-30) / 127`` and round-half-even,
attention reads the history rows as ``bf16(q * sc)`` (dequantized as they
are staged, then the bf16 path) and the chunk's own rows as the fresh bf16
K/V.  At large-v2 the step then streams 0.73 GB of
weights and B x 123 MB of cross K/V (counted from the shapes).

Medusa-Block serving (the JAX kernel's block layer, grid layer L) is a
mode of the same entry: after ``ln_post`` the entry copies ``hidden`` into
a third row buffer and runs the block — its own weight table of 21
pointers (and 8 scales at int8), never stacked onto the decoder's — as one
more layer on cache slot L of slabs allocated with L + 1 slots; that buffer
is ``block_hidden`` (no ``ln_post``), and ``pre_norm`` stays the main
stack's output.  The block adds 46 MB of streamed bf16 weights (23 MB
int8) and B x 7.7 MB of cross K/V to a step (counted from the shapes).

The plain version is the ``models/whisper.py::decoder_layer_step`` loop
followed by ``layer_norm`` (and the block's ``decoder_layer_step``).  Both
update the self slabs (and scales) in place and return ``(pre_norm, hidden,
block_hidden)``, ``block_hidden`` None without a block.  Scope of the
kernel (:func:`fits`): bf16 activations, bf16 or int8 weights and caches,
B <= 8, T <= 16 (so B*T <= 128), Dh = 64, d_model and ffn_dim multiples of
256, self and cross key counts whose cluster slices fit a CTA (at most 8 x
384 keys); ``models/whisper.py::decode_step`` sends every other call to the
per-op step (kernels K10 and K11, ops/decode_ops.py).  The chunk mask must
have its diagonal set (every query sees itself), as the decoding loop's
masks do.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod

Params = Dict[str, Any]

MAX_B = 8
MAX_T = 16               # csrc/cluster_attn.cuh CD_MAXT
MAX_ROWS = 128           # csrc/megastep.cu K2_MAX_ROWS
GEMM_TILE = 64           # csrc/wgemm.cuh G_TILE: weight columns a CTA, K chunk
GEMM_CTAS = 132          # csrc/wgemm.cuh G_CTAS: the CTAs a projection aims for
GEMM_MAX_SLICES = 8      # csrc/wgemm.cuh G_MAX_SLICES: one portable cluster
LN_LANES = 8             # csrc/wgemm.cuh G_LN_LANES: lanes summing a row's slice
LN_MAX_CHUNKS = 10       # csrc/wgemm.cuh G_LN_MAXP: the longest K slice a norm takes

launches = 0            # bf16 mode
q_launches = 0          # int8 mode
block_launches = 0      # bf16 block mode (the Medusa-Block layer as layer L)
q_block_launches = 0    # int8 block mode

# Weight order of the C pointer table (csrc/megastep.cu MegastepPtr, from
# P_SELF_LN_S on).
_WEIGHTS = (("self_ln", "scale"), ("self_ln", "bias"), ("self", "q_w"),
            ("self", "q_b"), ("self", "k_w"), ("self", "v_w"), ("self", "v_b"),
            ("self", "o_w"), ("self", "o_b"), ("cross_ln", "scale"),
            ("cross_ln", "bias"), ("cross", "q_w"), ("cross", "q_b"),
            ("cross", "o_w"), ("cross", "o_b"), ("ffn_ln", "scale"),
            ("ffn_ln", "bias"), ("fc1_w",), ("fc1_b",), ("fc2_w",), ("fc2_b",))
# The streamed weights, in the order of their scale slots (P_Q_S ... P_FC2_S).
_QUANT = (("self", "q_w"), ("self", "k_w"), ("self", "v_w"), ("self", "o_w"),
          ("cross", "q_w"), ("cross", "o_w"), ("fc1_w",), ("fc2_w",))

def gemm_slices(k: int, n: int, jobs: int = 1) -> int:
    """K slices of one K2 projection (csrc/wgemm.cuh ``gemm_slices``):
    enough for ``GEMM_CTAS`` CTAs over the (N / 64) x jobs column tiles, at
    most a cluster's 8 and one per 64-wide K chunk.  It reads K, N and the
    job count only, never the rows."""
    chunks, tiles = k // GEMM_TILE, jobs * (n // GEMM_TILE)
    return max(1, min(-(-GEMM_CTAS // tiles), GEMM_MAX_SLICES, chunks))


def gemm_plan(m: int, k: int, n: int, jobs: int = 1):
    """The K2 GEMM's plan at M rows: (slices, the 64-wide K chunks
    [begin, end) of each slice, the 16-row tiles of the rows).  Each
    output's sum — its slices, their chunks and their order — comes from
    (K, N, jobs) alone; only the number of 16-row tiles follows M."""
    slices = gemm_slices(k, n, jobs)
    return slices, _slice_ranges(k // GEMM_TILE, slices), -(-m // 16)


def _slice_ranges(chunks: int, slices: int):
    """The 64-wide chunks [begin, end) of each K slice: fixed contiguous
    ranges (csrc/wgemm.cuh ``gemm_slice_begin``)."""
    base, extra = divmod(chunks, slices)
    begin = [i * base + min(i, extra) for i in range(slices + 1)]
    return list(zip(begin[:-1], begin[1:]))


def ln_slices(d: int, f: int) -> Dict[str, int]:
    """The K slices over which K2's fused layer norms take their statistics:
    those of the GEMM each norm feeds (q/k/v, 3 jobs; cross q; fc1), from
    (K, N, jobs) alone (:func:`gemm_slices`)."""
    return {"self": gemm_slices(d, d, 3), "cross": gemm_slices(d, d, 1),
            "ffn": gemm_slices(d, f, 1)}


def ln_longest_slice(d: int, f: int) -> int:
    """64-wide chunks in the longest K slice of a fused norm (a lane of the
    GEMM's LN mode holds that many 16-byte pieces of a row)."""
    return max(-(-(d // GEMM_TILE) // s) for s in ln_slices(d, f).values())


def ln_fold_stats(x: torch.Tensor, slices: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (mean, rstd) of x (M, K) as the GEMM's LN mode
    (``csrc/wgemm.cuh``) computes them, in f32: K is cut into ``slices``
    contiguous ranges of 64-wide chunks (:func:`gemm_plan`); in each,
    ``LN_LANES`` lanes take every ``LN_LANES``-th 16-byte piece and add it
    (its 8 values as a pairwise tree) to a running sum, the lanes are added
    as a butterfly, and the
    slice's mean is that sum over its count; the same again over the squared
    deviations from the slice's mean gives its M2; then the slices' (mean,
    M2) are combined in rank order with Chan's pairwise formula, and rstd =
    rsqrt(M2 / K + 1e-5).  A row's values depend on the row and ``slices``
    alone, never on M.  (The card fuses multiply-adds where this rounds
    twice: it mirrors the algorithm, not every bit.)"""
    m, k = x.shape
    x = x.float()

    def lanes(v):                       # (M, n) -> (M,): the lanes' sum of a slice
        e = v.reshape(m, -1, 8)         # (M, n / 8, 8): 16-byte pieces of 8 bf16
        per = (((e[..., 0] + e[..., 1]) + (e[..., 2] + e[..., 3]))
               + ((e[..., 4] + e[..., 5]) + (e[..., 6] + e[..., 7])))
        per = per.reshape(m, -1, LN_LANES)    # piece p goes to lane p % LN_LANES
        acc = torch.zeros((m, LN_LANES), dtype=torch.float32)
        for j in range(per.shape[1]):
            acc = acc + per[:, j]
        o = 1
        while o < LN_LANES:             # the butterfly: every lane ends with the total
            acc = acc + acc[:, torch.arange(LN_LANES) ^ o]
            o *= 2
        return acc[:, 0]

    parts = []
    for c0, c1 in _slice_ranges(k // GEMM_TILE, slices):
        xs = x[:, c0 * GEMM_TILE:c1 * GEMM_TILE]
        cnt = torch.tensor(float(xs.shape[1]))
        mean = lanes(xs) / cnt
        dev = xs - mean[:, None]
        parts.append((cnt, mean, lanes(dev * dev)))
    n, mean, m2 = parts[0]
    for nq, mq, m2q in parts[1:]:
        tot = n + nq
        delta = mq - mean
        mean = mean + delta * (nq / tot)
        m2 = m2 + m2q + delta * delta * (n * nq / tot)
        n = tot
    return mean, torch.rsqrt(m2 / torch.tensor(float(k)) + 1e-5)


def attention_plan(s_enc: int, max_len: int):
    """The launch geometry of K2's attention (``csrc/megastep.cu``
    ``attention_plans``): {"cross": (C, SC), "self": (C, SC)}, clusters of C
    CTAs taking SC keys each of the S_enc cross keys and of the max_len rows
    of a self slab (``decode_ops.cluster_split``, K10's rule).  Each reads
    its key count alone, never B, T or the data; a launch is a grid of (C,
    H, B) CTAs."""
    from whisper_medusa_tpu_torch.ops import decode_ops

    return {"cross": decode_ops.cluster_split(s_enc),
            "self": decode_ops.cluster_split(max_len)}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def check_slots(dec_layers: Params, self_k, block) -> int:
    """The number of decoder layers L; the slabs must hold L slots, and one
    more (slot L) for the block."""
    nl = dec_layers["fc1_b"].shape[0]
    want = nl + (block is not None)
    if self_k.shape[0] != want:
        raise ValueError(f"the caches must hold {want} layer slots "
                         f"({nl} layers{' + the block' if block is not None else ''}), "
                         f"got {self_k.shape[0]}")
    return nl


def fits(dec_layers: Params, x: torch.Tensor, self_k: torch.Tensor,
         cross_k: torch.Tensor, num_heads: int) -> bool:
    """Whether K2 takes this decode call — the counterpart of JAX
    ``megastep.available``: B <= 8, T <= 16, heads of 64, d_model and
    ffn_dim multiples of 256, a cross length that is a multiple of 4, self
    and cross key counts whose cluster slices (:func:`attention_plan`) fit
    a CTA, and fused norms whose K slices a lane can hold
    (:func:`ln_longest_slice`).  It reads only shapes, so it routes a call alike on the CPU
    and on the card; ``models/whisper.py::decode_step`` runs the per-op step
    where it is False."""
    from whisper_medusa_tpu_torch.ops import decode_ops

    b, t, d = x.shape
    f = dec_layers["fc1_b"].shape[-1]
    s_len = self_k.shape[2]
    plan = attention_plan(cross_k.shape[-1], s_len)
    return (1 <= b <= MAX_B and 1 <= t <= MAX_T and d == 64 * num_heads
            and d % 256 == 0 and f % 256 == 0 and cross_k.shape[-1] % 4 == 0
            and all(sc <= decode_ops.MAX_SLICE for _, sc in plan.values())
            and ln_longest_slice(d, f) <= LN_MAX_CHUNKS)


def megastep_plain(dec_layers: Params, ln_post: Params, x, self_k, self_v, cross_k,
                   cross_v, offsets, chunk_mask, cross_len: int, num_heads: int,
                   cross_k_s=None, cross_v_s=None, self_s=None, block=None):
    """The decoder_layer_step loop (models/whisper.py), then ln_post, then
    the block (if given) on ln_post's output at slot L."""
    from whisper_medusa_tpu_torch.models import whisper

    return whisper.run_layers(whisper.decoder_layer_step, dec_layers, ln_post, x, self_k,
                              self_v, cross_k, cross_v, offsets, chunk_mask, cross_len,
                              num_heads, cross_k_s=cross_k_s, cross_v_s=cross_v_s,
                              self_s=self_s, block=block)


def _check_int8(name, layer_tree, ln, x):
    """The int8 mode's weights: every streamed weight int8 with f32 scales,
    every other leaf bf16; returns the streamed weights' scales."""
    qw = [_leaf(layer_tree, p) for p in _QUANT]
    if not all(qmm_mod.is_quantized(w) for w in qw):
        raise ValueError(f"megastep kernel: int8 mode takes int8 streamed weights "
                         f"({name})")
    plain = [w for w in (_leaf(layer_tree, p) for p in _WEIGHTS)
             if not qmm_mod.is_quantized(w)]
    cuda_lib.require_cuda("megastep", x, *plain, *ln)
    cuda_lib.require_cuda("megastep", *[w["q"] for w in qw], dtype=torch.int8,
                          device=x.device)
    cuda_lib.require_cuda("megastep", *[w["s"] for w in qw], dtype=torch.float32,
                          device=x.device)
    return [w["s"] for w in qw]


def _values(layer_tree):
    """The C table's weights of one layer tree: bf16 tensors or int8 values."""
    return [w["q"] if qmm_mod.is_quantized(w) else w
            for w in (_leaf(layer_tree, p) for p in _WEIGHTS)]


def megastep_kernel(dec_layers: Params, ln_post: Params, x, self_k, self_v, cross_k,
                    cross_v, offsets, chunk_mask, cross_len: int, num_heads: int,
                    cross_k_s=None, cross_v_s=None, self_s=None, block=None):
    """Launch K2 over all layers (and the block, if given); returns
    (pre_norm, hidden, block_hidden or None), each (B, T, D).  int8 mode
    when the weights are int8 (then the caches, and the block, must be too)."""
    global launches, q_launches, block_launches, q_block_launches
    b, t, d = x.shape
    nl = check_slots(dec_layers, self_k, block)
    _, _, s_len, _ = self_k.shape
    n_slots = self_k.shape[0]
    s_enc = cross_k.shape[4]
    quant = qmm_mod.is_quantized(dec_layers["self"]["q_w"])
    ln = [ln_post["scale"], ln_post["bias"]]
    f = dec_layers["fc1_b"].shape[-1]
    dev = x.device
    extra = [None] * (len(_QUANT) + 3)     # the int8 mode's scale slots, empty
    block_scales = [None] * len(_QUANT)
    if not quant:
        cuda_lib.require_cuda("megastep", x, self_k, self_v, cross_k, cross_v,
                              *_values(dec_layers), *ln,
                              *(_values(block) if block is not None else []))
    else:
        if self_s is None or cross_k_s is None or cross_v_s is None:
            raise ValueError("megastep kernel: int8 mode takes an int8 cross cache "
                             "with scales and int8 self slabs with self_s")
        scales = _check_int8("decoder layers", dec_layers, ln, x)
        if block is not None:
            block_scales = _check_int8("block", block, ln, x)
        cuda_lib.require_cuda("megastep", self_s, device=dev)
        cuda_lib.require_cuda("megastep", self_k, self_v, cross_k, cross_v,
                              dtype=torch.int8, device=dev)
        cuda_lib.require_cuda("megastep", cross_k_s, cross_v_s, dtype=torch.float32,
                              device=dev)
        if (cross_k_s.shape != (n_slots, b, num_heads, s_enc)
                or cross_v_s.shape != cross_k_s.shape
                or self_s.shape != (n_slots, b, s_len, 2 * num_heads)):
            raise ValueError("megastep kernel: scales must be (L, B, H, S_enc), "
                             "self_s (L, B, S, 2H), L counting the block's slot")
        extra = scales + [cross_k_s, cross_v_s, self_s]
    dh = d // num_heads
    if not fits(dec_layers, x, self_k, cross_k, num_heads):
        raise ValueError(
            f"megastep kernel takes B <= {MAX_B}, T <= {MAX_T}, Dh=64, D and F multiples "
            f"of 256, S_enc % 4 == 0 and key counts of at most 8 x 384; got x "
            f"{tuple(x.shape)}, self_k {tuple(self_k.shape)}, cross_k "
            f"{tuple(cross_k.shape)}, F={f}")
    if (self_k.shape != (n_slots, b, s_len, d) or self_v.shape != self_k.shape
            or cross_k.shape != (n_slots, b, num_heads, dh, s_enc)
            or cross_v.shape != (n_slots, b, s_enc, d) or not 1 <= cross_len <= s_enc):
        raise ValueError(
            f"megastep kernel takes KVCache layouts and 1 <= cross_len <= S_enc; got x "
            f"{tuple(x.shape)}, self {tuple(self_k.shape)}, cross_k "
            f"{tuple(cross_k.shape)}, cross_v {tuple(cross_v.shape)}, cross_len {cross_len}")
    if offsets.dtype != torch.int32 or offsets.shape != (b,) or offsets.device != x.device:
        raise ValueError("offsets must be int32 (B,) on the kernel's device")
    if chunk_mask is None:
        chunk_mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))
    mask = chunk_mask.to(device=dev, dtype=torch.uint8).contiguous()
    bf = dict(dtype=torch.bfloat16, device=dev)
    m16 = -(-(b * t) // 16) * 16          # the step's row buffers hold 16-row tiles
    xbuf = torch.zeros((m16, d), **bf)
    xbuf[:b * t] = x.reshape(b * t, d)
    scratch = [torch.zeros((m16, d), **bf) for _ in range(4)]    # q, k, v, attention
    hbuf = torch.zeros((m16, f), **bf)
    hidden = torch.empty((b * t, d), **bf)
    # Block mode: the block's residual stream, 16-row tiles like xbuf.
    bbuf = None if block is None else torch.zeros((m16, d), **bf)
    block_weights = _values(block) if block is not None else [None] * len(_WEIGHTS)
    tensors = [xbuf, *scratch, hbuf, self_k, self_v, cross_k, cross_v,
               offsets, mask, *_values(dec_layers), *ln, hidden, *extra, bbuf,
               *block_weights, *block_scales]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if tt is None else tt.data_ptr() for tt in tensors])
    ints = (ctypes.c_int * 9)(nl, b, t, d, num_heads, f, s_len, s_enc, cross_len)
    cuda_lib.launch("wm_megastep_step", dev, ptrs, ints)
    if block is not None:
        if quant:
            q_block_launches += 1
        else:
            block_launches += 1
    elif quant:
        q_launches += 1
    else:
        launches += 1
    block_hidden = None if bbuf is None else bbuf[:b * t].reshape(b, t, d)
    return xbuf[:b * t].reshape(b, t, d), hidden.reshape(b, t, d), block_hidden


def fused_decoder_layers(dec_layers: Params, ln_post: Params, x: torch.Tensor,
                         self_k: torch.Tensor,
                         self_v: torch.Tensor, cross_k: torch.Tensor,
                         cross_v: torch.Tensor, offsets: torch.Tensor,
                         chunk_mask: Optional[torch.Tensor], cross_len: int,
                         num_heads: int, cross_k_s: Optional[torch.Tensor] = None,
                         cross_v_s: Optional[torch.Tensor] = None,
                         self_s: Optional[torch.Tensor] = None,
                         block: Optional[Params] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """All decoder layers over a (B, T, D) chunk at per-example ``offsets``,
    then ``ln_post`` ({"scale", "bias"}), then the Medusa-Block layer
    ``block`` (one unstacked decoder layer) on ln_post's output at cache
    slot L, if given.

    Writes the chunk's K/V rows into ``self_k``/``self_v`` in place (and
    their scales into ``self_s`` in int8 serving) and returns (pre_norm,
    hidden, block_hidden or None), each (B, T, D).  CUDA tensors launch K2;
    CPU tensors run the plain layer loop."""
    fn = megastep_kernel if x.is_cuda else megastep_plain
    return fn(dec_layers, ln_post, x, self_k, self_v, cross_k, cross_v, offsets,
              chunk_mask, cross_len, num_heads, cross_k_s=cross_k_s,
              cross_v_s=cross_v_s, self_s=self_s, block=block)
