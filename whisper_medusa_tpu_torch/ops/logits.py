"""Decode-time vocab projection ``hidden @ embed.T`` — kernel K3.

Replaces the TPU kernel ``whisper_medusa_tpu/ops/logits.py::_logits_kernel``
(launched by ``_project`` via ``project_logits_stream``), which streams the
tied embedding in 2048-row tiles against query rows resident in VMEM.

The Hopper kernel (``csrc/logits.cu``) is the tied-embedding weight stream
of ``csrc/ntstream.cuh``, shared with K7 (``ops/qmm.py``, the int8
embedding) and tiled by the same plan (``qmm.nt_plan``): a persistent grid
walks the 64-entry vocab tiles, a producer warp keeps a TMA ring of bf16
embedding tiles (in the swizzled layout ``wgmma`` reads) and the matching
x tiles in flight, and a consumer warpgroup runs ``wgmma`` with the tile as
the 64-row side and the rows (rounded up to 16) as the N side, writing the
f32 sums from the accumulators; each is one chain over D in order, so a
row's logits do not depend on M.  The ragged last tile (51865 = 810 * 64 +
25) is zero-filled and masked.  It is bound by the embedding stream:
51865 x 1280 bf16 = 133 MB per call.  A launch takes up to 192 rows; the
wrapper sends more in blocks of 192 (pass B's drafts at B >= 20).

K3's f32 mode (``wm_logits_f32``, ``csrc/logits.cu``) takes an f32 tied
embedding, the JAX package's default dtype: f32 products and sums in FFMA
on the CUDA cores (the tensor cores take f32 only as TF32), on the f32
weight stream of ``csrc/ffma_stream.cuh`` (:func:`f32_stream_plan`): a
persistent grid of two CTAs an SM walks the (64-entry vocab tile, pass of
up to 64 rows) items, a producer warp keeps a TMA ring of 32-float E chunks
and the pass's rows in flight, four consumer warps hold 4 entries x TR rows
a thread.  Each logit is one chain over D in order, so a row's logits do
not depend on M; any M in one launch.  Bound by the 265 MB f32 embedding
stream at the drafts' rows, by the CUDA cores' 67 TFLOP/s past ~40 rows.
"""

from __future__ import annotations

import torch

from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod

MAX_M = qmm_mod.MAX_NT_ROWS

launches = 0
f32_launches = 0         # K3's f32 mode

# csrc/ffma_stream.cuh, the f32 stream of K3 f32 and of K4 / K5's f32 and
# W8A32 modes (ops/verify.py::f32_vocab_plan).
STREAM_TILE = 64         # FS_VT: vocab entries an item
STREAM_KC = 32           # FS_KC: floats of D an f32 ring stage holds
STREAM_QKC = 64          # FS_QKC: int8 values of D an int8 ring stage holds
STREAM_MAX_TR = 8        # FS_MAX_TR: rows a thread, passes of up to 64 rows
STREAM_THREADS = 160     # FS_THREADS: 4 consumer warps + the producer warp
STREAM_CTAS = 2          # FS_CTAS: CTAs an SM
STREAM_RING = 98304      # FS_RING: ring bytes a CTA at most
STREAM_MAX_STAGES = 10   # FS_MAX_STAGES
STREAM_SM_SMEM = 233472  # FS_SM_SMEM: shared memory of an SM (H100)
H100_SMS = 132


def stream_ring(staged: int = 0) -> int:
    """csrc/ffma_stream.cuh ``fs_ring``: the ring bytes a CTA beside
    ``staged`` bytes of its epilogue's, FS_RING or what two CTAs an SM
    leave (1 KB reserved and 1 KB of slack a CTA, the barriers)."""
    return min(STREAM_RING, STREAM_SM_SMEM // STREAM_CTAS - 2048 - staged
               - 16 * STREAM_MAX_STAGES)


def f32_stream_plan(m: int, v: int, d: int = 1280, sms: int = H100_SMS):
    """K3 f32's launch (csrc/ffma_stream.cuh ``fs_launch``) over M rows, V
    vocab entries and D: the passes (ceil(M / 64)) and TR, the rows a thread
    takes in each (passes of 8 TR rows); the (tile, pass) items, a tile's
    passes adjacent; the persistent grid (two CTAs an SM) and the items each
    CTA walks; the ring's stages and the CTA's dynamic shared memory."""
    passes = -(-m // (8 * STREAM_MAX_TR))
    tr = -(-(-(-m // passes)) // 8)
    tiles = -(-v // STREAM_TILE)
    items = tiles * passes
    stage = STREAM_TILE * STREAM_KC * 4 + 8 * tr * STREAM_KC * 4
    stages = min(STREAM_MAX_STAGES, stream_ring() // stage)
    grid = min(items, STREAM_CTAS * sms)
    walk = [list(range(b, items, grid)) for b in range(grid)]
    return dict(passes=passes, tr=tr, rows=8 * tr, tiles=tiles, items=items, grid=grid,
                walk=walk, stage=stage, stages=stages, chunks=d // STREAM_KC,
                smem=1024 + stages * stage + 16 * stages)


def project_plain(x2: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """(M, D) @ (V, D)^T with float32 accumulation -> (M, V) float32."""
    return x2.float() @ embed.float().T


def project_kernel(x2: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the rows of x2 (M, D), in blocks of up to MAX_M rows (a
    row's logits do not depend on the others in its block); f32 operands
    launch K3's f32 mode once over all M rows."""
    global launches, f32_launches
    dt = torch.float32 if x2.dtype == torch.float32 else torch.bfloat16
    cuda_lib.require_cuda("logits", x2, embed, dtype=dt)
    m, d = x2.shape
    v = embed.shape[0]
    if embed.shape[1] != d:
        raise ValueError(f"logits kernel: x {tuple(x2.shape)} and embed "
                         f"{tuple(embed.shape)} differ in D")
    if dt == torch.float32:
        if d % STREAM_KC:
            raise ValueError(f"logits kernel's f32 mode takes D % {STREAM_KC} == 0, got D={d}")
        out = torch.empty((m, v), dtype=torch.float32, device=x2.device)
        cuda_lib.launch("wm_logits_f32", x2.device, x2.data_ptr(), embed.data_ptr(),
                        out.data_ptr(), m, v, d)
        f32_launches += 1
        return out
    blocks = qmm_mod.nt_blocks(m, v, d)       # raises unless D % 64 == 0
    out = torch.empty((m, v), dtype=torch.float32, device=x2.device)
    for r0, rows in blocks:
        cuda_lib.launch("wm_logits", x2.device, x2[r0:].data_ptr(), embed.data_ptr(),
                        out[r0:].data_ptr(), rows, v, d)
        launches += 1
    return out


def project_logits_stream(hidden: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """``hidden @ embed.T``, hidden (..., D), embed (V, D) -> (..., V) float32.

    CUDA tensors launch K3; CPU tensors take the plain version."""
    d = hidden.shape[-1]
    x2 = hidden.reshape(-1, d)
    if x2.is_cuda:
        y = project_kernel(x2.contiguous(), embed)
    else:
        y = project_plain(x2, embed)
    return y.reshape(*hidden.shape[:-1], embed.shape[0])
