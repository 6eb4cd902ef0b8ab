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
on the CUDA cores (the tensor cores take f32 only as TF32), a CTA per
(64-entry vocab tile, pass of up to 128 rows, :func:`f32_plan`), each
logit one chain over D in order, so a row's logits do not depend on M;
any M in one launch.  Bound by the 265 MB f32 embedding stream at the
drafts' rows, by the CUDA cores' 67 TFLOP/s past ~160 rows.
"""

from __future__ import annotations

import torch

from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod

MAX_M = qmm_mod.MAX_NT_ROWS

launches = 0
f32_launches = 0         # K3's f32 mode
F32_TILE = 64            # csrc/ffma.cuh FF_COLS: vocab entries a CTA
F32_MAX_MT = 8           # csrc/ffma.cuh FF_MAX_MT: 16-row groups a pass (128 rows)


def f32_row_tiles(m: int) -> int:
    """The 16-row groups of an f32 pass over M rows (csrc/ffma.cuh
    ``ff_mt``): 1, 2, 4 or 8, the least that holds min(M, 128) rows."""
    need = -(-min(m, 16 * F32_MAX_MT) // 16)
    return next(mt for mt in (1, 2, 4, 8) if mt >= need)


def f32_plan(m: int, v: int):
    """The f32 NT stream's launch over M rows and V vocab entries (K3's f32
    mode, K4's stage B and K5's f32 mode): the 16-row groups MT of a pass,
    the passes, the 64-entry tiles and the grid (tiles x passes CTAs, a
    tile's passes adjacent).  A row's sums come from D alone."""
    mt = f32_row_tiles(m)
    passes = -(-m // (16 * mt))
    tiles = -(-v // F32_TILE)
    return dict(mt=mt, passes=passes, tiles=tiles, grid=tiles * passes)


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
        if d % 16:
            raise ValueError(f"logits kernel's f32 mode takes D % 16 == 0, got D={d}")
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
