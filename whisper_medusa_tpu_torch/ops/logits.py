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
"""

from __future__ import annotations

import torch

from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod

MAX_M = qmm_mod.MAX_NT_ROWS

launches = 0


def project_plain(x2: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """(M, D) @ (V, D)^T with float32 accumulation -> (M, V) float32."""
    return x2.float() @ embed.float().T


def project_kernel(x2: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the rows of x2 (M, D), in blocks of up to MAX_M rows (a
    row's logits do not depend on the others in its block)."""
    global launches
    cuda_lib.require_cuda("logits", x2, embed)
    m, d = x2.shape
    v = embed.shape[0]
    if embed.shape[1] != d:
        raise ValueError(f"logits kernel: x {tuple(x2.shape)} and embed "
                         f"{tuple(embed.shape)} differ in D")
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
