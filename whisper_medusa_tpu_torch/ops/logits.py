"""Decode-time vocab projection ``hidden @ embed.T`` — kernel K3.

Replaces the TPU kernel ``whisper_medusa_tpu/ops/logits.py::_logits_kernel``
(launched by ``_project`` via ``project_logits_stream``), which streams the
tied embedding in 2048-row tiles against query rows resident in VMEM.

The Hopper kernel (``csrc/logits.cu``) does the same per CTA: one CTA per
64-row vocab tile; the (up to 128) query rows and the tile are staged through
shared memory in 64-wide K slices and multiplied on the tensor cores (WMMA,
bf16 in, f32 out); the ragged last tile (51865 = 810 * 64 + 25) is masked on
load and store.  At M <= 16 rows it is bound by the embedding stream:
51865 x 1280 bf16 = 133 MB per call.  A launch takes up to 192 rows; the
wrapper sends more in blocks of 192 (pass B's drafts at B >= 20).
"""

from __future__ import annotations

import torch

from whisper_medusa_tpu_torch.ops import cuda_lib

MAX_M = 192

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
    if m < 1 or embed.shape[1] != d or d % 64:
        raise ValueError(f"logits kernel takes D % 64 == 0, "
                         f"got x {tuple(x2.shape)} embed {tuple(embed.shape)}")
    out = torch.empty((m, v), dtype=torch.float32, device=x2.device)
    for r0 in range(0, m, MAX_M):
        n = min(MAX_M, m - r0)
        cuda_lib.launch("wm_logits", x2.device, x2[r0:].data_ptr(), embed.data_ptr(),
                        out[r0:].data_ptr(), n, v, d)
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
