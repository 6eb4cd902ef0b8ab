"""Fused verification: head rows + vocab projection + processors + row
statistics — kernel K4.

Replaces the TPU kernel ``whisper_medusa_tpu/ops/verify.py::_kernel_hidden``
(launched by ``verify_hidden``): grid step 0 builds the (R, D) rows
``src + SiLU(src @ W_k + b_k)`` in VMEM, later steps stream the tied
embedding and fold per-row max / argmax / logsumexp / gathered value across
the sequential grid.

On Hopper the CTAs of a grid run in parallel, so ``csrc/verify.cu`` splits the
work into three launches behind one C entry: (A) the rows, by the skinny
tensor-core GEMM batched over the heads; (B) one CTA per 64-entry vocab tile
that scores all rows on the tensor cores, applies the processors and writes
per-(tile, row) partial statistics; (C) a per-row combine over the tiles
with argmax ties broken to the lowest column.  The logits never reach device
memory.  Stage B is the bound at R = 121: 16 GFLOP of bf16 products plus the
133 MB embedding stream.

Rows are ordered (k, e, n): head-major over flattened (batch, node).  Scope:
chain + greedy, R <= 128; the fused timestamp rules (``ts_cfg``) are not
ported yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from whisper_medusa_tpu_torch.ops import cuda_lib

NEG = -float(np.finfo(np.float32).max) / 2
MAX_R = 128
TILE = 64                # csrc/common.cuh VT

launches = 0


def masks_for(pcfg, device="cpu") -> torch.Tensor:
    """(2, V) int8 [suppress; begin-suppress] masks of a ProcessorConfig."""
    m = np.zeros((2, pcfg.vocab_size), np.int8)
    sup = pcfg.suppress_mask()
    bsup = pcfg.begin_suppress_mask()
    if sup is not None:
        m[0, sup] = 1
    if bsup is not None:
        m[1, bsup] = 1
    return torch.from_numpy(m).to(device)


def process_rows(x: torch.Tensor, pos: torch.Tensor, sup_masks: torch.Tensor, *,
                 begin_index: int, eos_id: int, decay) -> torch.Tensor:
    """The kernel's processors on materialized (R, V) f32 logits
    (whisper_medusa_tpu/ops/verify.py::_process_tile): suppressed columns take
    NEG; the EOS decay is ``x + |x| * (exp(idx * log f) - 1)``."""
    x = torch.where(sup_masks[0].bool()[None], torch.tensor(NEG, device=x.device), x)
    at_begin = (pos == begin_index)[:, None] & sup_masks[1].bool()[None]
    x = torch.where(at_begin, torch.tensor(NEG, device=x.device), x)
    if decay is not None:
        start, factor = decay
        idx = (pos - start).clamp(min=0).float()
        eos = x[:, eos_id]
        pen = eos.abs() * (torch.exp(idx * float(np.log(factor))) - 1.0)
        x = x.clone()
        x[:, eos_id] = torch.where(pos > start, eos + pen, eos)
    return x


def build_rows(hver, hsrc, heads_w, heads_b, identity0: bool) -> torch.Tensor:
    """(R, D) rows ``src + SiLU(src @ W_k + b_k)``, head-major."""
    b, n, d = hver.shape
    src = hsrc.reshape(b * n, d)
    blocks = [hver.reshape(b * n, d)] if identity0 else []
    for k in range(heads_w.shape[0]):
        pre = src.float() @ heads_w[k].float() + heads_b[k].float()
        blocks.append(src + torch.nn.functional.silu(pre).to(src.dtype))
    return torch.cat(blocks, dim=0)


def verify_hidden_plain(hver, hsrc, heads_w, heads_b, embed, pos, gcol, sup_masks,
                        *, identity0: bool, begin_index: int, eos_id: int, decay):
    rows = build_rows(hver, hsrc, heads_w, heads_b, identity0)
    x = rows.float() @ embed.float().T
    x = process_rows(x, pos, sup_masks, begin_index=begin_index, eos_id=eos_id,
                     decay=decay)
    mx, am = x.max(dim=-1)
    lse = torch.logsumexp(x, dim=-1)
    gth = x.gather(1, gcol.long()[:, None])[:, 0]
    return am.to(torch.int32), mx, lse, gth


def verify_hidden_kernel(hver, hsrc, heads_w, heads_b, embed, pos, gcol, sup_masks,
                         *, identity0: bool, begin_index: int, eos_id: int, decay):
    global launches
    b, n, d = hver.shape
    bn = b * n
    nh = heads_w.shape[0]
    v = embed.shape[0]
    r = (nh + int(identity0)) * bn
    cuda_lib.require_cuda("verify_hidden", hver, hsrc, heads_w, heads_b, embed)
    if (bn > 16 or r > MAX_R or d % 256 or hsrc.shape != hver.shape
            or heads_w.shape != (nh, d, d) or heads_b.shape != (nh, d)
            or embed.shape[1] != d):
        raise ValueError(
            f"verify kernel takes B*N <= 16, R <= {MAX_R}, D % 256 == 0; got "
            f"hidden {tuple(hver.shape)}, heads {tuple(heads_w.shape)}, R={r}")
    dev = hver.device
    for name, t, dt in (("pos", pos, torch.int32), ("gcol", gcol, torch.int32),
                        ("sup_masks", sup_masks, torch.int8)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"verify kernel: {name} must be contiguous {dt} on {dev}")
    if pos.shape != (r,) or gcol.shape != (r,) or sup_masks.shape != (2, v):
        raise ValueError("verify kernel: pos/gcol must have R rows, masks (2, V)")
    ntiles = -(-v // TILE)
    src16 = torch.zeros((16, d), dtype=torch.bfloat16, device=dev)
    src16[:bn] = hsrc.reshape(bn, d)
    rows = torch.empty((r, d), dtype=torch.bfloat16, device=dev)
    part_f = torch.empty((3, r, ntiles), dtype=torch.float32, device=dev)
    part_a = torch.empty((r, ntiles), dtype=torch.int32, device=dev)
    mx = torch.empty((r,), dtype=torch.float32, device=dev)
    lse = torch.empty_like(mx)
    am = torch.empty((r,), dtype=torch.int32, device=dev)
    gth = torch.empty_like(mx)
    tensors = [hver, src16, heads_w, heads_b, embed, pos, gcol, sup_masks, rows,
               part_f, part_a, mx, lse, am, gth]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    start, factor = decay if decay is not None else (0, 1.0)
    ints = (ctypes.c_int * 9)(bn, d, v, nh, int(identity0), begin_index, eos_id,
                              int(decay is not None), int(start))
    cuda_lib.launch("wm_verify_hidden", dev, ptrs, ints, float(math.log(factor)))
    launches += 1
    return am, mx, lse, gth


def verify_hidden(hver: torch.Tensor, hsrc: torch.Tensor, heads_w: torch.Tensor,
                  heads_b: torch.Tensor, embed: torch.Tensor, pos: torch.Tensor,
                  gcol: torch.Tensor, sup_masks: torch.Tensor, *, identity0: bool,
                  begin_index: int, eos_id: int, decay, ts_cfg=None,
                  n_verif: int = 0, last: Optional[torch.Tensor] = None,
                  penult: Optional[torch.Tensor] = None,
                  maxts: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(argmax (R,) int32, max, lse, gathered) of the processed logits of the
    rows built from ``hver``/``hsrc`` (B, N, D) and the stacked single-layer
    heads (nh, D, D) / (nh, D).  CUDA tensors launch K4; CPU tensors take the
    plain version."""
    if ts_cfg is not None:
        raise NotImplementedError(
            "fused timestamp rules in verify_hidden are not ported yet "
            "(ROADMAP queue 1: timestamps + longform)")
    fn = verify_hidden_kernel if hver.is_cuda else verify_hidden_plain
    return fn(hver, hsrc, heads_w, heads_b, embed, pos, gcol, sup_masks,
              identity0=identity0, begin_index=begin_index, eos_id=eos_id,
              decay=decay)
