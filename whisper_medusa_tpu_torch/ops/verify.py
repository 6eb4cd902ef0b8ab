"""Fused verification: vocab projection + processors + row statistics —
kernels K4 (``verify_hidden``, rows built in the kernel) and K5
(``verify_rows``, rows given).

K4 replaces the TPU kernel ``whisper_medusa_tpu/ops/verify.py::_kernel_hidden``
(launched by ``verify_hidden``): grid step 0 builds the (R, D) rows
``src + SiLU(src @ W_k + b_k)`` in VMEM, later steps stream the tied
embedding and fold per-row max / argmax / logsumexp / gathered value across
the sequential grid.  K5 replaces ``whisper_medusa_tpu/ops/verify.py::_kernel``
(launched by ``verify_rows``), the same stream over rows the caller built.

On Hopper the CTAs of a grid run in parallel, so ``csrc/verify.cu`` splits the
work into three launches behind one C entry: (A) the rows, by the heads mode
of the weight-streaming ``wgmma`` GEMM that K2 and K11 run on
(``csrc/wgemm.cuh``: the head is the grid's z and the (nh, D, D) stack's
layer coordinate; a CTA per (64 columns, K slice) of a head, the slices
from D alone (:func:`head_plan`) and added in rank order across a
thread-block cluster, the source rows read through a tensor map over
exactly their M rows); (B) the vocab stream, which scores
the rows against every 64-entry vocab tile on the tensor cores, applies the
processors and writes per-(tile, row) partial statistics; (C) a per-row
combine over the tiles with argmax ties broken to the lowest column.  The
logits never reach device memory.  Stage B is a persistent TMA-fed stream
in the manner of K7: one producer warp keeps a ring of (two E tiles, rows
tile) stages in flight, two consumer warpgroups run ``wgmma``, each with
its E tile as the 64-row side and the shared rows (up to 192 a pass,
zero-filled past R) as the other, and stage each tile's sums in shared
memory for the statistics, so a row's partials do not depend on R or on
the rows beside it.  K5 is stages
B and C alone, for R <= 1024 rows a call (the vanilla loop's B rows and the
two-pass loop's B*N head-0 rows; past 192 rows the stream takes passes of
192); K4's stage B is the same function over its R <= 128 rows.  The bound
is the 133 MB embedding stream (40 us at 3.35 TB/s) for R up to ~250, the
2*R*V*D products beyond.  ``head_rows`` (C entry ``wm_head_rows``) is K4's
stage A alone, so that the two-pass loop's head-0 rows carry the same bits
as K4's: a head row's sum is cut and ordered by D alone, whatever the rows
(M) and the heads of the launch.

int8 serving (the JAX ``quant`` / ``hquant`` modes) is a mode of the same
three entries: an int8 embedding ``{"q": (V, D) int8, "s": (V,) f32}``
streams as raw int8 tiles converted exactly to bf16 in shared memory, and
column v's f32 sum is multiplied by ``s[v]`` before the processors; int8
heads ``{"q": (nh, D, D), "s": (nh, D)}`` go through the GEMM's W8 form
(the raw tile converted exactly to bf16 in shared memory, the column's
scale before the bias).  The
plain versions score ``bf16(rows)`` against an int8 embedding, as the JAX
``qmm_nt`` does.

``identity0`` (Medusa-Block): row block 0 is ``hver`` itself (the hidden
state, scored as the verification rows) and the heads 0..K-1 build row
blocks 1..K from ``hsrc`` (the block layer's output), so R = (K + 1) * B * N.

Rows are ordered (k, e, n): head-major over flattened (batch, node).  Scope:
chain + greedy, K4 at B*N <= 16 and R <= 128 (:func:`hidden_available`;
the decode loop verifies in two passes where it is False, as the JAX
package does); K5 launches take R <= 1024
and ``head_rows`` launches M <= 192, so their wrappers send more rows in
blocks (pass A at B > 16); the fused timestamp rules (``ts_cfg``) are not
ported yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import megastep as megastep_mod
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod

NEG = -float(np.finfo(np.float32).max) / 2
MAX_R = 128              # K4
MAX_ROWS_R = 1024        # rows per K5 launch (csrc/verify.cu VR_MAX_ROWS, the JAX _MAX_R)
MAX_SRC = 16             # K4's source rows B * N (csrc/verify.cu VH_MAX_SRC)
MAX_SRC_ROWS = 192       # rows per head_rows launch (csrc/wgemm.cuh G_MAX_MT * 16)
HEAD_STAGES = 2          # csrc/wgemm.cuh H_STAGES: ring stages of the heads mode
TILE = 64                # csrc/verify.cu VS_VT: vocab entries a tile (partials' columns)
PASS_ROWS = 192          # csrc/verify.cu VS_MAX_MT * 16: rows the vocab stream takes a pass

launches = 0             # K4 (verify_hidden) kernel launches, bf16 embedding
rows_launches = 0        # K5 (verify_rows) kernel launches, bf16 embedding
head_launches = 0        # wm_head_rows launches, bf16 heads
q_launches = 0           # the same three with an int8 embedding / int8 heads
q_rows_launches = 0
q_head_launches = 0
id0_launches = 0         # K4 with identity0 (Medusa-Block), bf16 / int8
q_id0_launches = 0


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


def hidden_available(b: int, n: int, n_heads: int, identity0: bool, v: int, d: int) -> bool:
    """Whether K4 (:func:`verify_hidden`) takes a step of B examples of N
    nodes with ``n_heads`` stacked heads (and the hidden rows themselves
    with ``identity0``): R = (n_heads + identity0) * B * N <= MAX_R rows,
    B * N <= 16 source rows, D % 64 == 0 — the counterpart of the JAX
    package's ``verify.hidden_available``.  It reads only shapes (``v`` is
    kept for the JAX signature); ``decoding/speculative.py`` takes the
    two-pass verification where it is False, on every device."""
    del v
    return (n_heads >= 1 and b * n <= MAX_SRC and (n_heads + int(identity0)) * b * n <= MAX_R
            and d % 64 == 0)


def head_rows_plain(src: torch.Tensor, heads_w, heads_b: torch.Tensor) -> torch.Tensor:
    """(K, M, D) rows ``src + SiLU(src @ W_k + b_k)`` of src (M, D); int8
    heads: ``(src @ bf16(q_k)) * s_k + b_k``."""
    quant = qmm_mod.is_quantized(heads_w)
    wq = heads_w["q"] if quant else heads_w
    out = []
    for k in range(wq.shape[0]):
        pre = src.float() @ wq[k].float()
        if quant:
            pre = pre * heads_w["s"][k].float()
        pre = pre + heads_b[k].float()
        out.append(src + torch.nn.functional.silu(pre).to(src.dtype))
    return torch.stack(out)


def head_plan(m: int, d: int, nh: int = 1):
    """The launches of K4's stage A / ``wm_head_rows`` over M source rows
    of width D through ``nh`` heads (csrc/wgemm.cuh ``wgemm_heads_launch``):
    the row blocks of up to 192 rows, one launch each, and per launch the K
    slices (``head_slices``: ``megastep.gemm_slices(D, D, 1)``), their
    64-wide chunk ranges and the grid (slices, D / 64, nh).  A head row's
    sum — its slices, their chunks and their order — comes from D alone;
    only the blocks, the 16-row tiles and the grid's z follow M and the
    heads."""
    slices, ranges, _ = megastep_mod.gemm_plan(1, d, d)
    blocks = [(r0, min(MAX_SRC_ROWS, m - r0)) for r0 in range(0, m, MAX_SRC_ROWS)]
    return dict(slices=slices, ranges=ranges, blocks=blocks,
                launches=[dict(rows=n, row_tiles=-(-n // 16), grid=(slices, d // 64, nh))
                          for _, n in blocks])


def _operand(name, w, dev, scale_dims):
    """(values, scales-or-None) of a kernel's weight on ``dev``, checked: bf16,
    or int8 with f32 scales over its first ``scale_dims`` dims (heads (nh, D),
    embedding (V,))."""
    if not qmm_mod.is_quantized(w):
        cuda_lib.require_cuda(name, w, device=dev)
        return w, None
    cuda_lib.require_cuda(name, w["q"], dtype=torch.int8, device=dev)
    cuda_lib.require_cuda(name, w["s"], dtype=torch.float32, device=dev)
    if w["s"].shape != w["q"].shape[:scale_dims]:
        raise ValueError(f"{name}: int8 scales must be {tuple(w['q'].shape[:scale_dims])}")
    return w["q"], w["s"]


def head_rows_kernel(src: torch.Tensor, heads_w, heads_b: torch.Tensor) -> torch.Tensor:
    """Launch ``wm_head_rows`` (K4's stage A alone): src (M, D) bf16, heads
    (K, D, D) bf16 or int8 with (K, D) f32 scales, biases (K, D) bf16 ->
    (K, M, D); rows in blocks of up to 192 (:func:`head_plan`), one launch
    each, read in place (a row's arithmetic does not depend on the others)."""
    global head_launches, q_head_launches
    cuda_lib.require_cuda("head_rows", src, heads_b)
    w, ws = _operand("head_rows", heads_w, src.device, 2)
    m, d = src.shape
    nh = w.shape[0]
    if m < 1 or d % 64 or w.shape != (nh, d, d) or heads_b.shape != (nh, d):
        raise ValueError(f"head_rows kernel takes D % 64 == 0; got src "
                         f"{tuple(src.shape)}, heads {tuple(w.shape)}")
    out = torch.empty((nh, m, d), dtype=src.dtype, device=src.device)
    for r0, n in head_plan(m, d, nh)["blocks"]:
        blk = out if n == m else torch.empty((nh, n, d), dtype=src.dtype,
                                             device=src.device)
        cuda_lib.launch("wm_head_rows", src.device, src[r0:].data_ptr(), w.data_ptr(),
                        heads_b.data_ptr(), blk.data_ptr(),
                        None if ws is None else ws.data_ptr(), n, d, nh)
        if n != m:
            out[:, r0:r0 + n] = blk
        if ws is None:
            head_launches += 1
        else:
            q_head_launches += 1
    return out


def head_rows(src: torch.Tensor, heads_w, heads_b: torch.Tensor) -> torch.Tensor:
    """Single-layer Medusa heads on the rows of ``src`` (M, D): (K, M, D).
    CUDA tensors launch K4's stage A alone (the heads mode of the weight-
    streaming GEMM); CPU tensors take the plain version."""
    fn = head_rows_kernel if src.is_cuda else head_rows_plain
    return fn(src, heads_w, heads_b)


def build_rows(hver, hsrc, heads_w, heads_b, identity0: bool) -> torch.Tensor:
    """(R, D) rows ``src + SiLU(src @ W_k + b_k)``, head-major."""
    b, n, d = hver.shape
    rows = head_rows_plain(hsrc.reshape(b * n, d), heads_w, heads_b).reshape(-1, d)
    if identity0:
        rows = torch.cat([hver.reshape(b * n, d), rows], dim=0)
    return rows


def row_logits(rows: torch.Tensor, embed) -> torch.Tensor:
    """Unprocessed f32 logits (R, V) of ``rows`` against a bf16 or int8 tied
    embedding, in plain PyTorch."""
    if qmm_mod.is_quantized(embed):
        return qmm_mod.qmm_nt_plain(rows, embed["q"], embed["s"])
    return rows.float() @ embed.float().T


def _row_stats(rows, embed, pos, gcol, sup_masks, *, begin_index: int, eos_id: int,
               decay):
    """Materialized logits of ``rows``, processed; (argmax, max, lse, gathered)."""
    x = process_rows(row_logits(rows, embed), pos, sup_masks, begin_index=begin_index,
                     eos_id=eos_id, decay=decay)
    mx, am = x.max(dim=-1)
    lse = torch.logsumexp(x, dim=-1)
    gth = x.gather(1, gcol.long()[:, None])[:, 0]
    return am.to(torch.int32), mx, lse, gth


def verify_hidden_plain(hver, hsrc, heads_w, heads_b, embed, pos, gcol, sup_masks,
                        *, identity0: bool, begin_index: int, eos_id: int, decay):
    rows = build_rows(hver, hsrc, heads_w, heads_b, identity0)
    return _row_stats(rows, embed, pos, gcol, sup_masks, begin_index=begin_index,
                      eos_id=eos_id, decay=decay)


def verify_rows_plain(hs, embed, pos, gcol, sup_masks, *, begin_index: int,
                      eos_id: int, decay):
    """K5's plain version: logits materialized, then the same processors and
    statistics."""
    return _row_stats(hs, embed, pos, gcol, sup_masks, begin_index=begin_index,
                      eos_id=eos_id, decay=decay)


def _check_meta(dev, r, v, pos, gcol, sup_masks):
    for name, t, dt in (("pos", pos, torch.int32), ("gcol", gcol, torch.int32),
                        ("sup_masks", sup_masks, torch.int8)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"verify kernel: {name} must be contiguous {dt} on {dev}")
    if pos.shape != (r,) or gcol.shape != (r,) or sup_masks.shape != (2, v):
        raise ValueError("verify kernel: pos/gcol must have R rows, masks (2, V)")


def _stat_outputs(r, ntiles, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((3, r, ntiles), **f32),
            torch.empty((r, ntiles), dtype=torch.int32, device=dev),
            torch.empty((r,), **f32), torch.empty((r,), **f32),
            torch.empty((r,), dtype=torch.int32, device=dev), torch.empty((r,), **f32))


def verify_rows_kernel(hs, embed, pos, gcol, sup_masks, *, begin_index: int,
                       eos_id: int, decay):
    """Launch K5 over rows hs (R, D) bf16, in blocks of up to 1024 rows; the
    embedding (V, D) bf16 or int8."""
    global rows_launches, q_rows_launches
    cuda_lib.require_cuda("verify_rows", hs)
    embed, escale = _operand("verify_rows", embed, hs.device, 1)
    r, d = hs.shape
    v = embed.shape[0]
    if r < 1 or d % TILE or embed.shape[1] != d:
        raise ValueError(f"verify_rows kernel takes D % {TILE} == 0; got rows "
                         f"{tuple(hs.shape)}, embed {tuple(embed.shape)}")
    dev = hs.device
    _check_meta(dev, r, v, pos, gcol, sup_masks)
    start, factor = decay if decay is not None else (0, 1.0)
    outs = []
    for r0 in range(0, r, MAX_ROWS_R):
        n = min(MAX_ROWS_R, r - r0)
        part_f, part_a, mx, lse, am, gth = _stat_outputs(n, -(-v // TILE), dev)
        tensors = [hs[r0:], embed, pos[r0:], gcol[r0:], sup_masks, part_f, part_a, mx,
                   lse, am, gth]
        ptrs = (ctypes.c_void_p * (len(tensors) + 1))(
            *[t.data_ptr() for t in tensors],
            None if escale is None else escale.data_ptr())
        ints = (ctypes.c_int * 7)(n, d, v, begin_index, eos_id, int(decay is not None),
                                  int(start))
        cuda_lib.launch("wm_verify_rows", dev, ptrs, ints, float(math.log(factor)))
        if escale is None:
            rows_launches += 1
        else:
            q_rows_launches += 1
        outs.append((am, mx, lse, gth))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def verify_rows(hs: torch.Tensor, embed, pos: torch.Tensor, gcol: torch.Tensor,
                sup_masks: torch.Tensor, *, begin_index: int, eos_id: int, decay,
                ts_cfg=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(argmax (R,) int32, max, lse, gathered) of the processed logits of the
    rows ``hs`` (R, D) against the tied embedding (V, D), without
    materializing them.  CUDA tensors launch K5; CPU tensors take the plain
    version.  ``embed`` may be int8 (``{"q", "s"}``)."""
    if ts_cfg is not None:
        raise NotImplementedError(
            "fused timestamp rules in verify_rows are not ported yet "
            "(ROADMAP queue 1, item 12: timestamps + longform)")
    fn = verify_rows_kernel if hs.is_cuda else verify_rows_plain
    return fn(hs, embed, pos, gcol, sup_masks, begin_index=begin_index,
              eos_id=eos_id, decay=decay)


def verify_hidden_kernel(hver, hsrc, heads_w, heads_b, embed, pos, gcol, sup_masks,
                         *, identity0: bool, begin_index: int, eos_id: int, decay):
    global launches, q_launches, id0_launches, q_id0_launches
    b, n, d = hver.shape
    bn = b * n
    cuda_lib.require_cuda("verify_hidden", hver, hsrc, heads_b)
    dev = hver.device
    heads_w, hscale = _operand("verify_hidden", heads_w, dev, 2)
    embed, escale = _operand("verify_hidden", embed, dev, 1)
    nh = heads_w.shape[0]
    v = embed.shape[0]
    r = (nh + int(identity0)) * bn
    if (not hidden_available(b, n, nh, identity0, v, d) or hsrc.shape != hver.shape
            or heads_w.shape != (nh, d, d) or heads_b.shape != (nh, d)
            or embed.shape[1] != d):
        raise ValueError(
            f"verify kernel takes B*N <= 16, R <= {MAX_R}, D % 64 == 0; got "
            f"hidden {tuple(hver.shape)}, heads {tuple(heads_w.shape)}, R={r}")
    _check_meta(dev, r, v, pos, gcol, sup_masks)
    rows = torch.empty((r, d), dtype=torch.bfloat16, device=dev)
    part_f, part_a, mx, lse, am, gth = _stat_outputs(r, -(-v // TILE), dev)
    tensors = [hver, hsrc, heads_w, heads_b, embed, pos, gcol, sup_masks, rows,
               part_f, part_a, mx, lse, am, gth]
    scales = [None if a is None else a.data_ptr() for a in (escale, hscale)]
    ptrs = (ctypes.c_void_p * (len(tensors) + 2))(*[t.data_ptr() for t in tensors],
                                                  *scales)
    start, factor = decay if decay is not None else (0, 1.0)
    ints = (ctypes.c_int * 9)(bn, d, v, nh, int(identity0), begin_index, eos_id,
                              int(decay is not None), int(start))
    cuda_lib.launch("wm_verify_hidden", dev, ptrs, ints, float(math.log(factor)))
    quant = escale is not None or hscale is not None
    if identity0:
        if quant:
            q_id0_launches += 1
        else:
            id0_launches += 1
    elif quant:
        q_launches += 1
    else:
        launches += 1
    return am, mx, lse, gth


def verify_hidden(hver: torch.Tensor, hsrc: torch.Tensor, heads_w: torch.Tensor,
                  heads_b: torch.Tensor, embed: torch.Tensor, pos: torch.Tensor,
                  gcol: torch.Tensor, sup_masks: torch.Tensor, *, identity0: bool,
                  begin_index: int, eos_id: int, decay, ts_cfg=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(argmax (R,) int32, max, lse, gathered) of the processed logits of the
    rows built from ``hver``/``hsrc`` (B, N, D) and the stacked single-layer
    heads (nh, D, D) / (nh, D).  CUDA tensors launch K4; CPU tensors take the
    plain version.  The heads and the embedding may be int8."""
    if ts_cfg is not None:
        raise NotImplementedError(
            "fused timestamp rules in verify_hidden are not ported yet "
            "(ROADMAP queue 1, item 12: timestamps + longform)")
    fn = verify_hidden_kernel if hver.is_cuda else verify_hidden_plain
    return fn(hver, hsrc, heads_w, heads_b, embed, pos, gcol, sup_masks,
              identity0=identity0, begin_index=begin_index, eos_id=eos_id,
              decay=decay)
