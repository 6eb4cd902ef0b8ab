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
192); K4's stage B is the same function over its R <= 1024 rows.  K4's
stage A takes the B*N source rows in blocks of up to 192 (one heads-mode
launch each; past one block each launch writes a staging buffer whose
head blocks are copied to their rows), so a row's bits do not depend on R.  The bound
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
plain versions score the rows in their own dtype against an int8
embedding, as the JAX kernels do (``w.astype(x.dtype)``): bf16 rows as
``qmm_nt`` does, f32 rows in f32.

``identity0`` (Medusa-Block): row block 0 is ``hver`` itself (the hidden
state, scored as the verification rows) and the heads 0..K-1 build row
blocks 1..K from ``hsrc`` (the block layer's output), so R = (K + 1) * B * N.

Rows are ordered (k, e, n): head-major over flattened (batch, node).  Scope:
chain + greedy, K4 at R <= 1024 rows and a head stack of at most 40 MiB
(:func:`hidden_available`, the JAX gate; the decode loop verifies in two
passes where it is False, as the JAX package does); K5 launches take
R <= 1024 and ``head_rows`` launches M <= 192, so their wrappers send more
rows in blocks (pass A at B > 16).

f32 serving (the JAX package's default dtype) is a mode of the same three
wrappers with C entries of their own (``wm_verify_hidden_f32``,
``wm_verify_rows_f32``; head rows through ``wm_gemm_f32``): f32 rows
against an f32 embedding in FFMA on the CUDA cores (the tensor cores take
f32 only as TF32).  Stage B is K3 f32's weight stream
(``csrc/ffma_stream.cuh``) with a scoring epilogue (``verify.cu::
FsScore``, :func:`f32_vocab_plan`): a persistent grid of two CTAs an SM
over (64-entry vocab tile, pass of up to 64 rows) items, a producer warp's
TMA ring of E chunks and the pass's rows, four consumer warps of 4 entries
x TR rows a thread, each sum one chain over D in order; at an item's last
chunk the consumers stage its sums in shared memory and run the bf16
stream's ``tile_stats`` epilogue (processors, timestamp rules, the
straddling tile's split) on them, into the same partials and combine
kernels.  Stage A and ``head_rows`` are ``csrc/ffma_gemm.cuh``'s f32
weight stream over the heads, one launch, K slices from (D, D) alone
(``decode_ops.f32_gemm_plan``), so a head row has the same bits in K4 and
in the two-pass loop, at any M.  W8A32 (the int8 copy of an f32 model)
rides the same f32 entries: an int8 embedding streams as int8 chunks on
the same ring (each value converted exactly to f32 as it is read, ``s[v]``
on column v's sum before the processors) and int8 heads run stage A and
``head_rows`` on the W8A32 GEMM (``wm_gemm_w8a32``: the same weight stream
in its int8-weight mode, one launch, the scale on the sum before the bias,
``decode_ops.f32_gemm_plan`` with ``w8``); counted in ``w8a32_launches``,
``w8a32_rows_launches`` and ``w8a32_head_launches``.

The fused timestamp rules (``ts_cfg``, the JAX kernels' ts mode) are a mode
of stages B and C: rows below ``n_verif`` take the rule masks of
``_process_tile`` from their (last, penult, maxts) history, and the combine
resolves ``_emit``'s force rule — a row whose timestamp columns' log-sum-exp
beats its best text logit takes the timestamp columns' max, log-sum-exp and
argmax, and NEG as the gathered value of a text column.  The timestamp
columns are the range [ts_begin, V), so every 64-entry tile but the one that
straddles ts_begin is all text or all timestamps and its partials already
are one side's; only the straddling tile writes its split (m_ts, s_ts, a_ts,
m_tx) as well.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import decode_ops as decode_ops_mod
from whisper_medusa_tpu_torch.ops import logits as logits_mod
from whisper_medusa_tpu_torch.ops import megastep as megastep_mod
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod

NEG = -float(np.finfo(np.float32).max) / 2
MAX_R = 1024             # K4's rows (csrc/verify.cu VH_MAX_ROWS, the JAX _MAX_R)
MAX_ROWS_R = 1024        # rows per K5 launch (csrc/verify.cu VR_MAX_ROWS, the JAX _MAX_R)
MAX_HEAD_BYTES = 40 * 1024 * 1024   # K4's head stack, n_heads * D^2 * 2 (the JAX gate's)
MAX_SRC_ROWS = 192       # rows per head_rows launch (csrc/wgemm.cuh G_MAX_MT * 16)
HEAD_STAGES = 2          # csrc/wgemm.cuh H_STAGES: ring stages of the heads mode
TILE = 64                # csrc/verify.cu VS_VT: vocab entries a tile (partials' columns)
PASS_ROWS = 192          # csrc/verify.cu VS_MAX_MT * 16: rows the vocab stream takes a pass
STAGED_LDC = 68          # csrc/verify.cu VS_LDC: f32 pitch of a tile's staged sums

launches = 0             # K4 (verify_hidden) kernel launches, bf16 embedding
rows_launches = 0        # K5 (verify_rows) kernel launches, bf16 embedding
head_launches = 0        # wm_head_rows launches, bf16 heads
q_launches = 0           # the same three with an int8 embedding / int8 heads
q_rows_launches = 0
q_head_launches = 0
id0_launches = 0         # K4 with identity0 (Medusa-Block), bf16 / int8
q_id0_launches = 0
ts_launches = 0          # K4 / K5 in the timestamp mode, bf16 / int8 embedding
q_ts_launches = 0
ts_rows_launches = 0
q_ts_rows_launches = 0
f32_launches = 0         # the f32 modes: K4 (base_head and identity0 rows),
f32_rows_launches = 0    # K5, wm_head_rows (the f32 GEMM over the heads),
f32_head_launches = 0    # and K4 / K5 in the timestamp mode
f32_ts_launches = 0
f32_ts_rows_launches = 0
w8a32_launches = 0       # W8A32 (f32 rows, int8 embedding and heads): K4 in every
w8a32_rows_launches = 0  # mode (base_head, identity0, ts), K5 (ts too) and
w8a32_head_launches = 0  # wm_head_rows on int8 heads
w8a32_ts_launches = 0    # those of the W8A32 K4 / K5 launches in the timestamp mode


def f32_vocab_plan(r: int, v: int, d: int = 1280, w8: bool = False,
                   sms: int = logits_mod.H100_SMS):
    """Stage B of K4 / K5's f32 and W8A32 modes (csrc/ffma_stream.cuh
    ``fs_launch`` with verify.cu's ``FsScore``) over R rows, V vocab entries
    and D: K3 f32's passes, TR, items, persistent grid and walk
    (:func:`logits.f32_stream_plan`); the staged sums (8 TR rows at pitch
    VS_LDC); a ring of :func:`logits.stream_ring` bytes beside them (96 KB,
    or what two CTAs an SM leave) whose stage is the E chunk (f32: 64 x 32
    floats; int8: 64 x 64 values) and the pass's 8 TR rows over the same D
    (one 32-float box, two at int8); a CTA's dynamic shared memory (1 KB
    alignment slack, ring, staged sums, barriers).  ``tile_stats``
    scores pass p's rows [8 TR p, 8 TR (p + 1)) below R."""
    LG = logits_mod
    plan = LG.f32_stream_plan(r, v, d, sms)
    tr = plan["tr"]
    if w8:
        stage = LG.STREAM_TILE * LG.STREAM_QKC + 2 * 8 * tr * LG.STREAM_KC * 4
        chunks = d // LG.STREAM_QKC
    else:
        stage, chunks = plan["stage"], plan["chunks"]
    staged = 8 * tr * STAGED_LDC * 4
    stages = min(LG.STREAM_MAX_STAGES, LG.stream_ring(staged) // stage)
    plan.update(stage=stage, stages=stages, chunks=chunks, staged=staged,
                smem=1024 + stages * stage + staged + 16 * stages)
    return plan


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


def ts_cfg_for(pcfg):
    """(timestamp_begin, no_timestamps_id, max_initial_cap) of a
    ProcessorConfig: the ``ts_cfg`` of the fused timestamp rules."""
    return (pcfg.timestamp_begin, pcfg.no_timestamps_id, pcfg.max_initial_timestamp_index)


def ts_rule_mask(pos: torch.Tensor, last: torch.Tensor, penult: torch.Tensor,
                 maxts: torch.Tensor, v: int, ts_cfg, *, begin_index: int, eos_id: int,
                 n_verif: int) -> torch.Tensor:
    """(R, V) bool: the columns the timestamp rules bar for each row
    (``_process_tile``'s rules 1-4): ``<|notimestamps|>``; every timestamp
    after a pair, every text token after a lone timestamp; timestamps under
    the running floor; past the initial cap at ``begin_index``.  Rows at or
    past ``n_verif`` (draft rows) take none."""
    ts_begin, no_ts_id, cap = ts_cfg
    dev = pos.device
    cols = torch.arange(v, device=dev)[None, :]
    is_ts = cols >= ts_begin
    gen_len = pos - begin_index
    last_is_ts = (last >= ts_begin) & (gen_len >= 1)
    penult_is_ts = (gen_len < 2) | (penult >= ts_begin)
    sup_ts = (last_is_ts & penult_is_ts)[:, None]
    sup_text = (last_is_ts & ~penult_is_ts)[:, None]
    floor = torch.where(sup_text[:, 0], maxts, maxts + 1)
    floor = torch.where(maxts > 0, floor, torch.full_like(floor, ts_begin))
    rule = ((cols == no_ts_id) | (sup_ts & is_ts) | (sup_text & (cols < eos_id))
            | (is_ts & (cols < floor[:, None])))
    if cap is not None:
        rule = rule | ((pos == begin_index)[:, None] & (cols > ts_begin + cap))
    verif = torch.arange(pos.shape[0], device=dev)[:, None] < n_verif
    return rule & verif


def process_rows(x: torch.Tensor, pos: torch.Tensor, sup_masks: torch.Tensor, *,
                 begin_index: int, eos_id: int, decay, ts=None) -> torch.Tensor:
    """The kernel's processors on materialized (R, V) f32 logits
    (whisper_medusa_tpu/ops/verify.py::_process_tile): suppressed columns take
    NEG; the EOS decay is ``x + |x| * (exp(idx * log f) - 1)``; ``ts``
    (:func:`_ts_args`) adds the timestamp rules' masks."""
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
    if ts is not None:
        rule = ts_rule_mask(pos, ts["last"], ts["penult"], ts["maxts"], x.shape[1],
                            ts["cfg"], begin_index=begin_index, eos_id=eos_id,
                            n_verif=ts["n_verif"])
        x = torch.where(rule, torch.tensor(NEG, device=x.device), x)
    return x


def _ts_args(ts_cfg, n_verif, last, penult, maxts, r: int, dev):
    """The timestamp mode's operands (None without ``ts_cfg``): the triple,
    ``n_verif`` and the (R,) int32 history.  Rows past ``n_verif`` (draft
    rows) ignore their history; the verification rows must have it."""
    if ts_cfg is None:
        return None
    if not 0 <= n_verif <= r:
        raise ValueError(f"n_verif must be in [0, {r}], got {n_verif}")
    hist = {}
    for name, t in (("last", last), ("penult", penult), ("maxts", maxts)):
        if t is None:
            if n_verif:
                raise ValueError(
                    f"the timestamp rules (ROADMAP queue 1, item 12) read each "
                    f"verification row's last, penult and maxts; {name} is missing")
            t = torch.zeros((r,), dtype=torch.int32, device=dev)
        if t.shape != (r,):
            raise ValueError(f"{name} must have {r} rows, got {tuple(t.shape)}")
        hist[name] = t.to(device=dev, dtype=torch.int32).contiguous()
    return dict(cfg=tuple(ts_cfg), n_verif=int(n_verif), **hist)


def hidden_available(b: int, n: int, n_heads: int, identity0: bool, v: int, d: int) -> bool:
    """Whether K4 (:func:`verify_hidden`) takes a step of B examples of N
    nodes with ``n_heads`` stacked heads (and the hidden rows themselves
    with ``identity0``): the JAX package's ``verify.hidden_available``
    scope (whisper_medusa_tpu/ops/verify.py:375-395) — R = (n_heads +
    identity0) * B * N <= 1024 rows, a head stack of at most 40 MiB counted
    as n_heads * D^2 * 2 bytes, n_heads >= 1 — with the port's own
    D % 64 == 0 (the kernels' 64-wide K chunks) for JAX's D % 128.  It
    reads only shapes (``v`` is kept for the JAX signature);
    ``decoding/speculative.py`` takes the two-pass verification where it is
    False, on every device."""
    del v
    r = (n_heads + int(identity0)) * b * n
    return (n_heads >= 1 and r <= MAX_R and n_heads * d * d * 2 <= MAX_HEAD_BYTES
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


def _operand(name, w, dev, scale_dims, dtype=torch.bfloat16):
    """(values, scales-or-None) of a kernel's weight on ``dev``, checked:
    ``dtype`` (bf16, or f32 in the f32 modes), or int8 with f32 scales over
    its first ``scale_dims`` dims (heads (nh, D), embedding (V,)); int8 on
    f32 rows is the W8A32 mode."""
    if not qmm_mod.is_quantized(w):
        cuda_lib.require_cuda(name, w, dtype=dtype, device=dev)
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
    each, read in place (a row's arithmetic does not depend on the others).
    All-f32 operands take K4's f32 stage A, ``wm_gemm_f32``, in one launch;
    f32 rows through int8 heads its W8A32 form, ``wm_gemm_w8a32``."""
    global head_launches, q_head_launches, f32_head_launches, w8a32_head_launches
    dt = torch.float32 if src.dtype == torch.float32 else torch.bfloat16
    cuda_lib.require_cuda("head_rows", src, heads_b, dtype=dt)
    w, ws = _operand("head_rows", heads_w, src.device, 2, dt)
    m, d = src.shape
    nh = w.shape[0]
    if m < 1 or d % 64 or w.shape != (nh, d, d) or heads_b.shape != (nh, d):
        raise ValueError(f"head_rows kernel takes D % 64 == 0; got src "
                         f"{tuple(src.shape)}, heads {tuple(w.shape)}")
    if dt == torch.float32 and ws is not None:
        out = decode_ops_mod.gemm_w8a32_launch(src, w, ws, heads_b,
                                               decode_ops_mod.EPI_SILU_RESID, resid=src)
        w8a32_head_launches += 1
        return out
    if dt == torch.float32:
        out = decode_ops_mod.gemm_f32_launch(src, w, heads_b, decode_ops_mod.EPI_SILU_RESID,
                                             resid=src)
        f32_head_launches += 1
        return out
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
    """Unprocessed f32 logits (R, V) of ``rows`` against a bf16, f32 or int8
    tied embedding, in plain PyTorch.  An int8 embedding scores the rows in
    their own dtype, as the JAX kernels do (``w.astype(x.dtype)``): bf16
    rows as ``qmm_nt`` does, f32 rows in f32 (the W8A32 mode)."""
    if qmm_mod.is_quantized(embed):
        if rows.dtype == torch.float32:
            return (rows @ embed["q"].float().T) * embed["s"].float()
        return qmm_mod.qmm_nt_plain(rows, embed["q"], embed["s"])
    return rows.float() @ embed.float().T


def _row_stats(rows, embed, pos, gcol, sup_masks, *, begin_index: int, eos_id: int,
               decay, ts=None):
    """Materialized logits of ``rows``, processed; (argmax, max, lse, gathered).
    With ``ts``, the verification rows whose timestamp columns' log-sum-exp
    beats their best text logit are forced (``_emit``): they take the
    timestamp columns' max, log-sum-exp and argmax, and NEG as the gathered
    value of a text column."""
    x = process_rows(row_logits(rows, embed), pos, sup_masks, begin_index=begin_index,
                     eos_id=eos_id, decay=decay, ts=ts)
    mx, am = x.max(dim=-1)
    lse = torch.logsumexp(x, dim=-1)
    gth = x.gather(1, gcol.long()[:, None])[:, 0]
    if ts is not None:
        tb = ts["cfg"][0]
        xts, xtx = x[:, tb:], x[:, :tb]
        r = x.shape[0]
        m_ts, a_ts = xts.max(dim=-1) if xts.shape[1] else (
            torch.full((r,), NEG, device=x.device), torch.zeros(r, dtype=torch.long,
                                                               device=x.device))
        lse_ts = torch.logsumexp(xts, dim=-1)
        m_tx = xtx.max(dim=-1).values
        force = (torch.arange(r, device=x.device) < ts["n_verif"]) & (lse_ts > m_tx)
        mx = torch.where(force, m_ts, mx)
        lse = torch.where(force, lse_ts, lse)
        am = torch.where(force, a_ts + tb, am)
        gth = torch.where(force & (gcol < tb), torch.tensor(NEG, device=x.device), gth)
    return am.to(torch.int32), mx, lse, gth


def verify_hidden_plain(hver, hsrc, heads_w, heads_b, embed, pos, gcol, sup_masks,
                        *, identity0: bool, begin_index: int, eos_id: int, decay,
                        ts=None):
    rows = build_rows(hver, hsrc, heads_w, heads_b, identity0)
    return _row_stats(rows, embed, pos, gcol, sup_masks, begin_index=begin_index,
                      eos_id=eos_id, decay=decay, ts=ts)


def verify_rows_plain(hs, embed, pos, gcol, sup_masks, *, begin_index: int,
                      eos_id: int, decay, ts=None):
    """K5's plain version: logits materialized, then the same processors and
    statistics."""
    return _row_stats(hs, embed, pos, gcol, sup_masks, begin_index=begin_index,
                      eos_id=eos_id, decay=decay, ts=ts)


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


def _ts_tail(ts, r0: int, n: int, dev):
    """The pointer table's timestamp entries (the rows' last / penult /
    maxts from row r0, and the straddling tile's (3, n) f32 + (n,) int32
    split) and the ints (n_verif of these n rows, on, ts_begin, no_ts_id,
    cap or -1); nulls and zeros without ``ts``."""
    if ts is None:
        return [None] * 5, [0] * 5, None
    split = (torch.empty((3, n), dtype=torch.float32, device=dev),
             torch.empty((n,), dtype=torch.int32, device=dev))
    ptrs = [ts[k][r0:].data_ptr() for k in ("last", "penult", "maxts")] + [
        t.data_ptr() for t in split]
    tb, no_ts, cap = ts["cfg"]
    ints = [min(max(ts["n_verif"] - r0, 0), n), 1, tb, no_ts, -1 if cap is None else cap]
    return ptrs, ints, split


def verify_rows_kernel(hs, embed, pos, gcol, sup_masks, *, begin_index: int,
                       eos_id: int, decay, ts=None):
    """Launch K5 over rows hs (R, D) bf16, in blocks of up to 1024 rows; the
    embedding (V, D) bf16 or int8; ``ts`` (:func:`_ts_args`) the timestamp
    mode."""
    global rows_launches, q_rows_launches, ts_rows_launches, q_ts_rows_launches
    global f32_rows_launches, f32_ts_rows_launches, w8a32_rows_launches, w8a32_ts_launches
    dt = torch.float32 if hs.dtype == torch.float32 else torch.bfloat16
    cuda_lib.require_cuda("verify_rows", hs, dtype=dt)
    embed, escale = _operand("verify_rows", embed, hs.device, 1, dt)
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
        ts_ptrs, ts_ints, _split = _ts_tail(ts, r0, n, dev)
        ptrs = (ctypes.c_void_p * (len(tensors) + 6))(
            *[t.data_ptr() for t in tensors],
            None if escale is None else escale.data_ptr(), *ts_ptrs)
        ints = (ctypes.c_int * 12)(n, d, v, begin_index, eos_id, int(decay is not None),
                                   int(start), *ts_ints)
        cuda_lib.launch("wm_verify_rows_f32" if dt == torch.float32 else "wm_verify_rows",
                        dev, ptrs, ints, float(math.log(factor)))
        if dt == torch.float32 and escale is not None:
            w8a32_rows_launches += 1
            w8a32_ts_launches += ts is not None
        elif dt == torch.float32:
            if ts is not None:
                f32_ts_rows_launches += 1
            else:
                f32_rows_launches += 1
        elif ts is not None:
            if escale is None:
                ts_rows_launches += 1
            else:
                q_ts_rows_launches += 1
        elif escale is None:
            rows_launches += 1
        else:
            q_rows_launches += 1
        outs.append((am, mx, lse, gth))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def verify_rows(hs: torch.Tensor, embed, pos: torch.Tensor, gcol: torch.Tensor,
                sup_masks: torch.Tensor, *, begin_index: int, eos_id: int, decay,
                ts_cfg=None, n_verif: int = 0, last: Optional[torch.Tensor] = None,
                penult: Optional[torch.Tensor] = None, maxts: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(argmax (R,) int32, max, lse, gathered) of the processed logits of the
    rows ``hs`` (R, D) against the tied embedding (V, D), without
    materializing them.  CUDA tensors launch K5; CPU tensors take the plain
    version.  ``embed`` may be int8 (``{"q", "s"}``).  ``ts_cfg`` ((ts_begin,
    no_ts_id, cap or None), :func:`ts_cfg_for`) applies the timestamp rules
    to rows < ``n_verif`` from their (R,) ``last`` / ``penult`` / ``maxts``."""
    ts = _ts_args(ts_cfg, n_verif, last, penult, maxts, hs.shape[0], hs.device)
    fn = verify_rows_kernel if hs.is_cuda else verify_rows_plain
    return fn(hs, embed, pos, gcol, sup_masks, begin_index=begin_index,
              eos_id=eos_id, decay=decay, ts=ts)


def verify_hidden_kernel(hver, hsrc, heads_w, heads_b, embed, pos, gcol, sup_masks,
                         *, identity0: bool, begin_index: int, eos_id: int, decay,
                         ts=None):
    global launches, q_launches, id0_launches, q_id0_launches, ts_launches, q_ts_launches
    global f32_launches, f32_ts_launches, w8a32_launches, w8a32_ts_launches
    b, n, d = hver.shape
    bn = b * n
    dt = torch.float32 if hver.dtype == torch.float32 else torch.bfloat16
    cuda_lib.require_cuda("verify_hidden", hver, hsrc, heads_b, dtype=dt)
    dev = hver.device
    heads_w, hscale = _operand("verify_hidden", heads_w, dev, 2, dt)
    embed, escale = _operand("verify_hidden", embed, dev, 1, dt)
    nh = heads_w.shape[0]
    v = embed.shape[0]
    r = (nh + int(identity0)) * bn
    if (not hidden_available(b, n, nh, identity0, v, d) or hsrc.shape != hver.shape
            or heads_w.shape != (nh, d, d) or heads_b.shape != (nh, d)
            or embed.shape[1] != d):
        raise ValueError(
            f"verify kernel takes R <= {MAX_R}, a head stack of <= 40 MiB, D % 64 == 0; got "
            f"hidden {tuple(hver.shape)}, heads {tuple(heads_w.shape)}, R={r}")
    _check_meta(dev, r, v, pos, gcol, sup_masks)
    rows = torch.empty((r, d), dtype=dt, device=dev)
    part_f, part_a, mx, lse, am, gth = _stat_outputs(r, -(-v // TILE), dev)
    tensors = [hver, hsrc, heads_w, heads_b, embed, pos, gcol, sup_masks, rows,
               part_f, part_a, mx, lse, am, gth]
    scales = [None if a is None else a.data_ptr() for a in (escale, hscale)]
    ts_ptrs, ts_ints, _split = _ts_tail(ts, 0, r, dev)
    # One more entry: the bf16 mode's staging rows (nh, 192, D) past one
    # stage-A block of source rows (null within one; the f32 and W8A32
    # modes' stage A is one launch of the f32 GEMM and needs none).
    if dt == torch.float32:
        stage = None
    elif bn > MAX_SRC_ROWS:
        stage = torch.empty((nh, MAX_SRC_ROWS, d), dtype=dt, device=dev)
    else:
        stage = None
    ptrs = (ctypes.c_void_p * (len(tensors) + 8))(
        *[t.data_ptr() for t in tensors], *scales, *ts_ptrs,
        None if stage is None else stage.data_ptr())
    start, factor = decay if decay is not None else (0, 1.0)
    ints = (ctypes.c_int * 14)(bn, d, v, nh, int(identity0), begin_index, eos_id,
                               int(decay is not None), int(start), *ts_ints)
    if dt == torch.float32:
        cuda_lib.launch("wm_verify_hidden_f32", dev, ptrs, ints, float(math.log(factor)))
        if escale is not None or hscale is not None:
            w8a32_launches += 1
            w8a32_ts_launches += ts is not None
        elif ts is not None:
            f32_ts_launches += 1
        else:
            f32_launches += 1
        return am, mx, lse, gth
    cuda_lib.launch("wm_verify_hidden", dev, ptrs, ints, float(math.log(factor)))
    quant = escale is not None or hscale is not None
    if ts is not None:
        # The ts mode's own counts (identity0 and base_head rows alike).
        if quant:
            q_ts_launches += 1
        else:
            ts_launches += 1
    elif identity0:
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
                  begin_index: int, eos_id: int, decay, ts_cfg=None, n_verif: int = 0,
                  last: Optional[torch.Tensor] = None,
                  penult: Optional[torch.Tensor] = None,
                  maxts: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(argmax (R,) int32, max, lse, gathered) of the processed logits of the
    rows built from ``hver``/``hsrc`` (B, N, D) and the stacked single-layer
    heads (nh, D, D) / (nh, D).  CUDA tensors launch K4; CPU tensors take the
    plain version.  The heads and the embedding may be int8.  ``ts_cfg`` and
    its history as in :func:`verify_rows`."""
    r = pos.shape[0]
    ts = _ts_args(ts_cfg, n_verif, last, penult, maxts, r, hver.device)
    fn = verify_hidden_kernel if hver.is_cuda else verify_hidden_plain
    return fn(hver, hsrc, heads_w, heads_b, embed, pos, gcol, sup_masks,
              identity0=identity0, begin_index=begin_index, eos_id=eos_id,
              decay=decay, ts=ts)
