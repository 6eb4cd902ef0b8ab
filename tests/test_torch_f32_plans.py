"""The f32 modes' tile plans, computed from shapes (no card), and the f32
kernels' split arithmetic emulated against the plain versions.

* ``csrc/ffma_gemm.cuh``'s, ``csrc/ffma_attn.cuh``'s and the f32 vocab
  stream's constants are the wrappers' (parsed from the sources), and the
  partials scratches, combine kernels and first-cut FFMA tile they replaced
  are gone;
* the f32 GEMM (K11's f32 mode, the f32 head rows, the per-op step's f32
  projections; ``csrc/ffma_gemm.cuh``): K slices from (K, N) alone, one
  cluster of at most 4 that covers K's 32-deep chunks once; passes of up to
  32 rows and groups of up to 4 passes that cover M once; a CTA's shared
  memory leaves room for two an SM; its order (eight k groups, each a chain
  over its k of the slice's chunks, added in a fixed tree, the slices in
  rank order) emulated against the plain version, the same bits for a row
  at any M; its int8-weight mode (the W8A32 GEMM: K2 W8A32, the int8 head
  rows, K4 W8A32's stage A) on the same slices, emulated against
  ``megastep.mm_w8`` (the column's scale on the sum, then the bias);
* the f32 vocab stream (K4's stage B and K5 in f32 and W8A32: K3 f32's
  stream with a scoring epilogue, ``verify.f32_vocab_plan``): its
  persistent walk takes every (vocab tile, pass) item once, its passes and
  tile_stats' pass rows every row once, in order, and its ring, staged sums
  and barriers leave room for two CTAs an SM at every TR;
* K10's f32 modes (``csrc/ffma_attn.cuh``, one cluster per (head,
  example)): cluster_split's slices, the row maxima merged, p = exp(s -
  max), each rank's row sums and PV partials added in rank order, then
  divided by the sum, against the plain cross- and self-attention at 1e-5
  (T = 11 and T = 1, which computes one row); in the mask mode keys at or
  past off + TC are not read; the plan's shared memory fits a CTA;
* K3's f32 stream (``csrc/ffma_stream.cuh``): its constants are the
  wrapper's, its persistent walk takes every (vocab tile, pass) item once
  and its passes every row once, and its ring fits an SM at two CTAs;
* K9's f32 mode: dQ as one partial per 128-key block (dS K over the block's
  keys), the partials of the blocks that reach a row added in key-block
  order, against attention_bwd_lse_plain at 1e-6;
* K1's f32 mode: the online softmax over 64-key tiles in the log2 domain
  (p = 2^(s log2 e - m log2 e), alpha = 1 where a row's max did not move),
  its output and log-sum-exp against attention_plain / attention_lse_plain
  and the JAX package's XLA f32 attention at 1e-5.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
import whisper_medusa_tpu.ops.attention as jattn
from whisper_medusa_tpu_torch.ops import attention as A
from whisper_medusa_tpu_torch.ops import decode_ops as DO
from whisper_medusa_tpu_torch.ops import logits as LG
from whisper_medusa_tpu_torch.ops import verify as VF

CSRC = os.path.join(os.path.dirname(DO.__file__), "..", "csrc")


def _const(name, source):
    text = open(os.path.join(CSRC, source)).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_constants_are_the_sources():
    # K4 / K5's f32 and W8A32 stage B: K3 f32's stream (ffma_stream.cuh)
    # with verify.cu's scoring epilogue; the first-cut FFMA tile is gone.
    for name, value in (("FS_QKC", LG.STREAM_QKC), ("FS_SM_SMEM", LG.STREAM_SM_SMEM)):
        assert _const(name, "ffma_stream.cuh") == value, name
    verify_cu = open(os.path.join(CSRC, "verify.cu")).read()
    assert "constexpr int VS_LDC = VS_VT + 4;" in verify_cu and VF.STAGED_LDC == VF.TILE + 4
    assert _const("VS_VT", "verify.cu") == LG.STREAM_TILE == VF.TILE
    assert '#include "ffma_stream.cuh"' in verify_cu and "FsScore" in verify_cu
    assert verify_cu.count("fs_launch<Q>(") == 1
    assert not os.path.exists(os.path.join(CSRC, "ffma.cuh"))
    for name, value in (("FG_COLS", DO.GEMM32_COLS), ("FG_KC", DO.GEMM32_KC),
                        ("FG_KG", DO.GEMM32_KG), ("FG_MAX_RQ", DO.GEMM32_MAX_RQ),
                        ("FG_MAX_PG", DO.GEMM32_MAX_PG), ("FG_CTAS", DO.GEMM32_CTAS),
                        ("FG_WAVE", DO.GEMM32_WAVE), ("FG_MAX_SLICES", DO.GEMM32_MAX_SLICES),
                        ("FG_RING", DO.GEMM32_RING), ("FG_PRODUCER_RQ", DO.GEMM32_PRODUCER_RQ),
                        ("FG_MAX_JOBS", DO.GEMM32_MAX_JOBS)):
        assert _const(name, "ffma_gemm.cuh") == value, name
    gemm = open(os.path.join(CSRC, "ffma_gemm.cuh")).read()
    assert "constexpr int FG_RP = FG_COLS + 4;" in gemm and DO.GEMM32_RP == DO.GEMM32_COLS + 4
    assert DO.GEMM32_KG * 4 == DO.GEMM32_KC                     # 4 k of a chunk a group
    assert _const("DA_THREADS", "ffma_attn.cuh") == DO.ATTN32_THREADS
    attn = open(os.path.join(CSRC, "ffma_attn.cuh")).read()
    assert "constexpr int DA_KP = CD_DH + 4;" in attn and DO.ATTN32_KP == DO.HEAD_DIM + 4
    # The f32 GEMM and the W8A32 GEMM are one launch of ffma_gemm.cuh (no
    # partials scratch, no combine kernel), and so is K10's f32 attention:
    # every f32 and W8A32 product of K11, the head rows, K4's stage A and
    # the per-op step is fg_launch (K2 W8A32 launches on its maps).
    sources = {name: open(os.path.join(CSRC, name)).read() for name in os.listdir(CSRC)}
    for gone in ("ff_gemm(", "ff_gemm8(", "ffma_gemm8_kernel", "ffma_combine_kernel",
                 "ffma_combine8_kernel", "decode_combine_f32_kernel", "DF_ROW", "A_APART",
                 "A_PART", "ffma.cuh", "ffma_tile", "vocab_stream_f32_kernel", "vs_f32_launch"):
        assert not any(gone in text for text in sources.values()), gone
    for source, calls in (("decode_ops.cu", 4), ("verify.cu", 1), ("megastep.cu", 0)):
        assert sources[source].count("fg_launch(") == calls, source
    assert sources["megastep.cu"].count("gemm32(c, ") == 6            # six GEMMs a layer
    assert sources["megastep.cu"].count("da_launch<") == 2            # two attentions
    common = open(os.path.join(CSRC, "common.cuh")).read()
    for name in ("EPI_BIAS", "EPI_SILU_RESID"):
        assert int(re.search(rf"{name} = (\d+),", common).group(1)) == getattr(DO, name)


@pytest.mark.parametrize("k,n,slices", [
    (1280, 5120, 2), (5120, 1280, 4), (1280, 1280, 4), (384, 1536, 4), (1536, 384, 4),
    (384, 384, 4)], ids=["fc1", "fc2", "proj", "tiny-fc1", "tiny-fc2", "tiny-heads"])
def test_gemm_slices_come_from_k_and_n(k, n, slices):
    plans = [DO.f32_gemm_plan(m, k, n, nh, w8) for m in (1, 11, 88, 121, 176, 300)
             for nh in (1, 3, 10, 11) for w8 in (False, True)]
    assert {(p["slices"], tuple(p["ranges"])) for p in plans} == {
        (slices, tuple(plans[0]["ranges"]))}
    tiles, chunks = n // DO.GEMM32_COLS, k // DO.GEMM32_KC
    assert slices == max(1, min(-(-DO.GEMM32_CTAS // tiles), DO.GEMM32_MAX_SLICES, chunks))
    ranges = plans[0]["ranges"]                     # contiguous, in rank order, cover K
    assert ranges[0][0] == 0 and ranges[-1][1] == chunks
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert max(e - b for b, e in ranges) - min(e - b for b, e in ranges) <= 1
    p = DO.f32_gemm_plan(176, k, n, 11)
    assert p["grid"] == (slices, tiles * p["groups"], 11)      # one cluster a column tile
    # The W8A32 GEMM: the f32 plan with a 2 KB int8 W chunk (a quarter of the
    # f32 chunk) a stage; its passes, groups and grid the f32 plan's (K2's
    # q / k / v as three outputs of one launch).
    for m, nh in ((1, 3), (11, 3), (11, 1), (88, 1), (176, 11)):
        f, q = DO.f32_gemm_plan(m, k, n, nh), DO.f32_gemm_plan(m, k, n, nh, w8=True)
        assert {x: q[x] for x in ("passes", "rows", "groups", "pg", "threads", "grid")} == {
            x: f[x] for x in ("passes", "rows", "groups", "pg", "threads", "grid")}
        assert q["stage"] == f["stage"] - DO.GEMM32_KC * DO.GEMM32_COLS * 3
        assert q["stage"] % 1024 == 0 and q["stages"] == DO.GEMM32_RING // q["stage"]
        assert q["stages"] >= f["stages"] and 2 * (q["smem"] + 1024) <= 233472


@pytest.mark.parametrize("m", [1, 4, 5, 11, 16, 17, 31, 33, 64, 88, 121, 128, 129, 176, 300,
                               968, 1024])
def test_gemm_passes_and_groups_cover_m(m):
    """Passes of up to 32 rows (R a multiple of 4, the least that holds
    them), up to 4 of them a CTA, fewer where that brings the launch
    towards 264 CTAs: every row of M once, no group empty; a CTA's shared
    memory leaves room for two an SM; a producer warp up to 16 rows a
    pass."""
    for k, n, nh in ((1280, 1280, 1), (1280, 5120, 1), (5120, 1280, 1), (1280, 1280, 11),
                     (384, 384, 1)):
        p = DO.f32_gemm_plan(m, k, n, nh)
        r, passes, groups, pg = p["rows"], p["passes"], p["groups"], p["pg"]
        assert r % 4 == 0 and 4 <= r <= 32 and (r == 4 or r - 4 < -(-m // passes))
        assert passes == -(-m // 32) and (passes - 1) * r < m <= passes * r
        assert pg <= 4 and (groups - 1) * pg < passes <= groups * pg   # no empty group
        one = p["grid"][0] * p["grid"][1] // groups * nh          # CTAs of one group
        want = max(-(-passes // 4), min(passes, -(-264 // one)))
        assert -(-passes // want) == pg                           # the passes a CTA takes
        rows = [(g * pg + q) * r + i for g in range(groups)
                for q in range(min(pg, passes - g * pg)) for i in range(r)]
        assert [x for x in rows if x < m] == list(range(m))      # every row once, in order
        assert p["stage"] % 1024 == 0 and p["stages"] == DO.GEMM32_RING // p["stage"] >= 4
        assert 2 * (p["smem"] + 1024) <= 233472                  # two CTAs an SM
        assert p["threads"] == (288 if r <= 16 else 256)         # a producer warp to 16 rows


@pytest.mark.parametrize("m", list(range(1, 300, 7)) + [128, 129, 256])
def test_row_passes_cover_m(m):
    """K4 / K5's f32 vocab stream over R = m rows: the persistent grid walks
    every (tile, pass) item once, a tile's passes adjacent; the passes
    (ceil(R / 64) of 8 TR rows, TR the least that holds them) take every row
    once, in order; tile_stats' rows of pass p, [8 TR p, 8 TR (p + 1)) below
    R, cover R once.  The plan comes from R alone, f32 or int8 E alike."""
    plan = VF.f32_vocab_plan(m, 51865)
    assert plan["tiles"] == 811 and plan["items"] == 811 * plan["passes"]
    assert plan["grid"] == min(plan["items"], LG.STREAM_CTAS * LG.H100_SMS)
    items = sorted(i for mine in plan["walk"] for i in mine)
    assert items == list(range(plan["items"]))                     # every item once
    pairs = [(i // plan["passes"], i % plan["passes"]) for i in items]
    assert pairs == [(t, p) for t in range(811) for p in range(plan["passes"])]
    tr, passes = plan["tr"], plan["passes"]
    assert passes == -(-m // 64) and 1 <= tr <= 8 and plan["rows"] == 8 * tr
    assert tr == 1 or 8 * (tr - 1) * passes < m <= 8 * tr * passes
    rows = [r for p in range(passes) for r in range(8 * tr * p, min(8 * tr * (p + 1), m))]
    assert rows == list(range(m))
    q = VF.f32_vocab_plan(m, 51865, w8=True)
    assert {k: q[k] for k in ("passes", "tr", "items", "grid")} == {
        k: plan[k] for k in ("passes", "tr", "items", "grid")}
    assert plan["chunks"] == 1280 // LG.STREAM_KC and q["chunks"] == 1280 // LG.STREAM_QKC


@pytest.mark.parametrize("tr", range(1, 9))
def test_vocab_stream_fits_two_ctas(tr):
    """The scoring stream's CTA at TR (f32 and int8 E): ring, staged sums
    (8 TR rows at pitch VS_LDC), 1 KB alignment slack and barriers leave
    room for two CTAs an SM (233472 bytes, the system's 1 KB a CTA counted);
    every stage 1024-byte aligned (the 128-byte swizzle), at least four
    stages, the ring no larger than K3 f32's."""
    for w8 in (False, True):
        plan = VF.f32_vocab_plan(8 * tr, 51865, w8=w8)
        assert plan["tr"] == tr and plan["stage"] % 1024 == 0
        assert plan["staged"] == 8 * tr * VF.STAGED_LDC * 4
        ring = plan["stages"] * plan["stage"]
        assert ring <= LG.stream_ring(plan["staged"]) <= LG.STREAM_RING and plan["stages"] >= 4
        assert plan["smem"] == (1024 + plan["stages"] * plan["stage"] + plan["staged"]
                                + 16 * plan["stages"])
        assert LG.STREAM_CTAS * (plan["smem"] + 1024) <= 233472


def _gemm_order(x, w, plan):
    """The f32 GEMM's order in numpy float32: per slice (rank order) and k
    group kg, a chain over k = 32 c + 4 kg .. + 3 of the slice's chunks c in
    order from 0 (x * w, then the add), the groups added as ((g0 + g1) +
    (g2 + g3)) + ((g4 + g5) + (g6 + g7)), the slices in rank order.  Each
    operation is elementwise over the rows."""
    kc, kg = DO.GEMM32_KC, DO.GEMM32_KG
    total = None
    for b, e in plan["ranges"]:
        groups = []
        for g in range(kg):
            acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
            for c in range(b, e):
                for j in range(4):
                    kk = c * kc + 4 * g + j
                    acc = acc + x[:, kk:kk + 1] * w[kk:kk + 1]
            groups.append(acc)
        sl = ((groups[0] + groups[1]) + (groups[2] + groups[3])) + (
            (groups[4] + groups[5]) + (groups[6] + groups[7]))
        total = sl if total is None else total + sl
    return total


def test_gemm_emulation_matches_plain():
    """The f32 GEMM's order (``_gemm_order``), then the bias and the
    epilogue: K11's fc1 (GELU) and fc2 against ffn_decode_plain; the slices
    and their order come from (K, N) alone (the same plan at M = 11 and
    176, clusters of at most 8), so an M=176 call's first 11 rows are an
    M=11 call's bits."""
    rng = np.random.default_rng(0)
    m, k, n = 176, 384, 1536
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b1 = rng.standard_normal(n).astype(np.float32)
    plan, small = DO.f32_gemm_plan(m, k, n), DO.f32_gemm_plan(11, k, n)
    assert plan["ranges"] == small["ranges"] and plan["slices"] <= DO.GEMM32_MAX_SLICES
    y = _gemm_order(x, w, plan)
    assert np.array_equal(y[:11], _gemm_order(x[:11], w, small))
    h = DO.gelu_mod.gelu(torch.from_numpy(y + b1))          # the plain version's GELU
    w2 = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)) * 0.02
    b2 = torch.zeros(k)
    ref = DO.ffn_decode_plain(*(torch.from_numpy(a) for a in (x, w, b1)), w2, b2)
    y2 = _gemm_order(h.numpy(), w2.numpy(), DO.f32_gemm_plan(m, n, k)) + b2.numpy()
    torch.testing.assert_close(torch.from_numpy(y2), ref, rtol=1e-4, atol=1e-4)


def test_w8a32_gemm_emulation_matches_mm_w8():
    """The W8A32 GEMM's order: each int8 value exactly f32, the f32 GEMM's
    sums (``_gemm_order``), then the column's scale on the sum and the bias,
    against ``megastep.mm_w8`` at 1e-5; the plan's slices come from (K, N)
    alone, so an M=176 call's first 11 rows are an M=11 call's bits."""
    from whisper_medusa_tpu_torch.ops import megastep as MS

    rng = np.random.default_rng(1)
    m, k, n = 176, 384, 256
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.02 * rng.standard_normal((k, n))).astype(np.float32)   # quantize_array's copy
    sc = (np.abs(w).max(0) / 127).astype(np.float32)
    q = np.clip(np.round(w / sc), -127, 127).astype(np.int8)
    b = (0.02 * rng.standard_normal(n)).astype(np.float32)
    plan, small = DO.f32_gemm_plan(m, k, n, w8=True), DO.f32_gemm_plan(11, k, n, w8=True)
    assert plan["ranges"] == small["ranges"]
    y = _gemm_order(x, q.astype(np.float32), plan) * sc + b
    y11 = _gemm_order(x[:11], q.astype(np.float32), small) * sc + b
    assert np.array_equal(y[:11], y11)
    ref = MS.mm_w8(torch.from_numpy(x), {"q": torch.from_numpy(q), "s": torch.from_numpy(sc)},
                   torch.from_numpy(b))
    torch.testing.assert_close(torch.from_numpy(y), ref, rtol=1e-5, atol=1e-5)


def _slices_then_combine(q, k, v, visible):
    """K10 f32's cluster arithmetic: q (B, H, T, 64), k (B, H, S, 64), v (B,
    H, S, 64), visible (B, 1, T, S) or (B, H, T, S) bool; per cluster_split
    slice (rank) the masked scores and their max, the ranks' maxima merged;
    then each rank's p = exp(s - max) over its visible keys, its row sum and
    its unnormalised PV; the ranks' sums and PV partials added in rank
    order and divided by the sum (P not rounded)."""
    s_len = k.shape[2]
    c, sc = DO.cluster_split(s_len)
    scores = torch.where(visible, torch.einsum("bhtd,bhsd->bhts", q, k),
                         torch.tensor(-float("inf")))
    slices = [slice(r * sc, min(s_len, (r + 1) * sc)) for r in range(c)]
    big = torch.stack([scores[..., sl].amax(-1) for sl in slices]).amax(0)
    num, den = None, None
    for sl in slices:
        p = torch.where(torch.isinf(scores[..., sl]), torch.zeros(()),
                        torch.exp(scores[..., sl] - big[..., None]))
        o, l = torch.einsum("bhts,bhsd->bhtd", p, v[:, :, sl]), p.sum(-1)
        num, den = (o, l) if num is None else (num + o, den + l)
    return num / den[..., None]


@pytest.mark.parametrize("s,kv_len", [(1500, 1500), (1500, 1003), (640, 200)])
def test_cross_split_combine_matches_plain(s, kv_len):
    rng = np.random.default_rng(s + kv_len)
    b, h = 2, 3
    k = torch.from_numpy(rng.standard_normal((b, h, 64, s)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, h * 64)).astype(np.float32))
    for t in (11, 1):                       # T = 1: one query row computed
        q = torch.from_numpy(rng.standard_normal((b, h, t, 64)).astype(np.float32)) * 0.125
        vis = (torch.arange(s) < kv_len)[None, None, None, :].expand(b, 1, t, s)
        got = _slices_then_combine(q, k.transpose(2, 3),
                                   v.reshape(b, s, h, 64).transpose(1, 2), vis)
        ref = DO.cross_attention_decode_plain(q, k, v, kv_len)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    plan = DO.f32_attention_plan(s, 1, self_mode=False)
    assert plan["nr"] == 1 and DO.f32_rows(11) == 16 and DO.f32_rows(4) == 4
    assert plan["smem"] <= DO.ATTN32_MAX_SMEM and plan["c"] * plan["sc"] >= s
    assert plan["sc"] % plan["key_box"] == 0
    # Two f32 CTAs (and five int8 ones) an SM at the decode step's 1500 keys.
    for int8, ctas in ((False, 2), (True, 5)):
        smem = DO.f32_attention_plan(1500, 11, self_mode=False, int8=int8)["smem"]
        assert ctas * (smem + 1024) <= 233472


@pytest.mark.parametrize("chunk", ["causal", "tree"])
def test_self_split_combine_matches_plain(chunk):
    """The mask mode: keys j < off, or chunk keys whose bit is set; a slice
    past off + TC has no visible key (its rank adds a zero sum and a zero
    partial); K2's int8 mask mode stages one item at a time, the f32 mode
    two where they fit."""
    rng = np.random.default_rng(3)
    b, t, h, s = 3, 11, 2, 460
    q = torch.from_numpy(rng.standard_normal((b, t, h, 64)).astype(np.float32)) * 0.125
    k, v = (torch.from_numpy(rng.standard_normal((b, s, h * 64)).astype(np.float32))
            for _ in range(2))
    off = torch.tensor([3, 150, 400], dtype=torch.int32)
    cm = None
    if chunk == "tree":
        cm = torch.eye(t, dtype=torch.bool)
        cm[:, 0] = True
    bits = DO.chunk_bits(cm, t, "cpu")
    rel = torch.arange(s)[None, None, :] - off.long()[:, None, None]          # (B, 1, S)
    col = rel.clamp(0, t - 1)
    word = bits.long()[torch.arange(t)[None, :, None], col // 32] & 0xFFFFFFFF  # (B, T, S)
    vis = (rel < 0) | ((rel < t) & (((word >> (col % 32)) & 1) == 1))
    split = lambda a: a.reshape(b, s, h, 64).transpose(1, 2)
    got = _slices_then_combine(q.transpose(1, 2), split(k), split(v), vis[:, None])
    ref = DO.self_attention_block_plain(q, k, v, off, bits, t)
    torch.testing.assert_close(got.transpose(1, 2), ref, rtol=1e-5, atol=1e-5)
    c, sc = DO.cluster_split(s)
    assert c == 3 and all(int(off[0]) + t <= r * sc for r in (1, 2))     # empty slices
    plan = DO.f32_attention_plan(s, t, self_mode=True)
    assert plan["sc"] == sc == 160 and plan["nr"] == 16 and plan["own"] == 6
    assert plan["smem"] <= DO.ATTN32_MAX_SMEM


def test_stream_constants_are_the_source():
    for name, value in (("FS_VT", LG.STREAM_TILE), ("FS_KC", LG.STREAM_KC),
                        ("FS_MAX_TR", LG.STREAM_MAX_TR), ("FS_THREADS", LG.STREAM_THREADS),
                        ("FS_CTAS", LG.STREAM_CTAS), ("FS_RING", LG.STREAM_RING),
                        ("FS_MAX_STAGES", LG.STREAM_MAX_STAGES)):
        assert _const(name, "ffma_stream.cuh") == value, name
    assert '#include "ffma_stream.cuh"' in open(os.path.join(CSRC, "logits.cu")).read()
    # The consumers' 4 warps x (4 entries x 8 row groups) cover a 64-entry tile.
    assert (LG.STREAM_THREADS - 32) // 32 * 4 * 8 * 4 == LG.STREAM_TILE * 8


@pytest.mark.parametrize("v", [51865, 51864])
@pytest.mark.parametrize("m", [1, 10, 11, 64, 65, 80, 121, 300])
def test_stream_walk_covers_each_tile_once(m, v):
    plan = LG.f32_stream_plan(m, v)
    assert plan["tiles"] == 811 and plan["items"] == 811 * plan["passes"]
    items = sorted(i for mine in plan["walk"] for i in mine)
    assert items == list(range(plan["items"]))                   # every item once
    assert plan["grid"] == min(plan["items"], 2 * 132)
    # item -> (tile item // passes, pass item % passes): each tile's passes once
    pairs = {(i // plan["passes"], i % plan["passes"]) for i in items}
    assert pairs == {(t, p) for t in range(811) for p in range(plan["passes"])}
    # the passes take every row once, 8 TR rows each, TR the least that holds them
    rows = [p * plan["rows"] + r for p in range(plan["passes"]) for r in range(plan["rows"])]
    assert [r for r in rows if r < m] == list(range(m)) and plan["rows"] <= 64
    assert plan["tr"] == 1 or 8 * (plan["tr"] - 1) * plan["passes"] < m
    # the last tile's rows past V are the TMA's zero fill
    assert (plan["tiles"] - 1) * LG.STREAM_TILE < v <= plan["tiles"] * LG.STREAM_TILE


@pytest.mark.parametrize("tr", range(1, 9))
def test_stream_ring_fits_two_ctas(tr):
    plan = LG.f32_stream_plan(8 * tr, 51865)
    assert plan["tr"] == tr and plan["stage"] % 1024 == 0      # swizzled tiles 1024-aligned
    assert plan["smem"] <= 232448                                # a CTA's most
    assert LG.STREAM_CTAS * (plan["smem"] + 1024) <= 233472      # an SM's 228 KB
    assert LG.STREAM_CTAS * plan["stages"] * plan["stage"] >= 32 * 1024 * 4   # in flight


@pytest.mark.parametrize("b,h,sq,skv,kv_len,causal", [
    (1, 2, 77, 300, 299, False), (1, 2, 300, 300, 257, True), (2, 1, 130, 129, 129, True),
    (1, 1, 200, 260, 131, False)])
def test_bwd_f32_dq_partials_match_plain(b, h, sq, skv, kv_len, causal):
    rng = np.random.default_rng(sq + skv)
    q, do = (torch.from_numpy(rng.standard_normal((b, h, sq, 64)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, skv, 64)).astype(np.float32))
            for _ in range(2))
    q = q * 0.25
    o = A.attention_plain(q, k, v, kv_len, causal)
    lse = A.attention_lse_plain(q, k, kv_len, causal)
    ref = A.attention_bwd_lse_plain(q, k, v, o, lse, do, kv_len, causal)
    # The kernel's P and dS, then one dQ partial per 128-key block.
    mask = A._scores_mask(q, k, kv_len, causal)
    p = torch.where(mask, torch.exp(torch.einsum("bhqd,bhkd->bhqk", q, k) - lse[..., None]),
                    torch.zeros(()))
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    nkb, kb = A.bwd_scratch_shape(b, h, sq, skv)[0], A.BWD_KEYS
    assert nkb == -(-skv // 128)
    parts = [ds[..., i * kb:(i + 1) * kb] @ k[:, :, i * kb:(i + 1) * kb] for i in range(nkb)]
    # The sum pass: blocks below kv_len, and at or below the row when causal.
    qi = torch.arange(sq)
    nb = torch.full((sq,), -(-kv_len // kb))
    if causal:
        nb = torch.minimum(nb, qi // kb + 1)
    dq = parts[0].clone()
    for i in range(1, nkb):
        dq = dq + torch.where((i < nb)[:, None], parts[i], torch.zeros(()))
    for i in range(nkb):             # a block the sum skips contributes nothing
        skipped = (i >= nb)[:, None].expand(sq, 64)
        assert not parts[i][..., skipped].any()
    rel = float((dq - ref[0]).norm() / ref[0].norm())
    assert rel <= 1e-6, rel


LOG2E = np.float32(1.4426950408889634)


def _k1_f32_order(q, k, v, kv_len, causal, tile=64):
    """K1 f32's arithmetic over 64-key tiles: masked scores, the row max m,
    base = m log2(e), p = 2^(s log2(e) - base), alpha = 2^(m_old log2(e) -
    base) (1 where the max did not move), l = l alpha + sum p, O = O alpha
    + P V; then O / l and the log-sum-exp m + log(l)."""
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    m = torch.full((b, h, sq), -float("inf"))
    l = torch.zeros((b, h, sq))
    acc = torch.zeros_like(q)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, kv_len if not causal else min(kv_len, sq), tile):
        keys = torch.arange(k0, min(k0 + tile, skv))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, keys])
        vis = keys[None, :] < kv_len
        if causal:
            vis = vis & (keys[None, :] <= rows)
        s = torch.where(vis, s, torch.tensor(-float("inf")))
        mn = torch.maximum(m, s.amax(-1))
        base = torch.where(torch.isinf(mn), torch.zeros(()), mn * LOG2E)
        alpha = torch.where(mn == m, torch.ones(()), torch.exp2(m * LOG2E - base))
        p = torch.exp2(s * LOG2E - base[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ v[:, :, keys]
        m = mn
    return acc / l[..., None], m + torch.log(l)


@pytest.mark.parametrize("b,h,sq,skv,kv_len,causal", [
    (1, 2, 300, 300, 300, False), (1, 2, 300, 300, 257, True), (2, 1, 67, 67, 67, True),
    (1, 2, 67, 300, 300, False), (1, 1, 130, 200, 131, False)])
def test_k1_f32_tile_order_matches_plain_and_xla(b, h, sq, skv, kv_len, causal):
    rng = np.random.default_rng(sq + skv + kv_len)
    q = (rng.standard_normal((b, h, sq, 64)) * 0.125).astype(np.float32)
    k, v = (rng.standard_normal((b, h, skv, 64)).astype(np.float32) for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got, lse = _k1_f32_order(tq, tk, tv, kv_len, causal)
    torch.testing.assert_close(got, A.attention_plain(tq, tk, tv, kv_len, causal),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, A.attention_lse_plain(tq, tk, kv_len, causal),
                               rtol=1e-5, atol=1e-5)
    ref = np.asarray(jattn._attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          kv_len, causal))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_k1_f32_blocks_and_smem():
    """The source's query blocks (32 RT rows: RT = 8 past Sq 512, else 2
    where that gives 132 CTAs, else 1) and its shared memory (q, the
    two-stage (K, V) ring, P) fit a CTA; the rows a thread takes (qg + 32
    i) cover a block once."""
    text = open(os.path.join(CSRC, "attention.cu")).read()
    assert ("const int rt = sq > AF_BIG ? 8 : ((sq + 63) / 64 * b * h >= AF_FILL ? 2 : 1);"
            in text)
    assert _const("AF_BIG", "attention.cu") == 512 and _const("AF_K", "attention.cu") == 64
    assert _const("AF_STAGES", "attention.cu") == 2 and _const("AF_FILL", "attention.cu") == 132
    for rt in (1, 2, 8):
        rows = 32 * rt
        smem = 1024 + 2 * rows * 64 * 4 + 2 * 2 * 64 * 64 * 4 + 8 * 5
        assert smem <= 232448 and (rt == 8 or 2 * (smem + 1024) <= 233472)
        got = sorted(qq + 4 * w + 32 * i for w in range(8) for qq in range(4) for i in range(rt))
        assert got == list(range(rows))
