"""The f32 modes' tile plans, computed from shapes (no card), and the f32
kernels' split arithmetic emulated against the plain versions.

* ``csrc/ffma.cuh``'s constants are the wrappers' (parsed from the source);
* the f32 GEMM (K11's f32 mode, the f32 head rows, the per-op step's f32
  projections): K slices from (K, N) alone, multiples of 16 that cover K
  once; passes of 16 MT rows with MT in {1, 2, 4, 8} that cover M once;
* the f32 NT stream (K3, K4's stage B and K5 in f32): a CTA per (64-entry
  tile, pass), each warpgroup scoring half of a pass's rows as tile_stats'
  pass 2 pass + wg of 8 MT rows: every row once;
* K10's f32 mode: cluster_split's slices, each slice's (O, max, sum)
  combined in slice order (rescaled to the global max, slices with no
  visible key skipped, then divided by the sum) against the plain cross-
  and self-attention at 1e-5; in the mask mode keys at or past off + TC are
  not read;
* K3's f32 stream (``csrc/ffma_stream.cuh``): its constants are the
  wrapper's, its persistent walk takes every (vocab tile, pass) item once
  and its passes every row once, and its ring fits an SM at two CTAs;
* K9's f32 mode: dQ as one partial per 128-key block (dS K over the block's
  keys), the partials of the blocks that reach a row added in key-block
  order, against attention_bwd_lse_plain at 1e-6.
"""

import os
import re

import numpy as np
import pytest
import torch

from whisper_medusa_tpu_torch.ops import attention as A
from whisper_medusa_tpu_torch.ops import decode_ops as DO
from whisper_medusa_tpu_torch.ops import logits as LG

CSRC = os.path.join(os.path.dirname(DO.__file__), "..", "csrc")


def _const(name, source):
    text = open(os.path.join(CSRC, source)).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_constants_are_the_sources():
    assert _const("FF_COLS", "ffma.cuh") == DO.F32_COLS == LG.F32_TILE == 64
    assert _const("FF_KC", "ffma.cuh") == DO.F32_KC
    assert _const("FF_WAVE", "ffma.cuh") == DO.F32_WAVE
    assert _const("FF_MAX_MT", "ffma.cuh") == LG.F32_MAX_MT
    assert "constexpr int DF_ROW = CD_DH + 2;" in open(os.path.join(CSRC, "ffma_attn.cuh")).read()
    assert DO.F32_PART_ROW == DO.HEAD_DIM + 2
    common = open(os.path.join(CSRC, "common.cuh")).read()
    for name in ("EPI_BIAS", "EPI_SILU_RESID"):
        assert int(re.search(rf"{name} = (\d+),", common).group(1)) == getattr(DO, name)


@pytest.mark.parametrize("k,n,piece,slices", [
    (1280, 5120, 320, 4), (5120, 1280, 368, 14), (1280, 1280, 96, 14),
    (384, 1536, 48, 8), (1536, 384, 48, 32), (384, 384, 16, 24)],
    ids=["fc1", "fc2", "proj", "tiny-fc1", "tiny-fc2", "tiny-heads"])
def test_gemm_slices_come_from_k_and_n(k, n, piece, slices):
    plans = [DO.f32_gemm_plan(m, k, n, nh) for m in (1, 11, 88, 121, 176, 300)
             for nh in (1, 10, 11)]
    assert {(p["slice"], p["slices"]) for p in plans} == {(piece, slices)}
    assert piece % DO.F32_KC == 0 and (slices - 1) * piece < k <= slices * piece
    tiles = n // DO.F32_COLS
    want = -(-DO.F32_WAVE // tiles)                 # slices for two CTAs an SM
    assert piece == min(k, -(-(-(-k // want)) // DO.F32_KC) * DO.F32_KC)
    p = DO.f32_gemm_plan(176, k, n, 11)
    assert p["grid"] == (tiles * p["passes"], slices, 11)
    assert p["part"] == 11 * slices * 176 * n


@pytest.mark.parametrize("m", list(range(1, 300, 7)) + [128, 129, 256])
def test_row_passes_cover_m(m):
    mt = LG.f32_row_tiles(m)
    assert mt in (1, 2, 4, 8) and 16 * mt >= min(m, 128)
    assert mt == 1 or 16 * (mt // 2) < min(m, 128)           # the least that holds them
    plan = LG.f32_plan(m, 51865)
    assert plan["mt"] == mt and plan["tiles"] == 811
    assert (plan["passes"] - 1) * 16 * mt < m <= plan["passes"] * 16 * mt
    assert plan["grid"] == 811 * plan["passes"]
    # tile_stats' halves: warpgroup wg of pass p scores rows [(2p + wg) 8 MT, + 8 MT).
    rows = [r for p in range(plan["passes"]) for wg in (0, 1)
            for r in range((2 * p + wg) * 8 * mt, min((2 * p + wg + 1) * 8 * mt, m))]
    assert rows == list(range(m))


def test_gemm_emulation_matches_plain():
    """The f32 GEMM's order: each slice's partial, the slices added in
    order, then the bias and the epilogue."""
    rng = np.random.default_rng(0)
    m, k, n = 11, 384, 1536
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((m, k), (k, n)))
    b1 = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    plan = DO.f32_gemm_plan(m, k, n)
    parts = [x[:, s * plan["slice"]:(s + 1) * plan["slice"]]
             @ w[s * plan["slice"]:(s + 1) * plan["slice"]] for s in range(plan["slices"])]
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    h = 0.5 * (y + b1) * (1 + torch.erf((y + b1) / np.sqrt(2.0)))
    w2 = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)) * 0.02
    b2 = torch.zeros(k)
    ref = DO.ffn_decode_plain(x, w, b1, w2, b2)
    torch.testing.assert_close(h @ w2 + b2, ref, rtol=1e-4, atol=1e-4)


def _slices_then_combine(q, k, v, visible):
    """K10's f32 arithmetic: q (B, H, T, 64), k (B, H, S, 64), v (B, H, S,
    64), visible (B, 1, T, S) or (B, H, T, S) bool; per cluster_split slice
    the max, sum of exp and unnormalised PV over its visible keys, then the
    combine."""
    s_len = k.shape[2]
    c, sc = DO.cluster_split(s_len)
    scores = torch.einsum("bhtd,bhsd->bhts", q, k)
    stats = []
    for r in range(c):
        sl = slice(r * sc, min(s_len, (r + 1) * sc))
        sv = torch.where(visible[..., sl], scores[..., sl], torch.tensor(-float("inf")))
        m = sv.amax(-1)
        p = torch.where(torch.isinf(m)[..., None], torch.zeros_like(sv),
                        torch.exp(sv - m[..., None]))
        stats.append((m, p.sum(-1), torch.einsum("bhts,bhsd->bhtd", p, v[:, :, sl])))
    big = torch.stack([m for m, _, _ in stats]).amax(0)
    num = torch.zeros_like(q)
    den = torch.zeros(q.shape[:-1])
    for m, l, o in stats:
        w = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - big))
        den = den + l * w
        num = num + o * w[..., None]
    return num / den[..., None]


@pytest.mark.parametrize("s,kv_len", [(1500, 1500), (1500, 1003), (640, 200)])
def test_cross_split_combine_matches_plain(s, kv_len):
    rng = np.random.default_rng(s + kv_len)
    b, h, t = 2, 3, 11
    q = torch.from_numpy(rng.standard_normal((b, h, t, 64)).astype(np.float32)) * 0.125
    k = torch.from_numpy(rng.standard_normal((b, h, 64, s)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, h * 64)).astype(np.float32))
    vis = (torch.arange(s) < kv_len)[None, None, None, :].expand(b, 1, t, s)
    got = _slices_then_combine(q, k.transpose(2, 3), v.reshape(b, s, h, 64).transpose(1, 2),
                               vis)
    ref = DO.cross_attention_decode_plain(q, k, v, kv_len)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", ["causal", "tree"])
def test_self_split_combine_matches_plain(chunk):
    """The mask mode: keys j < off, or chunk keys whose bit is set; a slice
    past off + TC has no visible key (its statistics are skipped)."""
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
    assert c == 3 and all(int(off[0]) + t <= r * sc for r in (1, 2))     # skipped slices


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
