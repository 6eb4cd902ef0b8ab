"""K2's self- and cross-attention on the cluster body, on the CPU.

``csrc/megastep.cu`` runs K2's attention on K10's thread-block-cluster body
(``csrc/cluster_attn.cuh``): one cluster per (head, example), its CTAs
taking slices of the keys chosen from the key count alone
(``ops/megastep.py::attention_plan``).  In mask mode the self-attention also
commits the chunk's K/V rows: the rank whose slice holds position off + t
(below S) writes row t, int8 slabs quantized per (position, head); every
rank attends the chunk's own keys from the fresh rows and the history rows
j < off from the slab, dequantized as they are staged at int8.

The plan is held to ``decode_ops.cluster_split`` and the constants of
``cluster_attn.cuh`` to the Python ones; a torch emulation of the per-rank
commit covers every chunk position below S exactly once; and a float32
emulation of the int8 mask mode per slice (history dequantized per
(position, head), chunk rows fresh, maxima and sums merged in rank order, P
rounded to bf16 once) is held to the plain route ``_layer_step`` takes and
to the JAX ``decoder_layer_step``'s int8 self-attention within 1e-2 + 1e-2
|x|, the bar of ``tests/test_torch_cross_split.py`` (the kernel rounds P
once; other sums may move a value one bf16 step).  Inputs are numpy draws
from fixed seeds.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu_torch.config import WHISPER_PRESETS, tiny_test_config
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import decode_ops as DO
from whisper_medusa_tpu_torch.ops import megastep as MS

MAX_LEN = 460          # generate's self slab: max_target_positions 448 + 12


def _tree_mask(t):
    """Node i sees itself, node 0 and the even nodes before it."""
    m = np.eye(t, dtype=bool)
    m[:, 0] = True
    for i in range(t):
        m[i, :i:2] = True
    return m


def _chunk_mask(kind, t):
    return (np.tril(np.ones((t, t), dtype=bool)) if kind == "causal" else _tree_mask(t))


@pytest.mark.parametrize("name", ["large-v2", "base", "tiny", "test"])
def test_attention_plan_is_the_cluster_split(name):
    dims = tiny_test_config().dims if name == "test" else WHISPER_PRESETS[name]
    s_enc, max_len = dims.max_source_positions, dims.max_target_positions + 12
    plan = MS.attention_plan(s_enc, max_len)
    assert plan == {"cross": DO.cluster_split(s_enc), "self": DO.cluster_split(max_len)}
    if name != "test":
        assert plan == {"cross": (8, 192), "self": (3, 160)}
    for c, sc in plan.values():
        assert sc % 16 == 0 and sc <= DO.MAX_SLICE and 1 <= c <= DO.MAX_CLUSTER


def test_cluster_attn_constants_match_python():
    with open(os.path.join(cuda_lib.CSRC_DIR, "cluster_attn.cuh")) as f:
        text = f.read()
    k = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert k["CD_DH"] == DO.HEAD_DIM
    assert k["CD_MAXT"] == DO.MAX_T == MS.MAX_T
    assert k["CD_KEYS"] == DO.CLUSTER_KEYS
    assert k["CD_MAXC"] == DO.MAX_CLUSTER
    assert k["CD_WARPS"] * 16 * k["CD_NT"] == DO.MAX_SLICE
    assert "constexpr int CD_MAXSLICE = CD_WARPS * 16 * CD_NT;" in text
    # K2 launches the shared body; its old attention kernels are gone.
    with open(os.path.join(cuda_lib.CSRC_DIR, "megastep.cu")) as f:
        mega = f.read()
    assert '#include "cluster_attn.cuh"' in mega
    for gone in ("self_attn_kernel", "cross_partial_kernel", "cross_combine_kernel", "P_PART"):
        assert gone not in mega
    assert not hasattr(MS, "CROSS_CHUNK")


def _streamed(layers, dtype=torch.bfloat16):
    """``layers`` with K2's streamed weights added in ``dtype`` (``fits``
    reads their dtype; one element each stands for the weight)."""
    w = lambda: torch.zeros(1, dtype=dtype)
    return {**layers, "self": {k: w() for k in ("q_w", "k_w", "v_w", "o_w")},
            "cross": {k: w() for k in ("q_w", "o_w")}, "fc1_w": w(), "fc2_w": w()}


def test_fits_reaches_the_cluster_split():
    layers = _streamed({"fc1_b": torch.zeros((2, 5120))})
    ck = torch.zeros((2, 1, 20, 64, 1500))
    x = torch.zeros((1, 11, 1280))
    slab = lambda s: torch.zeros((2, 1, s, 1280))
    assert MS.fits(layers, x, slab(MAX_LEN), ck, 20)
    assert MS.fits(layers, x, slab(8 * 384), ck, 20)
    assert not MS.fits(layers, x, slab(8 * 384 + 16), ck, 20)
    assert not MS.fits(layers, x, slab(MAX_LEN), torch.zeros((2, 1, 20, 64, 3100)), 20)


def commit_rows(off, t, s_len):
    """The self-attention's commit as the kernel splits it: {rank: chunk
    rows t it writes}; rank r of the plan's C takes positions [r * SC, (r +
    1) * SC), and writes row t of the chunk iff off + t lies in its slice
    and below S."""
    c, sc = MS.attention_plan(1500, s_len)["self"]
    rows = {}
    for r in range(c):
        j_start = r * sc
        t_end = min(t, min(j_start + sc, s_len) - off)
        rows[r] = list(range(max(j_start - off, 0), t_end))
    return rows


@pytest.mark.parametrize("t", [1, 11, 16])
@pytest.mark.parametrize("off", [0, 155, 455])
def test_commit_covers_chunk_rows_below_s_once(off, t):
    rows = commit_rows(off, t, MAX_LEN)
    written = [row for r in sorted(rows) for row in rows[r]]
    assert sorted(written) == list(range(min(t, MAX_LEN - off)))      # each row once
    c, sc = MS.attention_plan(1500, MAX_LEN)["self"]
    for r, mine in rows.items():
        assert all(r * sc <= off + row < min((r + 1) * sc, MAX_LEN) for row in mine)
    owners = {r for r, mine in rows.items() if mine}
    if off == 155 and t > 5:
        assert owners == {0, 1}             # straddles the 160-key boundary
    if off == 455:
        assert owners == {2} and len(written) == min(t, 5)     # runs past S = 460


def _quantize_rows(x, h):
    """The commit's arithmetic per (position, head): sc = max(amax, 1e-30) /
    127 in float32, round half to even, clipped to +-127; (int8, bf16 sc)."""
    b, t, d = x.shape
    x32 = x.float().reshape(b, t, h, d // h)
    sc = torch.clamp(x32.abs().amax(-1, keepdim=True), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x32 / sc), -127, 127).to(torch.int8)
    return q.reshape(b, t, d), sc[..., 0].to(torch.bfloat16)


def emulate_self(q, kn, vn, slab_k, slab_v, slab_s, offsets, chunk_mask, h):
    """K2's mask mode at float32, rank by rank: the commit into copies of the
    slabs (int8 with a bf16 scale slab, or bf16 when ``slab_s`` is None),
    then the attention over history rows j < off from the slab as it stood
    (dequantized bf16(q * f32(scale)) at int8) and the chunk's keys from the
    fresh rows; maxima merged, sums and PV partials added in rank order, P
    rounded to bf16 once.  Returns (out (B, T, H, Dh) bf16, slabs)."""
    b, t, hh, dh = q.shape
    s_len = slab_k.shape[1]
    c, sc = MS.attention_plan(1500, s_len)["self"]
    quant = slab_s is not None
    new_k, new_v = slab_k.clone(), slab_v.clone()
    new_s = slab_s.clone() if quant else None
    if quant:
        kq, ks = _quantize_rows(kn, h)
        vq, vs = _quantize_rows(vn, h)
    for e in range(b):
        off = int(offsets[e])
        for r, mine in commit_rows(off, t, s_len).items():
            for row in mine:
                if quant:
                    new_k[e, off + row], new_v[e, off + row] = kq[e, row], vq[e, row]
                    new_s[e, off + row, :h], new_s[e, off + row, h:] = ks[e, row], vs[e, row]
                else:
                    new_k[e, off + row], new_v[e, off + row] = kn[e, row], vn[e, row]

    def staged(slab, lanes, fresh, e, off):
        """Keys [0, min(off + T, S)) of example e as the kernel stages them."""
        n = min(off + t, s_len)
        if quant:
            hist = (slab[e, :off].float().reshape(off, h, dh)
                    * slab_s[e, :off, lanes].float()[..., None]).to(torch.bfloat16)
            hist = hist.reshape(off, h * dh)
        else:
            hist = slab[e, :off]
        return torch.cat([hist, fresh[e, :n - off].to(torch.bfloat16)]).float()

    out = torch.empty((b, t, hh, dh), dtype=torch.bfloat16)
    cm = torch.from_numpy(chunk_mask)
    for e in range(b):
        off = int(offsets[e])
        kk = staged(slab_k, slice(0, h), kn, e, off).reshape(-1, h, dh)
        vv = staged(slab_v, slice(h, 2 * h), vn, e, off).reshape(-1, h, dh)
        n = kk.shape[0]
        s = torch.einsum("thd,jhd->htj", q[e].float(), kk)
        j = torch.arange(n)
        rel = j - off
        vis = (j < off)[None, :] | ((rel >= 0) & (rel < t))[None, :] & cm[:, rel.clamp(0, t - 1)]
        s = torch.where(vis[None], s, torch.tensor(-torch.inf))
        cuts = [(r * sc, min((r + 1) * sc, n)) for r in range(c) if r * sc < n]
        m = torch.stack([s[..., a:z].amax(-1) for a, z in cuts]).amax(0)[..., None]
        ex = torch.where(vis[None], torch.exp(s - m), torch.tensor(0.0))
        total = ex[..., cuts[0][0]:cuts[0][1]].sum(-1)
        for a, z in cuts[1:]:
            total = total + ex[..., a:z].sum(-1)
        p = (ex / total[..., None]).to(torch.bfloat16).float()
        acc = torch.einsum("htj,jhd->thd", p[..., cuts[0][0]:cuts[0][1]],
                           vv[cuts[0][0]:cuts[0][1]])
        for a, z in cuts[1:]:
            acc = acc + torch.einsum("htj,jhd->thd", p[..., a:z], vv[a:z])
        out[e] = acc.to(torch.bfloat16)
    return out, (new_k, new_v, new_s)


def _self_inputs(seed, b, t, h, offsets, int8, f32=False):
    rng = np.random.default_rng(seed)
    d = h * 64
    q = torch.from_numpy((0.125 * rng.standard_normal((b, t, h, 64))).astype(np.float32))
    if not f32:
        q = q.to(torch.bfloat16)
    # Fresh rows are K2's bf16 projection rows.
    kn = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to(torch.bfloat16)
    vn = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to(torch.bfloat16)
    if int8:
        i8 = lambda: torch.from_numpy(rng.integers(-127, 128, (b, MAX_LEN, d)).astype(np.int8))
        sk, sv = i8(), i8()
        ss = torch.from_numpy((0.004 + 0.012 * rng.random((b, MAX_LEN, 2 * h)))
                              .astype(np.float32)).to(torch.bfloat16)
    else:
        bf = lambda: torch.from_numpy(rng.standard_normal((b, MAX_LEN, d))
                                      .astype(np.float32)).to(torch.bfloat16)
        sk, sv, ss = bf(), bf(), None
    return q, kn, vn, sk, sv, ss, torch.tensor(offsets, dtype=torch.int32)


def plain_route(q, kn, vn, sk, sv, ss, offsets, chunk_mask, h):
    """``models/whisper.py::_layer_step``'s self-attention on copies of the
    slabs: quantize_self_rows -> write_rows -> dequant_self -> the fresh
    rows -> _attend_plain (bf16 slabs: write_rows -> _attend_plain)."""
    sk, sv = sk.clone(), sv.clone()
    t, s_len = q.shape[1], sk.shape[1]
    if ss is None:
        tw.write_rows(sk, kn, offsets)
        tw.write_rows(sv, vn, offsets)
        k_att, v_att = sk, sv
    else:
        ss = ss.clone()
        kq, k_sc = tw.quantize_self_rows(kn, h)
        vq, v_sc = tw.quantize_self_rows(vn, h)
        tw.write_rows(sk, kq, offsets)
        tw.write_rows(sv, vq, offsets)
        tw.write_rows(ss, torch.cat([k_sc, v_sc], dim=-1).to(ss.dtype), offsets)
        k_att = tw.dequant_self(sk, ss[..., :h], h)
        v_att = tw.dequant_self(sv, ss[..., h:], h)
        tw.write_rows(k_att, kn.to(torch.bfloat16), offsets)
        tw.write_rows(v_att, vn.to(torch.bfloat16), offsets)
    mask = tw.make_step_mask(offsets, t, s_len, torch.from_numpy(chunk_mask))
    return tw._attend_plain(q, k_att, v_att, mask), (sk, sv, ss)


def _close(got, ref, tol=1e-2):
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= tol + tol * ref.abs()).all())


OFFSETS = {"straddling": [155, 315, 150], "ragged": [0, 449, 7]}


@pytest.mark.parametrize("chunk", ["causal", "tree"])
@pytest.mark.parametrize("offs", sorted(OFFSETS))
def test_int8_mask_mode_matches_plain_route(offs, chunk):
    h, t = 2, 11
    cm = _chunk_mask(chunk, t)
    args = _self_inputs(11, 3, t, h, OFFSETS[offs], int8=True)
    got, slabs = emulate_self(*args, cm, h)
    ref, ref_slabs = plain_route(*args, cm, h)
    assert got.shape == ref.shape == (3, t, h, 64) and got.dtype == ref.dtype == torch.bfloat16
    assert _close(got, ref)
    # The committed int8 rows and scales are bitwise quantize_self_rows';
    # every other row is untouched.
    for a, c in zip(slabs, ref_slabs):
        assert torch.equal(a, c)


@pytest.mark.parametrize("offs", sorted(OFFSETS))
def test_bf16_mask_mode_with_fresh_chunk_rows_matches_plain(offs):
    """bf16 slabs: the chunk's keys come from the fresh rows, whose bits the
    commit writes, so the attention equals the plain one over the committed
    slab."""
    h, t = 2, 11
    cm = _chunk_mask("tree", t)
    args = _self_inputs(12, 3, t, h, OFFSETS[offs], int8=False)
    got, slabs = emulate_self(*args, cm, h)
    ref, ref_slabs = plain_route(*args, cm, h)
    assert _close(got, ref)
    assert torch.equal(slabs[0], ref_slabs[0]) and torch.equal(slabs[1], ref_slabs[1])


@pytest.mark.parametrize("t", [1, 16])
def test_int8_commit_is_quantize_self_rows_bitwise(t):
    rng = np.random.default_rng(13 + t)
    x = torch.from_numpy(rng.standard_normal((3, t, 6 * 64)).astype(np.float32))
    x = x.to(torch.bfloat16)
    x[0, 0, :64] = 0            # an all-zero (position, head): sc = 1e-30 / 127
    q, sc = _quantize_rows(x, 6)
    ref_q, ref_sc = tw.quantize_self_rows(x, 6)
    assert torch.equal(q, ref_q) and torch.equal(sc, ref_sc.to(torch.bfloat16))
    jq, jsc = jw.quantize_self_rows(jnp.asarray(x.float().numpy()), 6)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(ref_sc.numpy(), np.asarray(jsc))


@pytest.mark.parametrize("chunk", ["causal", "tree"])
def test_int8_mask_mode_matches_jax_decoder_self_attention_tiny(chunk):
    """Whisper tiny's width (6 heads of 64), max_len 460, B = 3 at ragged
    offsets that straddle the 160-key slices; q in float32.  The JAX side is
    the int8 branch of ``decoder_layer_step``'s self-attention, built from
    its own functions (quantize_self_rows, _write_cache_chunk,
    _dequant_self, attention under make_step_mask)."""
    h, t, offs = 6, 11, [155, 315, 150]
    cm = _chunk_mask(chunk, t)
    q, kn, vn, sk, sv, ss, offsets = _self_inputs(14, 3, t, h, offs, int8=True, f32=True)
    got, _ = emulate_self(q, kn, vn, sk, sv, ss, offsets, cm, h)
    j = lambda a: jnp.asarray(a.float().numpy())
    joff = jnp.asarray(offsets.numpy())
    kq, ksc = jw.quantize_self_rows(j(kn), h)
    vq, vsc = jw.quantize_self_rows(j(vn), h)
    k_buf = jw._write_cache_chunk(jnp.asarray(sk.numpy()), kq, joff)
    v_buf = jw._write_cache_chunk(jnp.asarray(sv.numpy()), vq, joff)
    s_new = jnp.concatenate([ksc, vsc], axis=-1).astype(jnp.bfloat16)
    self_s = jw._write_cache_chunk(jnp.asarray(ss.float().numpy()).astype(jnp.bfloat16),
                                   s_new, joff)
    k_att = jw._write_cache_chunk(jw._dequant_self(k_buf, self_s[..., :h], h),
                                  j(kn).astype(jnp.bfloat16), joff)
    v_att = jw._write_cache_chunk(jw._dequant_self(v_buf, self_s[..., h:], h),
                                  j(vn).astype(jnp.bfloat16), joff)
    split = lambda a: a.reshape(3, MAX_LEN, h, 64)
    mask = jw.make_step_mask(joff, t, MAX_LEN, jnp.asarray(cm))
    ref = np.array(jw.attention(j(q), split(k_att), split(v_att), mask).astype(jnp.float32))
    assert _close(got, torch.from_numpy(ref))
