"""K10's cluster split and its mask mode, on the CPU.

``csrc/decode_ops.cu`` splits each (example, head)'s keys over the C CTAs of
a thread-block cluster (``ops/decode_ops.py::cluster_split``): each CTA
takes the maxima and the sums of its slice, the cluster combines them (the
maxima in any order, the sums in rank order), each CTA normalises its P with
the global max and sum and rounds it to bf16 once, and the partial PV
products are added in rank order.  A float32 torch emulation of that split
is held against ``cross_attention_decode_plain``, bf16 and int8, at cluster
sizes 1, 2, 4 and 8 and at kv_len < S: elementwise within 1e-2 + 1e-2 |x|,
the bar ``chip_smoke.py`` holds the kernel to (both round P and the output
to bf16 once; other sums may move a value one bf16 step).

The mask mode's plain version ``self_attention_decode_plain`` is bitwise
``models/whisper.py::attention`` under ``make_step_mask`` (what the per-op
step runs on the CPU), and matches the JAX ``decoder_layer_step``'s
self-attention (``attention`` under ``make_step_mask``) at whisper tiny's
width in float32 (1e-5).  ``chunk_bits`` packs the chunk masks the kernel
reads.  Inputs are numpy draws from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.ops import decode_ops as tdo


def emulate_split(q, k, v, kv_len, c, k_s=None, v_s=None, mask=None):
    """K10's arithmetic with the keys cut into c slices of
    ``cluster_split``'s width: q (B, H, T, Dh), k (B, H, Dh, S), v (B, S, H
    Dh); ``mask`` (B, 1 or H, T, S) bool replaces ``col < kv_len``."""
    b, h, t, dh = q.shape
    s = k.shape[3]
    sc = -(-(-(-s // c)) // 16) * 16
    scores = torch.einsum("bhtd,bhds->bhts", q.float(), k.float())
    if k_s is not None:
        scores = scores * k_s[:, :, None, :]
    vis = torch.arange(s)[None, None, None, :] < kv_len if mask is None else mask
    scores = torch.where(vis, scores, torch.tensor(-torch.inf))
    cuts = [(r * sc, min((r + 1) * sc, s)) for r in range(c)]
    cuts = [(a, z) for a, z in cuts if a < z]
    m = torch.stack([scores[..., a:z].amax(-1) for a, z in cuts]).amax(0)[..., None]
    e = torch.where(vis, torch.exp(scores - m), torch.tensor(0.0))
    total = e[..., cuts[0][0]:cuts[0][1]].sum(-1)
    for a, z in cuts[1:]:
        total = total + e[..., a:z].sum(-1)
    p = e / total[..., None]
    if v_s is not None:
        p = p * v_s[:, :, None, :]
    p = p.to(torch.bfloat16).float()
    vh = v.reshape(b, s, h, dh).float()
    parts = [torch.einsum("bhts,bshd->bhtd", p[..., a:z], vh[:, a:z]) for a, z in cuts]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out.to(torch.bfloat16)


def _inputs(seed, b, h, t, s, int8):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(0.125 * rng.standard_normal((b, h, t, 64))).to(torch.bfloat16)
    if not int8:
        rnd = lambda *shape: torch.from_numpy(rng.standard_normal(shape)).to(torch.bfloat16)
        return q, rnd(b, h, 64, s), rnd(b, s, h * 64), None, None
    i8 = lambda *shape: torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    scl = lambda *shape: torch.from_numpy(0.004 + 0.012 * rng.random(shape)).float()
    return q, i8(b, h, 64, s), i8(b, s, h * 64), scl(b, h, s), scl(b, h, s)


def _close(got, ref, tol=1e-2):
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= tol + tol * ref.abs()).all())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("c", [1, 2, 4, 8])
@pytest.mark.parametrize("s,kv_len", [(1500, 1500), (1500, 1003), (640, 640)])
def test_split_matches_plain(int8, c, s, kv_len):
    q, k, v, ks, vs = _inputs(s + c + kv_len, 2, 3, 11, s, int8)
    got = emulate_split(q, k, v, kv_len, c, ks, vs)
    ref = tdo.cross_attention_decode_plain(q, k, v, kv_len, ks, vs)
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.bfloat16
    assert _close(got, ref)


@pytest.mark.parametrize("s", [4, 20, 192, 460, 640, 1500, 2048, 3072])
def test_cluster_split_covers_the_keys(s):
    c, sc = tdo.cluster_split(s)
    assert 1 <= c <= tdo.MAX_CLUSTER and sc % 16 == 0 and sc <= tdo.MAX_SLICE
    assert c * sc >= s and (c - 1) * sc < s     # every rank starts inside S
    assert tdo.cluster_split(s) == (c, sc)      # S alone decides


def _self_inputs(seed, b, t, h, max_len):
    rng = np.random.default_rng(seed)
    q = (0.125 * rng.standard_normal((b, t, h, 64))).astype(np.float32)
    k = rng.standard_normal((b, max_len, h * 64)).astype(np.float32)
    v = rng.standard_normal((b, max_len, h * 64)).astype(np.float32)
    offsets = np.asarray([3 + (37 * e) % (max_len - t - 3) for e in range(b)], np.int32)
    return q, k, v, offsets


def _tree_mask(t):
    """A chunk mask other than the causal one: node i sees itself, node 0
    and the even nodes before it."""
    m = np.eye(t, dtype=bool)
    m[:, 0] = True
    for i in range(t):
        m[i, :i:2] = True
    return m


@pytest.mark.parametrize("chunk", ["causal", "tree"])
def test_self_plain_is_attention_under_step_mask(chunk):
    q, k, v, offsets = _self_inputs(1, 4, 11, 3, 48)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    off = torch.from_numpy(offsets)
    cm = None if chunk == "causal" else torch.from_numpy(_tree_mask(11))
    got = tdo.self_attention_decode_plain(qt, kt, vt, off, cm)
    split = lambda x: x.reshape(4, 48, 3, 64)
    ref = tw.attention(qt, split(kt), split(vt), tw.make_step_mask(off, 11, 48, cm))
    assert torch.equal(got, ref)
    # The per-op step's CPU route is the same function.
    assert torch.equal(tw._attend_ops(qt, kt, vt, tw._step_mask_ops(off, 11, 48, cm)), ref)


@pytest.mark.parametrize("chunk", ["causal", "tree"])
def test_self_plain_matches_jax_decoder_self_attention_tiny(chunk):
    """Whisper tiny's width (6 heads of 64) and max_len 460, float32."""
    q, k, v, offsets = _self_inputs(2, 3, 11, 6, 460)
    cm = None if chunk == "causal" else _tree_mask(11)
    got = tdo.self_attention_decode_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(offsets), None if cm is None else torch.from_numpy(cm))
    split = lambda x: jnp.asarray(x).reshape(3, 460, 6, 64)
    mask = jw.make_step_mask(jnp.asarray(offsets), 11, 460,
                             None if cm is None else jnp.asarray(cm))
    ref = np.asarray(jw.attention(jnp.asarray(q), split(k), split(v), mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c", [1, 3, 8])
def test_self_split_matches_plain(c):
    """The mask mode's arithmetic (the split, skipped keys past off + T)
    against its plain version, bf16, with a tree chunk mask."""
    q, k, v, offsets = _self_inputs(3, 3, 11, 2, 460)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    off, cm = torch.from_numpy(offsets), torch.from_numpy(_tree_mask(11))
    mask = tw.make_step_mask(off, 11, 460, cm)
    kh = kt.reshape(3, 460, 2, 64).permute(0, 2, 3, 1)              # (B, H, Dh, S)
    got = emulate_split(qt.transpose(1, 2), kh, vt, 460, c, mask=mask).transpose(1, 2)
    assert _close(got, tdo.self_attention_decode_plain(qt, kt, vt, off, cm))


def test_chunk_bits():
    causal = tdo.chunk_bits(None, 5, "cpu")
    assert causal.dtype == torch.int32 and causal.tolist() == [[1], [3], [7], [15], [31]]
    tree = _tree_mask(11)
    bits = tdo.chunk_bits(torch.from_numpy(tree), 11, "cpu").tolist()
    for i in range(11):
        assert [bool(bits[i][0] >> j & 1) for j in range(11)] == tree[i].tolist()
    with pytest.raises(ValueError, match="diagonal"):
        tdo.chunk_bits(torch.zeros((3, 3), dtype=torch.bool), 3, "cpu")


def test_self_kernel_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 1, 64), dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tdo.self_attention_decode_kernel(q, kv, kv, torch.zeros(1, dtype=torch.int32),
                                         tdo.chunk_bits(None, 2, "cpu"))
    assert tdo.self_launches == 0
