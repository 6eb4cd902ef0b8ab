"""K10 past T = 16: the wrappers' 16-row blocking of the query rows.

A K10 launch takes one m16 tile of queries, so ``ops/decode_ops.py`` sends a
longer chunk (a chain of 16 or more heads) in 16-row blocks.  Here the
blocking runs with the plain versions as the per-block function and is held
against the unblocked plain version at T = 17, 24 and 31, float32 on the CPU
(1e-5): cross-attention (bf16 and int8 K/V: each block is one more launch
on the same K/V) and the mask mode (a causal and a tree chunk mask: each
block keeps its own rows of chunk bits over all T columns at the same
offsets).  The chunk bits of a row are W = ceil(T / 32) int32 words: T =
32 packs into one (bit 31 is the sign bit), T = 33, 64 and 130 into 2, 2 and
5, and a chunk wider than the self slab raises.
"""

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu_torch.ops import decode_ops as D

H, DH = 3, 64


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def tree_mask(t, seed):
    """A random tree over t nodes, node 0 the root: node i sees itself and
    its ancestors."""
    parent = [-1] + [int(p) for p in _rng(seed).integers(0, np.arange(1, t))]
    m = np.zeros((t, t), bool)
    for i in range(t):
        j = i
        while j >= 0:
            m[i, j] = True
            j = parent[j]
    return torch.from_numpy(m)


@pytest.mark.parametrize("t", [17, 24, 31])
@pytest.mark.parametrize("int8", [False, True])
def test_cross_blocks_equal_unblocked(t, int8):
    rng = _rng(t)
    b, s, kv_len = 2, 96, 90
    q = _t(0.125 * rng.standard_normal((b, H, t, DH)))
    if int8:
        k = torch.from_numpy(rng.integers(-127, 128, (b, H, DH, s)).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, (b, s, H * DH)).astype(np.int8))
        ks = _t(0.004 + 0.01 * rng.random((b, H, s)))
        vs = _t(0.004 + 0.01 * rng.random((b, H, s)))
    else:
        k = _t(rng.standard_normal((b, H, DH, s)))
        v = _t(rng.standard_normal((b, s, H * DH)))
        ks = vs = None
    launches = []

    def block(qb):
        assert qb.shape[2] <= D.MAX_T and qb.is_contiguous()
        launches.append(qb.shape[2])
        return D.cross_attention_decode_plain(qb, k, v, kv_len, ks, vs)

    got = D.cross_attention_blocked(q, block)
    ref = D.cross_attention_decode_plain(q, k, v, kv_len, ks, vs)
    assert launches == [n for _, n in D.row_blocks(t)] and sum(launches) == t
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [17, 24, 31])
@pytest.mark.parametrize("mask", ["causal", "tree"])
def test_self_blocks_equal_unblocked(t, mask):
    rng = _rng(100 + t)
    b, s = 3, 80
    offsets = torch.tensor([0, 13, s - t], dtype=torch.int32)
    q = _t(0.125 * rng.standard_normal((b, t, H, DH)))
    k = _t(rng.standard_normal((b, s, H * DH)))
    v = _t(rng.standard_normal((b, s, H * DH)))
    chunk = None if mask == "causal" else tree_mask(t, t)
    bits = D.chunk_bits(chunk, t, "cpu")
    launches = []

    def block(qb, bb, t_chunk):
        assert qb.shape[1] <= D.MAX_T and bb.shape == (qb.shape[1], 1) and t_chunk == t
        launches.append(qb.shape[1])
        return D.self_attention_block_plain(qb, k, v, offsets, bb, t_chunk)

    got = D.self_attention_blocked(q, bits, block)
    ref = D.self_attention_decode_plain(q, k, v, offsets, chunk)
    assert launches == [n for _, n in D.row_blocks(t)]
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_one_block_is_the_whole_chunk():
    """At T <= 16 the block function sees the chunk itself, once."""
    rng = _rng(7)
    b, t, s = 2, 11, 40
    offsets = torch.tensor([3, 20], dtype=torch.int32)
    q = _t(0.125 * rng.standard_normal((b, t, H, DH)))
    k, v = (_t(rng.standard_normal((b, s, H * DH))) for _ in range(2))
    bits = D.chunk_bits(None, t, "cpu")
    seen = []
    got = D.self_attention_blocked(
        q, bits, lambda qb, bb, tc: seen.append(qb) or
        D.self_attention_block_plain(qb, k, v, offsets, bb, tc))
    assert len(seen) == 1 and seen[0] is q
    torch.testing.assert_close(got, D.self_attention_decode_plain(q, k, v, offsets),
                               rtol=1e-5, atol=1e-5)


def test_chunk_bits_width():
    causal = D.chunk_bits(None, 32, "cpu")
    assert causal.dtype == torch.int32 and causal.shape == (32, 1)
    assert int(causal[31, 0]) == -1                                # all 32 bits
    for t, w in ((32, 1), (33, 2), (64, 2), (130, 5)):
        tree = tree_mask(t, 5)
        got = D.chunk_bits(tree, t, "cpu").to(torch.int64) & 0xFFFFFFFF
        assert got.shape == (t, w)
        want = [[sum(1 << (j - 32 * k) for j in range(32 * k, min(t, 32 * k + 32))
                     if tree[i, j]) for k in range(w)] for i in range(t)]
        assert got.tolist() == want
    causal = D.chunk_bits(None, 33, "cpu")
    assert causal.shape == (33, 2) and causal[32].tolist() == [-1, 1]
    with pytest.raises(ValueError, match="self slab"):
        D.chunk_bits(None, 33, "cpu", max_len=32)
    with pytest.raises(ValueError, match="self slab"):
        D.chunk_bits(torch.eye(130, dtype=torch.bool), 130, "cpu", max_len=129)
