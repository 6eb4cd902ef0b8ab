"""K9's f32 mode, on the CPU: its two plain versions
(ops/attention.py::attention_bwd_plain and attention_bwd_lse_plain) at f32
against the JAX package's attention backward kernel
(``_attention_bwd_pallas``, interpret mode) on f32 operands, AttentionFn's
f32 gradient against the JAX custom-vjp attention (both Pallas kernels in
interpret mode), and the K9 wrapper's refusals: CPU f32 tensors and
operands of mixed dtypes.  The kernel itself is held against the plain
versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import whisper_medusa_tpu.ops.attention as JA
from whisper_medusa_tpu_torch.ops import attention as A

# f32 sums in another order: relative to each output's largest value.
TOL = 1e-5


def _inputs(q_shape, kv_shape, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=q_shape) * 0.3).astype(np.float32)
    k, v = (rng.normal(size=kv_shape).astype(np.float32) for _ in range(2))
    g = rng.normal(size=q_shape).astype(np.float32)
    return q, k, v, g


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    assert got.dtype == torch.float32
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL * scale)


# (B, H, Sq, Skv, kv_len, causal); Sq a multiple of 128 (JAX's _bwd_block).
CASES = [(1, 2, 256, 256, 256, True), (1, 2, 256, 256, 200, False),
         (2, 1, 128, 384, 300, False), (1, 2, 384, 384, 333, True)]


@pytest.mark.parametrize("b,h,sq,skv,kv_len,causal", CASES)
def test_plain_versions_match_pallas_bwd_f32(monkeypatch, b, h, sq, skv, kv_len, causal):
    """Both plain versions at f32 against the TPU kernel on f32 operands
    (dS and P kept in f32 on both sides); dK and dV exactly 0 past kv_len."""
    monkeypatch.setattr(JA, "_INTERPRET", True)
    q, k, v, g = _inputs((b, h, sq, 64), (b, h, skv, 64), seed=sq + kv_len + causal)
    ref = JA._attention_bwd_pallas(*(jnp.asarray(a) for a in (q, k, v, g)), kv_len, causal)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o = A.attention_plain(tq, tk, tv, kv_len, causal)
    lse = A.attention_lse_plain(tq, tk, kv_len, causal)
    for got in (A.attention_bwd_plain(tq, tk, tv, tg, kv_len, causal),
                A.attention_bwd_lse_plain(tq, tk, tv, o, lse, tg, kv_len, causal)):
        for a, r in zip(got, ref):
            _close(a, r)
        assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()


@pytest.mark.parametrize("kv_len,causal", [(256, True), (190, False)])
def test_attention_fn_f32_grad_matches_jax(monkeypatch, kv_len, causal):
    """AttentionFn (full_attention_bhsd under grad mode) on f32 CPU tensors:
    its output and (dq, dk, dv) against jax.vjp of the JAX custom-vjp
    attention, whose forward and backward are the Pallas kernels."""
    monkeypatch.setattr(JA, "_INTERPRET", True)
    q, k, v, g = _inputs((1, 2, 256, 64), (1, 2, 256, 64), seed=kv_len)
    out_j, vjp = jax.vjp(lambda q_, k_, v_: JA._attention_custom(kv_len, causal, q_, k_, v_),
                         *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = A.full_attention_bhsd(*leaves, kv_len=kv_len, causal=causal)
    assert out.grad_fn is not None and out.dtype == torch.float32
    _close(out.detach(), out_j)
    out.backward(torch.from_numpy(g))
    for leaf, r in zip(leaves, ref):
        _close(leaf.grad, r)


def test_bwd_kernel_refuses_cpu_f32_and_mixed_dtypes():
    """On CPU f32 tensors the wrapper raises (the plain versions are
    AttentionFn's on the CPU, never the wrapper's); an f32 q with a bf16 O,
    or a bf16 K beside f32 q, raises before any launch."""
    q = torch.zeros((1, 1, 64, 64))
    lse = torch.zeros((1, 1, 64))
    before = sum(A.launches_bwd.values()) + sum(A.f32_launches_bwd.values())
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_bwd_kernel(q, q, q, q, 64, False, o=q, lse=lse)
    with pytest.raises(ValueError, match="all bf16 or all f32"):
        A.attention_bwd_kernel(q, q, q, q, 64, False, o=q.to(torch.bfloat16), lse=lse)
    with pytest.raises(ValueError, match="all bf16 or all f32"):
        A.attention_bwd_kernel(q, q.to(torch.bfloat16), q, q, 64, True)
    with pytest.raises(ValueError, match="all bf16 or all f32"):
        A.attention_bwd_kernel(*(q.half(),) * 4, 64, False)
    assert sum(A.launches_bwd.values()) + sum(A.f32_launches_bwd.values()) == before
