"""K9's plain version (ops/attention.py::attention_bwd_plain) against the JAX
package's attention backward: its Pallas kernel in interpret mode at bf16,
and the XLA vjp in f32; AttentionFn's gradient; the K9 wrapper refuses CPU
tensors.  The kernel itself is held against the plain version on the card
by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
import whisper_medusa_tpu.ops.attention as JA
from whisper_medusa_tpu_torch.ops import attention as A


def _inputs(q_shape, kv_len_shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=q_shape) * 0.3).astype(dtype)
    k, v = (rng.normal(size=kv_len_shape).astype(dtype) for _ in range(2))
    g = rng.normal(size=q_shape).astype(dtype)
    return q, k, v, g


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_len", [1024, 999])
def test_plain_matches_pallas_bwd_bf16(monkeypatch, causal, kv_len):
    """bf16 operands, both sides rounding dS and P to bf16 where the TPU
    kernel does; within 3e-2 (a few bf16 ulps of the f32 sums)."""
    monkeypatch.setattr(JA, "_INTERPRET", True)
    q, k, v, g = _inputs((2, 2, 1024, 64), (2, 2, 1024, 64), seed=kv_len + causal)
    tq, tk, tv, tg = (_bf16(a) for a in (q, k, v, g))
    ref = JA._attention_bwd_pallas(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                     for t in (tq, tk, tv, tg)), kv_len, causal)
    got = A.attention_bwd_plain(tq, tk, tv, tg, kv_len, causal)
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=3e-2, rtol=3e-2)
    assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()


@pytest.mark.parametrize("sq,skv,kv_len,causal", [
    (224, 1500, 1500, False),      # teacher-forced cross-attention
    (224, 224, 224, True),         # decoder causal self-attention
    (150, 150, 150, False),
    (77, 300, 257, False),         # ragged, kv_len < Skv
    (100, 100, 90, True),
])
def test_plain_matches_xla_vjp_f32(sq, skv, kv_len, causal):
    q, k, v, g = _inputs((1, 2, sq, 64), (1, 2, skv, 64), seed=sq + skv)
    _, vjp = jax.vjp(lambda q_, k_, v_: JA._attention_xla(q_, k_, v_, kv_len, causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    got = A.attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, g)), kv_len, causal)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_fn_grad_is_the_plain_backward(dtype):
    """Through full_attention_bhsd under grad mode (AttentionFn), the forward
    is attention_plain and the gradients are attention_bwd_plain's, bit for
    bit; without grad the function takes the plain forward as before."""
    q, k, v, g = (torch.from_numpy(a).to(dtype)
                  for a in _inputs((2, 3, 40, 16), (2, 3, 56, 16), seed=3))
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = A.full_attention_bhsd(qq, kk, vv, kv_len=50, causal=False)
    assert out.grad_fn is not None
    out.backward(g)
    want = A.attention_bwd_plain(q, k, v, g, 50, False)
    for got, ref in zip((qq.grad, kk.grad, vv.grad), want):
        assert torch.equal(got, ref)
    assert torch.equal(out.detach(), A.attention_plain(q, k, v, 50, False))
    with torch.no_grad():
        assert A.full_attention_bhsd(qq, kk, vv, 50).grad_fn is None
    causal = A.full_attention_bhsd(q[:, :, :40], k[:, :, :40].requires_grad_(True),
                                   v[:, :, :40], causal=True)
    assert causal.grad_fn is not None


def test_bwd_kernel_rejects_cpu_tensors():
    q = torch.zeros((1, 1, 64, 64), dtype=torch.bfloat16)
    before = sum(A.launches_bwd.values())
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_bwd_kernel(q, q, q, q, 64, False)
    assert sum(A.launches_bwd.values()) == before
