"""Port ops/attention.py (plain version of kernel K1) vs the JAX attention.

bf16: the JAX Pallas kernel in interpret mode, tolerance 3e-2 (bf16 rounding
of the probabilities and the output).  f32: the JAX XLA formulation,
tolerance 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
import whisper_medusa_tpu.ops.attention as jattn
from whisper_medusa_tpu_torch.ops import attention as tattn


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jattn, "_INTERPRET", True)
    monkeypatch.setattr(jattn, "_ENABLED", True)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    return q * 0.25, k, v


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_len", [1024, 1000])
def test_plain_matches_pallas_kernel_bf16(causal, kv_len):
    q, k, v = _qkv((2, 3, 1024, 64), seed=kv_len + causal)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jattn._attention_pallas(jq, jk, jv, kv_len, causal), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tattn.full_attention_bhsd(tq, tk, tv, kv_len=kv_len, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 1024, 64)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_len", [1500, 1031])
def test_plain_matches_xla_f32(causal, kv_len):
    """Unpadded encoder length (1500) and a rectangular query block."""
    q, k, v = _qkv((1, 2, 1500, 64), seed=kv_len)
    q = q[:, :, :700]
    ref = np.asarray(jattn._attention_xla(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), kv_len, causal))
    got = tattn.full_attention_bhsd(*(torch.from_numpy(a) for a in (q, k, v)),
                                    kv_len=kv_len, causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_cpu_route_is_plain_and_kernel_rejects_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 1, 64, 64), 0))
    before = tattn.launches
    torch.testing.assert_close(tattn.full_attention_bhsd(q, k, v),
                               tattn.attention_plain(q, k, v, 64, False))
    assert tattn.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tattn.attention_kernel(q.bfloat16(), k.bfloat16(), v.bfloat16(), 64, False)
