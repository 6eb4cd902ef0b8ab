"""Plain versions of K1 and K6 at the shapes the Hopper kernels' tiles cut,
against the JAX package on the CPU.

K6: ``qmm_plain`` at M in {1, 11, 16, 176} (one row, whisper tiny's decode
rows, B=16 vanilla, B=16 Medusa) and (K, N) in {(384, 1536), (1536, 384)}
(whisper tiny's fc1 and fc2: an uneven number of 64-wide K slices and N
tiles), against the JAX ``qmm`` Pallas kernel in interpret mode and its XLA
reference ``qmm_ref``, within 1e-3 of max |y| (bf16 operands, f32 sums in
another order).

K1: ``attention_plain`` in bf16 at training's rectangular shape, 224
queries against 1536 keys with ``kv_len`` 1500 (the cross attention's 1500
frames in a 256-multiple key block), causal off and on, against the JAX
Pallas kernel in interpret mode reached through the public
``full_attention_bhsd`` (which pads q to a block multiple), within 3e-2
(bf16 rounding of the probabilities and the output), as
tests/test_torch_attention.py holds the square case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
import whisper_medusa_tpu.ops.attention as jattn
from whisper_medusa_tpu.ops import qmm as jqmm
from whisper_medusa_tpu_torch.ops import attention as tattn
from whisper_medusa_tpu_torch.ops import qmm as tqmm


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kn", [(384, 1536), (1536, 384)], ids=["fc1_384", "fc2_384"])
@pytest.mark.parametrize("m", [1, 11, 16, 176])
def test_qmm_plain_at_k6_tile_shapes(m, kn):
    k, n = kn
    rng = np.random.default_rng(1000 * m + k)
    xb = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32), jnp.bfloat16)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    wq, s = jqmm.quantize_array(jnp.asarray(w), axis=-2)
    refs = [jqmm.qmm(xb, wq, s, block_n=128, interpret=True), jqmm.qmm_ref(xb, wq, s)]
    before = tqmm.launches
    got = tqmm.qmm_plain(_t(np.asarray(xb.astype(jnp.float32))), _t(wq), _t(s))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert tqmm.launches == before
    for ref in refs:
        ref = np.asarray(ref)
        tol = 1e-3 * float(np.abs(ref).max())
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jattn, "_INTERPRET", True)
    monkeypatch.setattr(jattn, "_ENABLED", True)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_plain_rectangular_bf16(interpret_mode, causal):
    rng = np.random.default_rng(224 + causal)
    q = (rng.standard_normal((1, 2, 224, 64)) * 0.25).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 1536, 64)).astype(np.float32) for _ in range(2))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    assert jattn.kernel_available(1536)
    ref = np.asarray(jattn.full_attention_bhsd(jq, jk, jv, kv_len=1500, causal=causal),
                     np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tattn.attention_plain(tq, tk, tv, 1500, causal)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 2, 224, 64)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=3e-2, atol=3e-2)
