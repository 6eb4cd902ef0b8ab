"""Port ops/logits.py (plain version of kernel K3) vs the JAX streaming
projection kernel in interpret mode.

Both multiply bf16 values exactly and accumulate in f32, so only the
summation order differs: tolerance 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_medusa_tpu.ops import logits as jlogits
from whisper_medusa_tpu_torch.ops import logits as tlogits


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jlogits, "_INTERPRET", True)
    monkeypatch.setattr(jlogits, "_ENABLED", True)


@pytest.mark.parametrize("m", [1, 10])
@pytest.mark.parametrize("v", [8192, 8192 + 665])   # aligned + ragged vocab edge
def test_plain_matches_stream_kernel(m, v):
    rng = np.random.default_rng(m * v)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    e = (rng.standard_normal((v, 256)) * 0.02).astype(np.float32)
    assert jlogits.kernel_available(m, v, 256)
    ref = np.asarray(jlogits.project_logits_stream(jnp.asarray(x, jnp.bfloat16),
                                                   jnp.asarray(e, jnp.bfloat16)))
    got = tlogits.project_logits_stream(torch.from_numpy(x).bfloat16(),
                                        torch.from_numpy(e).bfloat16())
    assert got.dtype == torch.float32 and got.shape == (m, v)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_leading_dims_and_cpu_route():
    x = torch.randn(3, 2, 64)
    e = torch.randn(100, 64)
    before = tlogits.launches
    got = tlogits.project_logits_stream(x, e)
    assert got.shape == (3, 2, 100) and tlogits.launches == before
    torch.testing.assert_close(got, x @ e.T, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        tlogits.project_kernel(x[0].bfloat16(), e.bfloat16())
