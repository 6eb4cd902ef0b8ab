"""Port decode_step vs the JAX decode_step at B = 2, T in {1, 11}, with
per-example offsets that differ (the helpers of test_torch_megastep.py;
B = 8 is in test_torch_megastep_batch8.py).

f32 against the JAX lax.scan path (1e-4); bf16 against the JAX whole-stack
megastep kernel in interpret mode (3e-2, as tests/test_megastep.py).  Only the
rows each example's step writes, and its history, are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_megastep import _dims, _run_both
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu.ops import megastep as jmegastep


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jmegastep, "_INTERPRET", True)
    monkeypatch.setattr(jmegastep, "_ENABLED", True)
    for var in ("WM_MEGASTEP_PREFETCH", "WM_MEGASTEP_PREFETCH_CROSS", "WM_MEGASTEP_MAX_B"):
        monkeypatch.delenv(var, raising=False)


DTYPES = pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-4), (jnp.bfloat16, 3e-2)],
                                 ids=["f32", "bf16"])


def check_batched_step(offs, t, dtype, tol):
    """f32 against the JAX scan path, bf16 against the JAX megastep kernel
    (interpret mode), at per-example offsets ``offs``."""
    if dtype == jnp.bfloat16:
        assert jmegastep.available(
            jw.init_whisper_params(jax.random.PRNGKey(0), _dims(), jnp.bfloat16)
            ["decoder"]["layers"], 128, 2, len(offs), t, False, 1)
    for name, (a, c) in _run_both(dtype, t, offs).items():
        np.testing.assert_allclose(c, a, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("t", [1, 11])
@DTYPES
def test_batched_decode_step_matches_jax(t, dtype, tol):
    check_batched_step([5, 0], t, dtype, tol)
