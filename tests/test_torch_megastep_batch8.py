"""Port decode_step vs the JAX decode_step at B = 8 — the largest batch either
megastep kernel takes — at T in {1, 11} with per-example offsets that differ.
f32 against the JAX scan path (1e-4), bf16 against the JAX megastep kernel in
interpret mode (3e-2)."""

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_megastep_batch import DTYPES, check_batched_step, interpret_mode  # noqa: F401


@pytest.mark.parametrize("t", [1, 11])
@DTYPES
def test_batch8_decode_step_matches_jax(t, dtype, tol):
    check_batched_step([3, 0, 7, 1, 6, 2, 5, 4], t, dtype, tol)
