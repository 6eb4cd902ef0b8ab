"""DP=2 x TP=2 ``generate`` of the port in a 4-process gloo world on the
CPU against the JAX package's (2, 2) mesh, f32 and int8: each data rank
pair serves its two examples of a batch of 4, each model rank its two
heads and half the FFN.  The model and comparisons of
test_torch_parallel_serve.py (int8 log-probs at 5e-3, as in
test_torch_parallel_int8.py).
"""

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_parallel_serve import (CFG, KW, LazyWorld, assert_same_as_jax, feats,
                                             flat_numpy, jax_model)
from tests.torch_parallel_worker import start_world
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel

FEATS = feats(CFG, 4, 5)


@pytest.fixture(scope="module")
def served():
    jm = jax_model()
    world = start_world(4, "generate", {
        "config": CFG.to_dict(), "params": flat_numpy(jm.params),
        "runs": [(2, 2, False, FEATS, KW), (2, 2, True, FEATS, KW)]})
    return jm, LazyWorld(world)


def test_dp2_tp2_generate_matches_jax_mesh(served):
    jm, world = served
    a = JModel(jm.config, jm.params).shard(dp=2, tp=2).generate(FEATS, **KW)
    assert int(np.asarray(a.accepted).sum()) > 0
    for out in world.results():
        assert_same_as_jax(a, out[0])


def test_dp2_tp2_int8_generate_matches_jax_mesh(served):
    jm, world = served
    a = JModel(jm.config, jm.params).quantize().shard(dp=2, tp=2).generate(FEATS, **KW)
    for out in world.results():
        got = out[1]
        np.testing.assert_array_equal(got["sequences"], np.asarray(a.sequences))
        np.testing.assert_array_equal(got["accepted"], np.asarray(a.accepted))
        assert got["steps"] == a.steps
        np.testing.assert_allclose(got["token_logprobs"], np.asarray(a.token_logprobs),
                                   rtol=5e-3, atol=5e-3)
