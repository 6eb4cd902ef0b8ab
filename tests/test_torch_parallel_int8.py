"""int8 serving (``quantize()`` then ``shard``) at DP=2 and TP=2 in a
2-process gloo world on the CPU against the JAX package's quantized model
on its virtual CPU mesh: the column-parallel q/k/v / fc1 cut their
per-output-channel scales, o / fc2 keep theirs whole, the int8 cross K/V
scales follow this rank's heads.  The model and comparisons of
test_torch_parallel_serve.py; token log-probs within 5e-3, the port's
int8 tolerance against JAX's jitted int8 generate
(tests/test_torch_int8_generate.py).
"""

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_parallel_serve import (CFG, KW, LazyWorld, feats, flat_numpy,
                                             jax_model)
from tests.torch_parallel_worker import start_world
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel

RUNS = {"dp2": (2, 1, feats(CFG, 4, 1), KW), "tp2": (1, 2, feats(CFG, 2, 4), KW)}


@pytest.fixture(scope="module")
def served():
    jm = jax_model()
    world = start_world(2, "generate", {
        "config": CFG.to_dict(), "params": flat_numpy(jm.params),
        "runs": [(dp, tp, True, f, kw) for dp, tp, f, kw in RUNS.values()]})
    return jm, LazyWorld(world)


@pytest.mark.parametrize("name", list(RUNS))
def test_int8_generate_matches_jax_sharded(served, name):
    jm, world = served
    dp, tp, f, kw = RUNS[name]
    a = JModel(jm.config, jm.params).quantize().shard(dp=dp, tp=tp).generate(f, **kw)
    i = list(RUNS).index(name)
    for got in (out[i] for out in world.results()):
        np.testing.assert_array_equal(got["sequences"], np.asarray(a.sequences))
        np.testing.assert_array_equal(got["lengths"], np.asarray(a.lengths))
        np.testing.assert_array_equal(got["accepted"], np.asarray(a.accepted))
        assert got["steps"] == a.steps
        np.testing.assert_allclose(got["token_logprobs"], np.asarray(a.token_logprobs),
                                   rtol=5e-3, atol=5e-3)
