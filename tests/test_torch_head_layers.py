"""Medusa heads of more than one layer (``medusa_num_layers = 2``), port vs
the JAX package.

tiny_test_config(vocab_size=51865, medusa_num_heads=3) with two residual
layers a head and nonzero head weights, float32 on the CPU.  K4 takes
single-layer heads only, so the port verifies such heads in two passes at
every B (pass A: head 0 of the hidden rows through ``apply_heads``, pass B:
the draft heads at the accepted node); the JAX package scores the same rows
in one pass at B = 1 and in two at B >= 2.  Greedy tokens, lengths, steps
and accepted drafts are equal, token log-probs agree to 1e-4, at B = 1 and
3, on the chain and on the (1,2,2,1) tree (the unfused route).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _assert_same, _feats
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel as TModel


@pytest.fixture(scope="module")
def models2():
    cfg = tiny_test_config(vocab_size=51865, medusa_num_heads=3)
    cfg = cfg.replace(medusa=dataclasses.replace(cfg.medusa, medusa_num_layers=2))
    jm = JModel.from_random(cfg, seed=2)
    rng = np.random.default_rng(2)
    heads = jm.params["medusa"]["heads"]
    assert heads["w"].shape[:2] == (4, 2)
    heads["w"] = jnp.asarray(0.2 * rng.standard_normal(heads["w"].shape), jnp.float32)
    heads["b"] = jnp.asarray(0.05 * rng.standard_normal(heads["b"].shape), jnp.float32)
    tm = TModel(tconfig.ModelConfig.from_dict(cfg.to_dict()),
                bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu"),
                device="cpu")
    return jm, tm


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("choices", [None, (1, 2, 2, 1)])
def test_two_layer_heads_generate_matches_jax(models2, b, choices):
    jm, tm = models2
    f = _feats(jm.config, seed=80 + b, b=b)
    kw = dict(language="en", max_length=24, medusa_choices=choices)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    _assert_same(a, c)
    assert int(c.accepted.sum()) > 0
