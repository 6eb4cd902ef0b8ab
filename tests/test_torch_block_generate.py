"""Medusa-Block serving as a whole: the port's ``generate`` on a
``medusa_block`` model vs the JAX package's on the same weights.

tiny_test_config(vocab_size=51865, medusa_num_heads=3,
medusa_heads_type="medusa_block"), float32 on the CPU, with nonzero head
weights and the block layer perturbed away from the last decoder layer (so
that a path which read the last layer, or its cache slot, would differ).
B=1 (one fused pass with identity0 rows), B=2 (two passes: the hidden rows,
then the heads at the accepted node's block output), vanilla decoding of the
block model, and int8 at B=1 on each side's ``quantize()``: tokens, lengths,
accepted drafts and steps are equal; token log-probs agree to 1e-4 (f32)
and 5e-3 (int8, the bar of test_torch_int8_generate.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _assert_same, _feats, _leaves
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel as TModel


@pytest.fixture(scope="module")
def block_models():
    cfg = tiny_test_config(vocab_size=51865, medusa_num_heads=3,
                           medusa_heads_type="medusa_block")
    jm = JModel.from_random(cfg, seed=0)
    rng = np.random.default_rng(0)
    med = jm.params["medusa"]
    med["heads"]["w"] = jnp.asarray(0.1 * rng.standard_normal(med["heads"]["w"].shape),
                                    jnp.float32)
    med["block"] = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + (0.05 if a.ndim < 2 else 0.02)
                              * rng.standard_normal(a.shape), jnp.float32),
        med["block"])
    tm = TModel(tconfig.ModelConfig.from_dict(cfg.to_dict()),
                bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu"),
                device="cpu")
    return jm, tm


def test_block_params_bridge(block_models):
    jm, tm = block_models
    med = tm.params["medusa"]
    assert med["heads"]["w"].shape == (3, 1, 32, 32)        # K heads, no base head
    assert med["block"]["fc1_w"].shape == (32, 64)          # one unstacked layer
    last = tm.params["whisper"]["decoder"]["layers"]["fc1_w"][-1]
    assert not torch.equal(med["block"]["fc1_w"], last)


@pytest.mark.parametrize("b,disable_medusa", [(1, False), (2, False), (1, True)],
                         ids=["B1", "B2-two-pass", "vanilla"])
def test_block_generate_matches_jax(block_models, b, disable_medusa):
    jm, tm = block_models
    f = _feats(jm.config, seed=10 + b, b=b)
    kw = dict(language="en", max_length=24, disable_medusa=disable_medusa)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    if not disable_medusa:
        assert int(np.asarray(a.accepted).sum()) > 0
    _assert_same(a, c)


def test_block_int8_generate_matches_jax(block_models):
    jm, tm = block_models
    jq, tq = jm.quantize(), tm.quantize()
    assert tq.params["medusa"]["block"]["fc1_w"]["q"].dtype == torch.int8
    f = _feats(jm.config, seed=13)
    kw = dict(language="en", max_length=24)
    a, c = jq.generate(f, **kw), tq.generate(f, **kw)
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(c.lengths, np.asarray(a.lengths))
    np.testing.assert_array_equal(c.accepted, np.asarray(a.accepted))
    assert c.steps == a.steps and int(c.accepted.sum()) > 0
    np.testing.assert_allclose(c.token_logprobs, a.token_logprobs, rtol=0, atol=5e-3)
    # A second quantize() keeps every int8 weight as it is.
    for (k, x), (_, y) in zip(_leaves(tq.quantize().params), _leaves(tq.params)):
        assert x is y, k


def test_block_from_pretrained(block_models, tmp_path):
    jm, tm = block_models
    jm.save_pretrained(str(tmp_path))
    loaded = TModel.from_pretrained(str(tmp_path), device="cpu")
    assert loaded.config.medusa.medusa_heads_type == "medusa_block"
    for (k, a), (_, b) in zip(_leaves(loaded.params), _leaves(tm.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    f = _feats(tm.config, seed=14)
    kw = dict(language="en", max_length=20)
    np.testing.assert_array_equal(loaded.generate(f, **kw).sequences,
                                  np.asarray(jm.generate(f, **kw).sequences))


def test_block_from_random_mirrors_jax_init():
    """from_random on a medusa_block config: K heads with zero weights and
    the block a copy of the last decoder layer, as the JAX initializer."""
    cfg = tconfig.tiny_test_config(medusa_heads_type="medusa_block")
    tm = TModel.from_random(cfg, device="cpu")
    med, layers = tm.params["medusa"], tm.params["whisper"]["decoder"]["layers"]
    assert med["heads"]["w"].shape[0] == cfg.medusa.medusa_num_heads
    assert not med["heads"]["w"].any()
    for (k, a), (_, b) in zip(_leaves(med["block"]), _leaves(_last(layers))):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert med["block"]["fc1_w"].data_ptr() != layers["fc1_w"][-1].data_ptr()
    # output_whisper_original (training's frozen teacher) adds teacher_layer,
    # another copy of the last decoder layer, as the JAX initializer does.
    tt = TModel.from_random(tconfig.ModelConfig(
        dims=cfg.dims, medusa=tconfig.MedusaConfig(
            medusa_num_heads=3, medusa_hidden_size=32,
            medusa_choices=(1, 1, 1, 1), output_whisper_original=True)), device="cpu")
    teacher, tlayers = tt.params["medusa"]["teacher_layer"], tt.params["whisper"]["decoder"]["layers"]
    for (k, a), (_, b) in zip(_leaves(teacher), _leaves(_last(tlayers))):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def _last(tree):
    return {k: _last(v) if isinstance(v, dict) else v[-1] for k, v in tree.items()}
