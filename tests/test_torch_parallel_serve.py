"""Data- and tensor-parallel ``generate`` of the port in a 2-process gloo
world on the CPU against the JAX package's ``shard`` on its virtual CPU mesh.

The model: 2 layers, d_model 64, 4 heads, FFN 256, vocabulary 51865, three
``base_head`` draft heads with weights drawn at 0.1 (so drafts are
accepted), f32, the JAX weights bridged into the port.  Each run shards a
fresh port model in the world (``tests/torch_parallel_worker.py``) and the
JAX model on a mesh of the same (dp, tp): DP=2 on a batch of 4 (2 + 2
examples), TP=2 (2 heads a rank), an odd batch of 3 at DP=2 (served whole
on every rank, as JAX replicates it) and a language-detecting DP=2 call.
Every rank returns the whole result; its tokens, lengths, accepted drafts,
steps and detected languages equal JAX's, token log-probs within 1e-4 (the
port's CPU tolerance against JAX, tests/test_torch_generate.py).  int8 runs
are in test_torch_parallel_int8.py, DP=2 x TP=2 in test_torch_parallel_mesh.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.torch_parallel_worker import start_world
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel
from whisper_medusa_tpu_torch.models import bridge


def parallel_config():
    cfg = tiny_test_config(vocab_size=51865, medusa_num_heads=3)
    dims = dataclasses.replace(cfg.dims, d_model=64, encoder_attention_heads=4,
                               decoder_attention_heads=4, encoder_ffn_dim=256,
                               decoder_ffn_dim=256)
    return cfg.replace(dims=dims, medusa=dataclasses.replace(cfg.medusa,
                                                             medusa_hidden_size=64))


def jax_model():
    jm = JModel.from_random(parallel_config(), seed=0)
    w = jm.params["medusa"]["heads"]["w"]
    jm.params["medusa"]["heads"]["w"] = jnp.asarray(
        0.1 * np.random.default_rng(0).standard_normal(w.shape), jnp.float32)
    return jm


def flat_numpy(params):
    return {k: v.numpy() for k, v in bridge.flatten(
        jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)).items()}


def feats(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.dims.num_mel_bins, cfg.dims.num_frames)).astype(np.float32)


class LazyWorld:
    """A world started at once, its results read on first use."""

    def __init__(self, world):
        self.world, self._out = world, None

    def results(self):
        if self._out is None:
            self._out = self.world.results()
        return self._out


def assert_same_as_jax(a, got, kw=None):
    np.testing.assert_array_equal(got["sequences"], np.asarray(a.sequences))
    np.testing.assert_array_equal(got["lengths"], np.asarray(a.lengths))
    np.testing.assert_array_equal(got["accepted"], np.asarray(a.accepted))
    np.testing.assert_array_equal(got["steps_per_example"], np.asarray(a.steps_per_example))
    assert got["steps"] == a.steps
    assert got["mean_accept_length"] == pytest.approx(a.mean_accept_length, abs=1e-9)
    assert got["detected_language"] == a.detected_language
    np.testing.assert_allclose(got["token_logprobs"], np.asarray(a.token_logprobs),
                               rtol=1e-4, atol=1e-4)


CFG = parallel_config()
KW = dict(language="en", max_length=24)
RUNS = {
    "dp2": (2, 1, feats(CFG, 4, 1), KW),
    "tp2": (1, 2, feats(CFG, 4, 1), KW),
    "dp2_odd_batch": (2, 1, feats(CFG, 3, 2), KW),
    "dp2_detect_language": (2, 1, feats(CFG, 4, 3), dict(max_new_tokens=10)),
}


@pytest.fixture(scope="module")
def served():
    jm = jax_model()
    world = start_world(2, "generate", {
        "config": CFG.to_dict(), "params": flat_numpy(jm.params),
        "runs": [(dp, tp, False, f, kw) for dp, tp, f, kw in RUNS.values()]})
    return jm, LazyWorld(world)


@pytest.mark.parametrize("name", list(RUNS))
def test_generate_matches_jax_sharded(served, name):
    jm, world = served
    dp, tp, f, kw = RUNS[name]
    a = JModel(jm.config, jm.params).shard(dp=dp, tp=tp).generate(f, **kw)
    i = list(RUNS).index(name)
    if name == "dp2":
        assert int(np.asarray(a.accepted).sum()) > 0
    for rank_out in world.results():
        assert_same_as_jax(a, rank_out[i])


def test_every_rank_returns_the_whole_result(served):
    _, world = served
    outs = world.results()
    for i, (_, _, f, _) in enumerate(RUNS.values()):
        assert outs[0][i]["sequences"].shape[0] == f.shape[0]
        for k, v in outs[0][i].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(outs[1][i][k], v, err_msg=k)
            else:
                assert outs[1][i][k] == v, k
