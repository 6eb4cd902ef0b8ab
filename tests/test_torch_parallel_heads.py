"""The same trained heads in both packages (ROADMAP item 16), on the data-
parallel path: the model of test_torch_parallel_serve.py trained three
steps from the same weights on the same global batches of 4, the JAX
trainer on a dp=2 virtual CPU mesh, the port's in a dp=2 gloo world
(``parts_to_freeze="whisper"``: the Medusa heads train, AdamW at lr 5e-3);
then each package's ``generate`` on its trained model — the port's still
sharded over its two data ranks — gives the same tokens and accepted
drafts, and the trained head weights agree within 1e-4.
"""

import jax
import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_parallel_serve import (CFG, KW, LazyWorld, feats, flat_numpy,
                                             jax_model)
from tests.test_torch_parallel_train import BATCHES
from tests.torch_parallel_worker import start_world
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel
from whisper_medusa_tpu.parallel import mesh as jmesh
from whisper_medusa_tpu.training.trainer import MedusaTrainer as JTrainer
from whisper_medusa_tpu.training.trainer import TrainingArgs as JArgs

ARGS = dict(batch_size=4, max_steps=3, eval_steps=100, save_steps=100, optim="adamw",
            parts_to_freeze="whisper", lr=5e-3, warmup_steps=0)
FEATS = feats(CFG, 4, 6)


def _iterate():
    i = 0
    while True:
        yield BATCHES[i % len(BATCHES)]
        i += 1


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    jm = jax_model()
    world = start_world(2, "train", {
        "config": CFG.to_dict(), "params": flat_numpy(jm.params), "mesh": (2, 1),
        "batches": BATCHES, "args": dict(ARGS, output_dir=str(tmp_path_factory.mktemp("p"))),
        "return_params": True, "serve": (2, 1, FEATS, KW)})
    tr = JTrainer(jm.config, jm.params, JArgs(**ARGS, output_dir=str(
        tmp_path_factory.mktemp("j"))), _iterate(), mesh=jmesh.make_mesh(2, dp=2, tp=1))
    tr.train()
    params = jax.device_get(tr.state.params)
    return JModel(jm.config, params), jm.params, LazyWorld(world)


def test_trained_heads_agree(trained):
    jtrained, start, world = trained
    w = np.asarray(jtrained.params["medusa"]["heads"]["w"])
    assert not np.allclose(w, np.asarray(start["medusa"]["heads"]["w"]))
    for out in world.results():
        np.testing.assert_allclose(out["params"]["medusa/heads/w"], w, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["params"]["medusa/heads/b"],
                                   np.asarray(jtrained.params["medusa"]["heads"]["b"]),
                                   rtol=1e-4, atol=1e-4)


def test_trained_heads_generate_the_same_tokens_and_accepts(trained):
    jtrained, _, world = trained
    a = jtrained.generate(FEATS, **KW)
    assert int(np.asarray(a.accepted).sum()) > 0
    for out in world.results():
        got = out["generate"]
        np.testing.assert_array_equal(got["sequences"], np.asarray(a.sequences))
        np.testing.assert_array_equal(got["accepted"], np.asarray(a.accepted))
        assert got["steps"] == a.steps
