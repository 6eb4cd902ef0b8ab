"""``MedusaTrainer(mesh=)`` of the port in a 4-process gloo world (DP=2 x
TP=2) on the CPU against the JAX trainer on its (2, 2) virtual CPU mesh.

A full fine-tune (every leaf trained, so the sharded q/k/v/o and FFN
weights take their gradients through the model group's collectives) of
the model of test_torch_parallel_serve.py, AdamW at lr 1e-3, three steps
over two global batches of 4 whose ``-100`` padding differs by row: the
two data ranks hold 13 and 19 supervised tokens of the first batch, so a
mean of the ranks' means would not be JAX's loss.  Each step's loss is
within rtol 1e-4 of JAX's (the port-against-JAX tolerance of
tests/test_torch_trainer.py), on every rank; the ranks' final parameters
are equal; and a batch size that dp does not divide raises JAX's error.
"""

import os

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_parallel_serve import CFG, LazyWorld, flat_numpy, jax_model
from tests.torch_parallel_worker import start_world
from whisper_medusa_tpu.parallel import mesh as jmesh
from whisper_medusa_tpu.training.trainer import MedusaTrainer as JTrainer
from whisper_medusa_tpu.training.trainer import TrainingArgs as JArgs
from whisper_medusa_tpu_torch.training.trainer import MedusaTrainer, TrainingArgs


def _batch(seed, cut):
    r = np.random.default_rng(seed)
    labels = r.integers(6, 500, size=(4, 12)).astype(np.int32)
    for row, at in enumerate(cut):
        labels[row, at:] = -100
    return {"input_features": r.standard_normal(
        (4, CFG.dims.num_mel_bins, CFG.dims.num_frames)).astype(np.float32),
        "labels": labels}


BATCHES = [_batch(1, (9, 4, 12, 7)), _batch(2, (12, 12, 3, 6))]
ARGS = dict(batch_size=4, max_steps=3, eval_steps=100, save_steps=100, optim="adamw",
            parts_to_freeze=None, lr=1e-3, warmup_steps=0)


def _iterate():
    i = 0
    while True:
        yield BATCHES[i % len(BATCHES)]
        i += 1


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    jm = jax_model()
    out = str(tmp_path_factory.mktemp("port"))
    world = start_world(4, "train", {
        "config": CFG.to_dict(), "params": flat_numpy(jm.params), "mesh": (2, 2),
        "batches": BATCHES, "args": dict(ARGS, output_dir=out), "return_params": True})
    return jm, LazyWorld(world), tmp_path_factory


def test_uneven_padding_splits_tokens_unevenly():
    sup = [(b["labels"][:, 1:] != -100).sum(axis=1) for b in BATCHES]
    assert sup[0][:2].sum() != sup[0][2:].sum()


def test_mesh_trainer_loss_matches_jax_mesh(trained):
    jm, world, tmp = trained
    tr = JTrainer(jm.config, jm.params, JArgs(**ARGS, output_dir=str(tmp.mktemp("jax"))),
                  _iterate(), mesh=jmesh.make_mesh(4, dp=2, tp=2))
    tr.train()
    ref = [s["loss"] for _, s in tr.history]
    assert len(ref) == 3 and ref[0] != ref[2]
    for out in world.results():
        got = [s["loss"] for _, s in out["history"]]
        np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_ranks_keep_the_same_parameters(trained):
    _, world, _ = trained
    outs = world.results()
    for out in outs[1:]:
        for k, v in outs[0]["params"].items():
            np.testing.assert_array_equal(out["params"][k], v, err_msg=k)


def test_batch_that_dp_does_not_divide_raises(tmp_path):
    """JAX's check (trainer.py:81-84), before any collective."""
    from whisper_medusa_tpu_torch.parallel import mesh as tmesh

    class _Params(dict):
        pass

    args = TrainingArgs(output_dir=str(tmp_path), batch_size=3)
    with pytest.raises(ValueError, match="batch_size 3 must divide by dp=2"):
        MedusaTrainer(None, _Params(), args, iter(()),
                      mesh=tmesh.Mesh(np.arange(2).reshape(2, 1), 0, 0))
    assert not os.listdir(tmp_path)
