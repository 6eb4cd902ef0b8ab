"""The training CLI of the port with ``--dp 2`` in a 2-process gloo world
on the CPU trains the parameters that the single-process CLI trains.

The four-utterance WAV / FLAC CSV of tests/test_torch_trainer.py and its
small model (d_model 64, 3 Medusa heads) saved as the starting checkpoint;
two AdamW steps of the Medusa heads at a global batch of 2 (one example a
data rank), an evaluation and a checkpoint at step 2.  The ranks'
``model_components/`` equal the single-process run's within 1e-5 (the
gradient sums run in another order), the frozen Whisper weights bit for
bit, and every rank returns the single-process summary.
"""

import os

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_parallel_serve import LazyWorld
from tests.test_torch_trainer import _small_config, data_csv  # noqa: F401  (the fixture)
from tests.torch_parallel_worker import start_world
from whisper_medusa_tpu_torch.cli import train as tcli
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel


def _argv(data, start, out, *extra):
    return ["--train-data-path", data, "--validation-data-path", data, "--output-path", out,
            "--whisper-model-name", start, "--batch-size", "2", "--max-steps", "2",
            "--warmup-steps", "0", "--eval-steps", "2", "--save-steps", "2",
            "--max-label-length", "24", "--optim", "adamw", "--parts-to-freeze", "whisper",
            "--lr", "1e-2", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def runs(data_csv, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("cli")
    start = str(d / "start")
    WhisperMedusaModel.from_random(_small_config(), seed=3, device="cpu").save_pretrained(start)
    world = start_world(2, "cli", {"cli": "train", "argvs": [
        _argv(data_csv, start, str(d / "dp"), "--dp", "2", "--dist-backend", "gloo")]})
    single = tcli.main(_argv(data_csv, start, str(d / "one")))
    return single, LazyWorld(world), d, start


def _params(path):
    return bridge.flatten(WhisperMedusaModel.from_pretrained(
        os.path.join(path, "model_components"), device="cpu").params)


def test_dp2_cli_trains_the_single_process_parameters(runs):
    _, world, d, start = runs
    world.results()
    one, dp, before = _params(d / "one"), _params(d / "dp"), bridge.flatten(
        WhisperMedusaModel.from_pretrained(start, device="cpu").params)
    assert set(one) == set(dp)
    for k in one:
        if k.startswith("whisper/"):
            torch.testing.assert_close(dp[k], before[k], rtol=0, atol=0, msg=k)
        else:
            np.testing.assert_allclose(dp[k].numpy(), one[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert not torch.equal(dp["medusa/heads/b"], before["medusa/heads/b"])
    assert sorted(os.listdir(d / "dp" / "checkpoints")) == ["2", "trainer_state.json"]


def test_every_rank_returns_the_single_process_summary(runs):
    single, world, _, _ = runs
    for out in world.results():
        assert out[0]["final_step"] == single["final_step"] == 2
        assert out[0]["best_eval_loss"] == pytest.approx(single["best_eval_loss"], rel=1e-5)
