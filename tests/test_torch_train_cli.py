"""The port's training CLI on the CPU: ``cli.train.main`` on a CSV of WAV and
FLAC files writes ``model_components/``, which the JAX package's
``from_pretrained`` loads with equal parameters (and the port's too); a mesh wider than the world and
the wandb flag raise."""

import dataclasses
import os

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_train import flat_np
from tests.test_torch_trainer import _small_config, data_csv  # noqa: F401  (the fixture)
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JaxModel
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel


def test_cli_checkpoint_loads_in_jax(data_csv, tmp_path):
    """cli.train.main on the CPU, starting from a local checkpoint
    (``--whisper-model-name`` a directory); the parameters it trains change,
    and model_components/ loads in the JAX package's from_pretrained with
    equal parameters and in the port's."""
    from whisper_medusa_tpu_torch.cli import train as cli

    start = str(tmp_path / "start")
    WhisperMedusaModel.from_random(_small_config(), seed=2, device="cpu").save_pretrained(start)
    out = str(tmp_path / "run")
    cli.main(["--train-data-path", data_csv, "--validation-data-path", data_csv,
              "--output-path", out, "--whisper-model-name", start,
              "--batch-size", "2", "--max-steps", "2", "--warmup-steps", "0",
              "--eval-steps", "2", "--save-steps", "2", "--max-label-length", "24",
              "--optim", "adamw", "--parts-to-freeze", "whisper", "--device", "cpu"])
    path = os.path.join(out, "model_components")
    jm = JaxModel.from_pretrained(path)
    tm = WhisperMedusaModel.from_pretrained(path, device="cpu")
    ref = flat_np(jm.params)
    got = bridge.flatten(tm.params)
    assert set(ref) == set(got)
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), ref[k], err_msg=k)
    assert dataclasses.asdict(jm.config) == dataclasses.asdict(tm.config)
    assert tm.config.medusa.medusa_num_heads == 3
    before = bridge.flatten(WhisperMedusaModel.from_pretrained(start, device="cpu").params)
    assert not np.array_equal(got["medusa/heads/b"].numpy(), before["medusa/heads/b"].numpy())
    np.testing.assert_array_equal(got["whisper/decoder/embed_tokens"].numpy(),
                                  before["whisper/decoder/embed_tokens"].numpy())
    with pytest.raises(ValueError, match="needs that many processes and the world has 1"):
        cli.main(["--train-data-path", data_csv, "--validation-data-path", data_csv,
                  "--output-path", out, "--dp", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="--wandb-logging is not ported"):
        cli.main(["--train-data-path", data_csv, "--validation-data-path", data_csv,
                  "--output-path", out, "--wandb-logging", "true", "--device", "cpu"])
