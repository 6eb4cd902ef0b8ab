"""The port's ``utils/profiling.py`` and ``utils/logging_utils.py``:
``decode_report`` equals the JAX package's on the same counts; ``trace``
writes a Chrome trace of CPU work;
``megastep_chain_ms`` times K2 on the card only and refuses CPU tensors;
``set_seed`` seeds torch, numpy and ``random``; ``count_parameters`` counts a
tensor tree's elements as the JAX helper counts the same tree's leaves;
``make_wandb_logger`` raises, as ``--wandb-logging`` does."""

import json
import random

import jax
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.utils import logging_utils as jlog
from whisper_medusa_tpu.utils import profiling as jprof
from whisper_medusa_tpu_torch.config import WhisperDims
from whisper_medusa_tpu_torch.utils import logging_utils as tlog
from whisper_medusa_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("new,steps,acc,wall", [(128, 30, 97, 0.5), (0, 0, 0, 0.0),
                                                (1024, 93, 931, 2.25)])
def test_decode_report_matches_jax(new, steps, acc, wall):
    assert tprof.decode_report(new, steps, acc, wall) == jprof.decode_report(new, steps, acc,
                                                                             wall)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_megastep_chain_ms_refuses_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        tprof.megastep_chain_ms({}, WhisperDims(), torch.zeros((1, 4, 8)), 11)


def test_logging_utils():
    tlog.set_seed(7)
    a = (random.random(), np.random.rand(), torch.rand(1).item())
    tlog.set_seed(7)
    assert a == (random.random(), np.random.rand(), torch.rand(1).item())
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((3, 4)), "b": rng.standard_normal(4)},
            "q": {"q": rng.integers(-5, 5, (2, 6)), "s": rng.standard_normal(6)}}
    ttree = jax.tree.map(torch.from_numpy, tree)
    assert tlog.count_parameters(ttree) == jlog.count_parameters(tree) == 12 + 4 + 12 + 6
    with pytest.raises(NotImplementedError, match="--wandb-logging is not ported"):
        tlog.make_wandb_logger("project")
