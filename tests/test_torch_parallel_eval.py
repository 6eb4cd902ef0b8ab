"""The evaluation CLI of the port with ``--dp 2`` in a 2-process gloo world
on the CPU writes the rows that the single-process CLI writes.

The reference-format checkpoint, the four synthetic WAVs and the CSV of
tests/test_torch_evaluate.py.  At ``--batch-size 4`` each data rank
decodes two utterances of the one batch; at ``--batch-size 3`` neither
batch (3, then 1) divides by dp, so both ranks decode each whole, as the
JAX package replicates such a batch.  The primary rank's CSV equals the
single-process CSV cell for cell, and every rank returns the same summary
(WER, CER, mean accept length, utterances).
"""

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_evaluate import data  # noqa: F401  (the fixture)
from tests.test_torch_parallel_serve import LazyWorld
from tests.torch_parallel_worker import start_world
from whisper_medusa_tpu_torch.cli import evaluate as teval

BATCHES = (4, 3)


def _argv(ckpt, csv_path, out, batch, *extra):
    return ["--model-name", ckpt, "--data-path", csv_path, "--out-file-path", out,
            "--batch-size", str(batch), "--max-length", "20", "--param-dtype", "float32",
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def runs(data):  # noqa: F811
    ckpt, csv_path, d = data
    world = start_world(2, "cli", {"cli": "evaluate", "argvs": [
        _argv(ckpt, csv_path, str(d / f"dp{b}.csv"), b, "--dp", "2", "--dist-backend", "gloo")
        for b in BATCHES]})
    single = {b: teval.main(_argv(ckpt, csv_path, str(d / f"one{b}.csv"), b)) for b in BATCHES}
    return single, LazyWorld(world), d


@pytest.mark.parametrize("batch", BATCHES)
def test_dp2_cli_writes_the_single_process_rows(runs, batch):
    single, world, d = runs
    world.results()
    with open(d / f"one{batch}.csv") as f:
        ref = f.read()
    with open(d / f"dp{batch}.csv") as f:
        assert f.read() == ref
    assert len(ref.splitlines()) == 5


@pytest.mark.parametrize("batch", BATCHES)
def test_every_rank_returns_the_single_process_summary(runs, batch):
    single, world, _ = runs
    keys = ("wer", "cer", "mean_accept_length", "utterances")
    for out in world.results():
        got = out[BATCHES.index(batch)]
        assert {k: got[k] for k in keys} == {k: single[batch][k] for k in keys}
