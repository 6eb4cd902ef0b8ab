"""The port's evaluation CLI (``cli/evaluate.py``) against the JAX package's
``evaluate_model`` on the same reference-format checkpoint and CSV.

Four synthetic 16 kHz WAVs (tones and noise of 0.6-2.9 s, one at 8 kHz so it
is resampled) and a CSV with an empty language cell, written by the test; a
reference (``aiola/whisper-medusa-*`` layout) checkpoint of a small f32
Whisper (d_model 64, one layer each side, the real 1500-position encoder,
3 Medusa heads; the embedding rows of the stand-in tokenizer's ids made
longer, so that the random model writes text) with no tokenizer files, so both CLIs decode with the
``CharTokenizer`` stand-in.  At ``--batch-size`` 1 and 4 the port gives the
JAX CLI's predictions, per-utterance WER and CER, corpus WER and CER and
mean accept length, and writes its CSV with the JAX CLI's columns.
"""

import argparse
import csv
import wave

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_convert import _write, reference_state_dict
from whisper_medusa_tpu.cli import args as jargs
from whisper_medusa_tpu.cli import evaluate as jeval
from whisper_medusa_tpu.config import MedusaConfig, ModelConfig, WhisperDims
from whisper_medusa_tpu_torch.cli import args as targs
from whisper_medusa_tpu_torch.cli import evaluate as teval


def _wav(path, x, sr):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    dims = WhisperDims(vocab_size=51865, num_mel_bins=80, d_model=64, encoder_layers=1,
                       decoder_layers=1, encoder_attention_heads=1, decoder_attention_heads=1,
                       encoder_ffn_dim=128, decoder_ffn_dim=128, max_source_positions=1500,
                       max_target_positions=64)
    cfg = ModelConfig(dims=dims, medusa=MedusaConfig(medusa_num_heads=3, medusa_hidden_size=64,
                                                     medusa_choices=(1, 1, 1, 1)))
    sd = reference_state_dict(cfg, seed=7)
    # Longer embedding rows at the stand-in tokenizer's ids (100-194), so that
    # the random model writes text it can decode.
    sd["whisper_model.model.decoder.embed_tokens.weight"][100:195] *= 6.0
    ckpt = _write(d / "ckpt", cfg, sd, "safetensors")
    rng = np.random.default_rng(0)
    rows = []
    for i, (secs, sr) in enumerate(((0.6, 16000), (1.7, 16000), (2.9, 8000), (1.1, 16000))):
        t = np.arange(int(secs * sr)) / sr
        x = 0.3 * np.sin(2 * np.pi * (200 + 150 * i) * t) + 0.05 * rng.standard_normal(t.size)
        p = d / f"{i}.wav"
        _wav(p, x, sr)
        rows.append({"audio": str(p), "sentence": ["hello there", "test one", "two", ""][i],
                     "language": ["en", "", "en", "en"][i]})
    path = d / "data.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["audio", "sentence", "language"])
        w.writeheader()
        w.writerows(rows)
    return ckpt, str(path), d


def _parse(add, argv):
    p = argparse.ArgumentParser()
    add(p)
    return p.parse_args(argv)


@pytest.mark.parametrize("batch", [1, 4])
def test_evaluate_cli_matches_jax(data, batch):
    ckpt, csv_path, d = data
    common = ["--model-name", ckpt, "--data-path", csv_path, "--batch-size", str(batch),
              "--max-length", "20", "--param-dtype", "float32"]
    jout, tout = str(d / f"j{batch}.csv"), str(d / f"t{batch}.csv")
    want = jeval.evaluate_model(_parse(jargs.add_eval_args, common + ["--out-file-path", jout]))
    got = teval.evaluate_model(_parse(targs.add_eval_args,
                                      common + ["--out-file-path", tout, "--device", "cpu"]))
    for k in ("wer", "cer", "mean_accept_length", "utterances"):
        assert got[k] == want[k], k
    assert set(got) == set(want)
    with open(jout) as f:
        jrows = list(csv.DictReader(f))
    with open(tout) as f:
        trows = list(csv.DictReader(f))
    assert list(trows[0]) == list(jrows[0]) == list(teval.OUT_FIELDS)
    assert len(trows) == 4
    for a, b in zip(trows, jrows):
        for k in ("audio", "label", "prediction", "language"):
            assert a[k] == b[k], k
        for k in ("wer", "cer"):
            assert float(a[k]) == float(b[k]), k
    assert any(r["prediction"] for r in trows)
