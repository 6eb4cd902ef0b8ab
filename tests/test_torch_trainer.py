"""The port's training loop: three train steps against the JAX package's
jitted step (parameters at 1e-4), the trainer on a CSV of WAV and FLAC files
(eval, checkpoint rotation, a resumed run equal to an uninterrupted one),
the data layer against the JAX package's, and the teacher layer through
save_pretrained / from_pretrained.  The CLI is in test_torch_train_cli.py."""

import csv
import dataclasses
import os
import sys
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.data import dataset as JD
from whisper_medusa_tpu.training import train as JT
from whisper_medusa_tpu_torch.config import MedusaConfig, ModelConfig, WhisperDims
from whisper_medusa_tpu_torch.data import dataset as TD
from whisper_medusa_tpu_torch.data.tokenizer import CharTokenizer
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel
from whisper_medusa_tpu_torch.training import train as TT
from whisper_medusa_tpu_torch.training.trainer import MedusaTrainer, TrainingArgs

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from flac_encoder import encode_flac  # noqa: E402
from tests.test_torch_train import batch, configs, flat_np, param_tree  # noqa: E402


@pytest.mark.parametrize("variant,policy,opt", [("base_head", "all_but_last", "adafactor"),
                                                ("medusa_block", "whisper", "adamw")])
def test_three_steps_match_jax(variant, policy, opt):
    jc, tc = configs(variant)
    tree = param_tree(jc, seed=4)
    feats, labels = batch(jc.dims, seed=3)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=6, schedule="linear")
    jopt = JT.make_optimizer(opt, **kw)
    jstep = jax.jit(JT.make_train_step(jc, jopt, policy))
    jstate = JT.init_train_state(jax.tree.map(jnp.asarray, tree), jopt)
    topt = TT.make_optimizer(opt, **kw)
    tstate = TT.init_train_state(bridge.params_from_numpy(tree, device="cpu"), topt)
    tstep = TT.make_train_step(tc, topt, policy)
    for _ in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(feats), jnp.asarray(labels))
        tstate, tm = tstep(tstate, feats, labels)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
    ref = flat_np(jstate.params)
    got = bridge.flatten(tstate.params)
    assert set(ref) == set(got) and tstate.step == 3
    for k, t in got.items():
        np.testing.assert_allclose(t.numpy(), ref[k], rtol=1e-4, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# Data, trainer and CLI on real audio files
# ---------------------------------------------------------------------------

def _tone(i, secs=0.5, sr=16000):
    t = np.arange(int(sr * secs)) / sr
    return (0.25 * np.sin(2 * np.pi * (220 + 110 * i) * t) * 32767).astype(np.int16)


@pytest.fixture(scope="module")
def data_csv(tmp_path_factory):
    """Four utterances, two WAV and two FLAC (the FLAC pair at 8 kHz, so the
    resampler runs too)."""
    d = tmp_path_factory.mktemp("data")
    rows = []
    for i, text in enumerate(["hello there", "test one", "two", "three four"]):
        if i % 2 == 0:
            path = d / f"{i}.wav"
            with wave.open(str(path), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(_tone(i).tobytes())
        else:
            path = d / f"{i}.flac"
            path.write_bytes(encode_flac(_tone(i, sr=8000)[None], 8000))
        rows.append({"audio": str(path), "sentence": text, "language": "en"})
    path = d / "data.csv"
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["audio", "sentence", "language"])
        writer.writeheader()
        writer.writerows(rows)
    return str(path)


def test_collated_batch_matches_jax(data_csv):
    tok = CharTokenizer()
    got = TD.SpeechCollator(max_label_length=24, device="cpu")(
        [TD.ASRDataSet(data_csv, tok)[i] for i in range(4)])
    ref = JD.SpeechCollator(max_label_length=24)(
        [JD.get_dataset(data_csv, tok)[i] for i in range(4)])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["input_features"], ref["input_features"], atol=1e-3)


def _small_config(variant="base_head"):
    """Real-shaped inputs (80 mels, 3000 frames, the full vocabulary) at a
    width the CPU trains in seconds."""
    dims = WhisperDims(d_model=64, encoder_layers=1, decoder_layers=2,
                       encoder_attention_heads=1, decoder_attention_heads=1,
                       encoder_ffn_dim=128, decoder_ffn_dim=128)
    return ModelConfig(dims=dims, medusa=MedusaConfig(
        medusa_num_heads=3, medusa_hidden_size=64, medusa_choices=(1, 1, 1, 1),
        medusa_heads_type=variant))


def _trainer(cfg, data_csv, out, max_steps):
    params = bridge.from_random(cfg, seed=0, device="cpu")
    ds = TD.ASRDataSet(data_csv, CharTokenizer())
    coll = TD.SpeechCollator(max_label_length=24, device="cpu")
    args = TrainingArgs(output_dir=out, batch_size=4, lr=1e-2, warmup_steps=1,
                        max_steps=max_steps, eval_steps=2, save_steps=1, save_total_limit=2,
                        parts_to_freeze="all_but_last", load_best_model_at_end=False,
                        eval_batches=1)
    return MedusaTrainer(cfg, params, args, TD.batches(ds, coll, 4, shuffle=False),
                         eval_iter_fn=lambda: TD.batches(ds, coll, 4, shuffle=False),
                         log_fn=lambda scalars, step: None)


def test_trainer_resume_equals_uninterrupted(data_csv, tmp_path):
    cfg = _small_config()
    full = _trainer(cfg, data_csv, str(tmp_path / "full"), 3)
    summary = full.train()
    assert summary["final_step"] == 3 and np.isfinite(summary["best_eval_loss"])
    logged = dict(full.history)
    assert {"loss", "step_time", "MedusaHead_0_loss", "MedusaHead_2_loss"} <= set(logged[1])
    assert "eval_validation_loss" in full.history[2][1]
    ckpt = tmp_path / "full" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["2", "3", "trainer_state.json"]

    first = _trainer(cfg, data_csv, str(tmp_path / "resumed"), 2)
    first.train()
    resumed = _trainer(cfg, data_csv, str(tmp_path / "resumed"), 3)
    assert resumed.train(resume_from_checkpoint=True)["final_step"] == 3
    want = bridge.flatten(full.state.params)
    for k, t in bridge.flatten(resumed.state.params).items():
        assert torch.equal(t, want[k]), k
    assert full.history[-1][1]["loss"] == resumed.history[-1][1]["loss"]


def test_teacher_layer_round_trips(tmp_path):
    """output_whisper_original makes teacher_layer, a copy of the last
    decoder layer; save_pretrained / from_pretrained carry it."""
    cfg = _small_config()
    cfg = cfg.replace(medusa=dataclasses.replace(cfg.medusa, output_whisper_original=True))
    model = WhisperMedusaModel.from_random(cfg, seed=1, device="cpu")
    teacher = model.params["medusa"]["teacher_layer"]
    last = bridge.flatten(model.params["whisper"]["decoder"]["layers"])
    for k, t in bridge.flatten(teacher).items():
        assert torch.equal(t, last[k][-1])
    model.save_pretrained(str(tmp_path))
    again = WhisperMedusaModel.from_pretrained(str(tmp_path), device="cpu")
    for k, t in bridge.flatten(again.params["medusa"]["teacher_layer"]).items():
        assert torch.equal(t, bridge.flatten(teacher)[k])
