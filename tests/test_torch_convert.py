"""Reference (``aiola/whisper-medusa-*``) checkpoints in the port: the converter
``models/convert.py`` against the JAX package's, and ``from_pretrained``
on such a directory.

The state dicts are built by hand from their key names and torch layouts
(Linear (out, in), Conv1d (out, in, k); no ``transformers``), seeded numpy
values, for both variants: ``base_head`` (``medusa_heads.{h}.{l}.linear``)
and ``medusa_block`` (``medusa_block.*`` and the frozen ``whisper_layer.*``).
Saved as ``model.safetensors`` and as ``pytorch_model.bin``, each loads
through the port's ``from_pretrained`` to the JAX converter's tree, bitwise;
``generate`` on it gives the JAX model's tokens, lengths, accepted drafts and
steps.  :func:`convert.to_reference_state_dict` is the converter's inverse,
bitwise.  An HF-format ``generation_config.json`` reads as the JAX
package's ``_load_generation_config`` reads it.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.models import api as japi
from whisper_medusa_tpu.models import convert as jconvert
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models import convert as tconvert
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel as TModel


def _layer(sd, rng, prefix, d, f, cross):
    def lin(name, n_out, n_in, bias=True):
        sd[f"{prefix}.{name}.weight"] = 0.05 * rng.standard_normal((n_out, n_in))
        if bias:
            sd[f"{prefix}.{name}.bias"] = 0.05 * rng.standard_normal(n_out)

    attns = ("self_attn", "encoder_attn") if cross else ("self_attn",)
    for a in attns:
        lin(f"{a}.q_proj", d, d)
        lin(f"{a}.k_proj", d, d, bias=False)
        lin(f"{a}.v_proj", d, d)
        lin(f"{a}.out_proj", d, d)
    lns = ("self_attn_layer_norm", "final_layer_norm") + (
        ("encoder_attn_layer_norm",) if cross else ())
    for ln in lns:
        sd[f"{prefix}.{ln}.weight"] = 1.0 + 0.1 * rng.standard_normal(d)
        sd[f"{prefix}.{ln}.bias"] = 0.1 * rng.standard_normal(d)
    lin("fc1", f, d)
    lin("fc2", d, f)


def reference_state_dict(cfg, seed):
    """The reference checkpoint's keys and layouts for ``cfg``, seeded
    numpy float32 values."""
    rng = np.random.default_rng(seed)
    dims, med = cfg.dims, cfg.medusa
    d = dims.d_model
    sd = {}
    p = "whisper_model.model"
    sd[f"{p}.encoder.conv1.weight"] = 0.1 * rng.standard_normal((d, dims.num_mel_bins, 3))
    sd[f"{p}.encoder.conv1.bias"] = 0.1 * rng.standard_normal(d)
    sd[f"{p}.encoder.conv2.weight"] = 0.1 * rng.standard_normal((d, d, 3))
    sd[f"{p}.encoder.conv2.bias"] = 0.1 * rng.standard_normal(d)
    sd[f"{p}.encoder.embed_positions.weight"] = 0.1 * rng.standard_normal(
        (dims.max_source_positions, d))
    for i in range(dims.encoder_layers):
        _layer(sd, rng, f"{p}.encoder.layers.{i}", d, dims.encoder_ffn_dim, cross=False)
    for i in range(dims.decoder_layers):
        _layer(sd, rng, f"{p}.decoder.layers.{i}", d, dims.decoder_ffn_dim, cross=True)
    for part in ("encoder", "decoder"):
        sd[f"{p}.{part}.layer_norm.weight"] = 1.0 + 0.1 * rng.standard_normal(d)
        sd[f"{p}.{part}.layer_norm.bias"] = 0.1 * rng.standard_normal(d)
    sd[f"{p}.decoder.embed_tokens.weight"] = 0.5 * rng.standard_normal((dims.vocab_size, d))
    sd[f"{p}.decoder.embed_positions.weight"] = 0.1 * rng.standard_normal(
        (dims.max_target_positions, d))
    n_heads = med.medusa_num_heads + (med.medusa_heads_type == "base_head")
    for h in range(n_heads):
        for l in range(med.medusa_num_layers):
            sd[f"medusa_heads.{h}.{l}.linear.weight"] = 0.02 * rng.standard_normal((d, d))
            sd[f"medusa_heads.{h}.{l}.linear.bias"] = 0.01 * rng.standard_normal(d)
    if med.medusa_heads_type == "medusa_block":
        for prefix in ("medusa_block", "whisper_layer"):
            _layer(sd, rng, prefix, d, dims.decoder_ffn_dim, cross=True)
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


def _write(path, cfg, sd, fmt):
    path.mkdir()
    raw = {**dataclasses.asdict(cfg.dims), **dataclasses.asdict(cfg.medusa),
           "whisper_model_name": "openai/whisper-large-v2"}
    with open(path / "config.json", "w") as f:
        json.dump(raw, f)
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file(sd, str(path / "model.safetensors"))
    else:
        torch.save(sd, str(path / "pytorch_model.bin"))
    return str(path)


def _flat_np(tree):
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in bridge.flatten(tree).items()}


def _jflat(tree):
    return {k: np.asarray(v) for k, v in bridge.flatten(jax.tree.map(np.asarray, tree)).items()}


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("variant", ["base_head", "medusa_block"])
def test_from_pretrained_reference_matches_jax(tmp_path, variant, fmt):
    cfg = tiny_test_config(vocab_size=51865, medusa_heads_type=variant)
    cfg = dataclasses.replace(cfg, medusa=dataclasses.replace(
        cfg.medusa, output_whisper_original=variant == "medusa_block"))
    sd = reference_state_dict(cfg, seed=3)
    path = _write(tmp_path / "ckpt", cfg, sd, fmt)
    jparams = jconvert.from_medusa_checkpoint({k: v.numpy() for k, v in sd.items()}, cfg)
    tm = TModel.from_pretrained(path, device="cpu")
    assert tm.config.to_dict() == japi._config_from_hf_dict(
        json.load(open(f"{path}/config.json"))).to_dict()
    got, want = _flat_np(tm.params), _jflat(jparams)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if variant == "medusa_block":
        assert {"block", "teacher_layer"} <= set(tm.params["medusa"])
    # The inverse gives the checkpoint's tensors back, bit for bit.
    back = tconvert.to_reference_state_dict(tm.params, tm.config)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)

    jm = japi.WhisperMedusaModel.from_pretrained(path)
    f = np.random.default_rng(5).standard_normal(
        (1, cfg.dims.num_mel_bins, cfg.dims.num_frames)).astype(np.float32)
    a, b = jm.generate(f, language="en", max_length=24), tm.generate(f, language="en",
                                                                     max_length=24)
    np.testing.assert_array_equal(b.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(b.lengths, np.asarray(a.lengths))
    np.testing.assert_array_equal(b.accepted, np.asarray(a.accepted))
    assert b.steps == a.steps


def test_from_pretrained_reference_in_bf16(tmp_path):
    """``dtype="bfloat16"`` casts every weight as JAX's converter does."""
    cfg = tiny_test_config()
    sd = reference_state_dict(cfg, seed=4)
    path = _write(tmp_path / "ckpt", cfg, sd, "safetensors")
    tm = TModel.from_pretrained(path, device="cpu", dtype="bfloat16")
    jparams = jconvert.from_medusa_checkpoint({k: v.numpy() for k, v in sd.items()}, cfg,
                                              jnp.bfloat16)
    want = _jflat(jparams)
    got = bridge.flatten(tm.params)
    for k, v in want.items():
        assert got[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(got[k].float().numpy(), v.astype(np.float32), err_msg=k)


HF_GEN = {"eos_token_id": 50257, "decoder_start_token_id": 50258, "pad_token_id": 50257,
          "max_length": 448, "suppress_tokens": [1, 2, 7, 8, 9, 10, 14, 25],
          "begin_suppress_tokens": [220, 50257], "no_timestamps_token_id": 50363,
          "prev_sot_token_id": 50361, "lang_to_id": {"<|en|>": 50259, "<|de|>": 50261,
                                                     "<|zh|>": 50260},
          "task_to_id": {"transcribe": 50359, "translate": 50358},
          "posterior_threshold": 0.05, "posterior_alpha": 0.2,
          "exponential_decay_length_penalty": [140, 1.05], "max_initial_timestamp_index": 1,
          "alignment_heads": [[1, 0], [2, 3]], "is_multilingual": True}


@pytest.mark.parametrize("raw", [HF_GEN, {"eos_token_id": 50257, "max_length": 200},
                                 {"no_timestamps_token_id": 50364,
                                  "temperature_fallback": [0.0, 0.2],
                                  "logprob_threshold": -1.0}],
                         ids=["hf-full", "hf-minimal", "hf-v3-ts"])
def test_hf_generation_config_matches_jax(tmp_path, raw):
    cfg = tiny_test_config(vocab_size=51865)
    with open(tmp_path / "generation_config.json", "w") as f:
        json.dump(raw, f)
    jgen, jspecial = japi._load_generation_config(str(tmp_path), cfg)
    tcfg = tconvert.config_from_reference({**dataclasses.asdict(cfg.dims),
                                           **dataclasses.asdict(cfg.medusa)})
    tgen, tspecial = bridge.generation_metadata(str(tmp_path), tcfg)
    assert dataclasses.asdict(tspecial) == dataclasses.asdict(jspecial)
    assert dataclasses.asdict(tgen) == dataclasses.asdict(jgen)
