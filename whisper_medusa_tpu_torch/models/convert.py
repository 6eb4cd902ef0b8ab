"""Reference checkpoint -> the port's parameter tree — the port's counterpart
of whisper_medusa_tpu/models/convert.py.

Converts the state dicts of HF ``WhisperForConditionalGeneration`` and of
the reference's ``WhisperMedusaModel`` checkpoints (``aiola/whisper-medusa-*``:
the backbone under ``whisper_model.``, the heads as
``medusa_heads.{h}.{l}.linear``, the Medusa-Block layer as ``medusa_block.*``,
the frozen teacher as ``whisper_layer.*``) into the tree the port shares with
the JAX package: weights (in, out), layers stacked (L, ...), heads stacked
(n_heads, n_layers, D, D).  Every value is a transpose, a stack or a cast
of a checkpoint tensor, so the tree equals the JAX converter's bit for bit.

Reads ``*.safetensors`` (preferred) or ``*.bin`` files of a checkpoint
directory; needs neither ``transformers`` nor the network.
:func:`to_reference_state_dict` is the inverse (the reference's keys and
torch layouts), with :func:`save_reference_checkpoint` writing such a
directory; they serve checks of the conversion.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict

import torch

from whisper_medusa_tpu_torch.config import MedusaConfig, ModelConfig, WhisperDims

Params = Dict[str, Any]

_ATTN = (("q_w", "q_proj.weight"), ("q_b", "q_proj.bias"), ("k_w", "k_proj.weight"),
         ("v_w", "v_proj.weight"), ("v_b", "v_proj.bias"), ("o_w", "out_proj.weight"),
         ("o_b", "out_proj.bias"))
_LNS = (("self_ln", "self_attn_layer_norm"), ("cross_ln", "encoder_attn_layer_norm"),
        ("ffn_ln", "final_layer_norm"))


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a checkpoint directory: every ``*.safetensors`` file, else every
    ``*.bin`` (``torch.load`` with ``weights_only``), on the CPU."""
    sd: Dict[str, torch.Tensor] = {}
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        from safetensors.torch import load_file

        for f in st_files:
            sd.update(load_file(f))
        return sd
    bin_files = sorted(glob.glob(os.path.join(path, "*.bin")))
    if bin_files:
        for f in bin_files:
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
        return sd
    raise FileNotFoundError(f"No .safetensors or .bin checkpoint files in {path}")


def config_from_reference(raw: dict) -> ModelConfig:
    """A ModelConfig from a reference/HF MedusaConfig ``config.json`` dict
    (the JAX ``api._config_from_hf_dict``: large-v2's values where a key is
    absent)."""
    dims = WhisperDims(
        vocab_size=raw.get("vocab_size", 51865),
        num_mel_bins=raw.get("num_mel_bins", 80),
        d_model=raw.get("d_model", 1280),
        encoder_layers=raw.get("encoder_layers", 32),
        encoder_attention_heads=raw.get("encoder_attention_heads", 20),
        decoder_layers=raw.get("decoder_layers", 32),
        decoder_attention_heads=raw.get("decoder_attention_heads", 20),
        encoder_ffn_dim=raw.get("encoder_ffn_dim", 5120),
        decoder_ffn_dim=raw.get("decoder_ffn_dim", 5120),
        max_source_positions=raw.get("max_source_positions", 1500),
        max_target_positions=raw.get("max_target_positions", 448),
    )
    n_heads = raw.get("medusa_num_heads", 10)
    medusa = MedusaConfig(
        medusa_num_heads=n_heads,
        medusa_num_layers=raw.get("medusa_num_layers", 1),
        medusa_hidden_size=raw.get("medusa_hidden_size", dims.d_model),
        medusa_choices=tuple(raw.get("medusa_choices", [1] * (n_heads + 1))),
        medusa_heads_type=raw.get("medusa_heads_type", "base_head"),
        medusa_loss_on_original=raw.get("medusa_loss_on_original", False),
        medusa_kl_loss=raw.get("medusa_kl_loss", False),
        medusa_kl_weight=raw.get("medusa_kl_weight", 0.0),
        output_whisper_original=raw.get("output_whisper_original", False),
    )
    return ModelConfig(dims=dims, medusa=medusa,
                       whisper_model_name=raw.get("whisper_model_name",
                                                  "openai/whisper-large-v2"))


class _Reader:
    """Checkpoint tensors moved to ``device`` and cast to ``dtype``, then
    laid out: a torch Linear weight (out, in) becomes (in, out)."""

    def __init__(self, sd, device, dtype):
        self.sd, self.device, self.dtype = sd, device, dtype

    def get(self, name: str) -> torch.Tensor:
        return self.sd[name].to(device=self.device, dtype=self.dtype)

    def lin(self, name: str) -> torch.Tensor:
        return self.get(name).t().contiguous()

    def layer(self, prefix: str, cross: bool) -> Params:
        """One (unstacked) HF Whisper encoder or decoder layer at ``prefix``."""
        out: Params = {}
        for key, hf in _LNS:
            if key != "cross_ln" or cross:
                out[key] = {"scale": self.get(f"{prefix}.{hf}.weight"),
                            "bias": self.get(f"{prefix}.{hf}.bias")}
        for key, hf in (("self", "self_attn"), ("cross", "encoder_attn"))[:1 + cross]:
            out[key] = {k: (self.lin if k.endswith("_w") else self.get)(f"{prefix}.{hf}.{p}")
                        for k, p in _ATTN}
        out.update(fc1_w=self.lin(f"{prefix}.fc1.weight"), fc1_b=self.get(f"{prefix}.fc1.bias"),
                   fc2_w=self.lin(f"{prefix}.fc2.weight"), fc2_b=self.get(f"{prefix}.fc2.bias"))
        return out

    def stack(self, prefix: str, n: int, cross: bool) -> Params:
        return _stack([self.layer(f"{prefix}.{i}", cross) for i in range(n)])


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def from_hf_whisper(state_dict: Dict, dims: WhisperDims, dtype=torch.float32,
                    prefix: str = "", device="cpu") -> Params:
    """An HF WhisperForConditionalGeneration state dict -> the Whisper tree."""
    sd = {k[len(prefix):] if prefix and k.startswith(prefix) else k: v
          for k, v in state_dict.items()}
    r = _Reader(sd, device, dtype)
    conv = lambda name: r.get(name).permute(2, 1, 0).contiguous()   # (out, in, k) -> (k, in, out)
    return {
        "encoder": {
            "conv1_w": conv("model.encoder.conv1.weight"),
            "conv1_b": r.get("model.encoder.conv1.bias"),
            "conv2_w": conv("model.encoder.conv2.weight"),
            "conv2_b": r.get("model.encoder.conv2.bias"),
            "pos_embed": r.get("model.encoder.embed_positions.weight"),
            "layers": r.stack("model.encoder.layers", dims.encoder_layers, cross=False),
            "ln_post": {"scale": r.get("model.encoder.layer_norm.weight"),
                        "bias": r.get("model.encoder.layer_norm.bias")},
        },
        "decoder": {
            "embed_tokens": r.get("model.decoder.embed_tokens.weight"),
            "pos_embed": r.get("model.decoder.embed_positions.weight"),
            "layers": r.stack("model.decoder.layers", dims.decoder_layers, cross=True),
            "ln_post": {"scale": r.get("model.decoder.layer_norm.weight"),
                        "bias": r.get("model.decoder.layer_norm.bias")},
        },
    }


def _n_heads(med: MedusaConfig) -> int:
    return med.medusa_num_heads + (1 if med.medusa_heads_type == "base_head" else 0)


def from_medusa_checkpoint(state_dict: Dict, config: ModelConfig, dtype=torch.float32,
                           device="cpu") -> Params:
    """A reference whisper-medusa state dict -> ``{"whisper", "medusa"}``:
    the backbone under ``whisper_model.``, the heads at
    ``medusa_heads.{h}.{l}.linear.{weight,bias}``, the block layer at
    ``medusa_block.``, the frozen teacher at ``whisper_layer.`` (when the
    checkpoint has it)."""
    whisper = from_hf_whisper(state_dict, config.dims, dtype, prefix="whisper_model.",
                              device=device)
    med = config.medusa
    r = _Reader(state_dict, device, dtype)
    heads = range(_n_heads(med))
    layers = range(med.medusa_num_layers)
    w = torch.stack([torch.stack([r.lin(f"medusa_heads.{h}.{l}.linear.weight") for l in layers])
                     for h in heads])
    b = torch.stack([torch.stack([r.get(f"medusa_heads.{h}.{l}.linear.bias") for l in layers])
                     for h in heads])
    medusa: Params = {"heads": {"w": w, "b": b}}
    if med.medusa_heads_type == "medusa_block":
        medusa["block"] = r.layer("medusa_block", cross=True)
    if any(k.startswith("whisper_layer.") for k in state_dict):
        medusa["teacher_layer"] = r.layer("whisper_layer", cross=True)
    return {"whisper": whisper, "medusa": medusa}


def load_reference(path: str, device="cpu", dtype=None):
    """(ModelConfig, params) of a reference checkpoint directory, the
    weights in ``dtype`` (default: the config's ``param_dtype``, f32)."""
    from whisper_medusa_tpu_torch.models.bridge import torch_dtype

    with open(os.path.join(path, "config.json")) as f:
        config = config_from_reference(json.load(f))
    if dtype:
        config = config.replace(param_dtype=str(dtype).replace("torch.", ""))
    params = from_medusa_checkpoint(load_state_dict(path), config,
                                    torch_dtype(config.param_dtype), device=device)
    return config, params


# ---------------------------------------------------------------------------
# The inverse: the reference's keys and layouts

def _layer_to_hf(lp: Params, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for key, hf in _LNS:
        if key in lp:
            out[f"{prefix}.{hf}.weight"] = lp[key]["scale"]
            out[f"{prefix}.{hf}.bias"] = lp[key]["bias"]
    for key, hf in (("self", "self_attn"), ("cross", "encoder_attn")):
        if key in lp:
            for k, p in _ATTN:
                v = lp[key][k]
                out[f"{prefix}.{hf}.{p}"] = v.t() if k.endswith("_w") else v
    out[f"{prefix}.fc1.weight"] = lp["fc1_w"].t()
    out[f"{prefix}.fc1.bias"] = lp["fc1_b"]
    out[f"{prefix}.fc2.weight"] = lp["fc2_w"].t()
    out[f"{prefix}.fc2.bias"] = lp["fc2_b"]


def _unstack(tree: Params, i: int) -> Params:
    return {k: _unstack(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def to_reference_state_dict(params: Params, config: ModelConfig) -> Dict[str, torch.Tensor]:
    """The reference checkpoint's state dict of ``params`` (contiguous CPU
    tensors, the params' dtype): :func:`from_medusa_checkpoint` of it gives
    ``params`` back bit for bit."""
    out: Dict[str, torch.Tensor] = {}
    wp = params["whisper"]
    enc, dec = wp["encoder"], wp["decoder"]
    pre = "whisper_model.model"
    for n in ("conv1", "conv2"):
        out[f"{pre}.encoder.{n}.weight"] = enc[f"{n}_w"].permute(2, 1, 0)
        out[f"{pre}.encoder.{n}.bias"] = enc[f"{n}_b"]
    out[f"{pre}.encoder.embed_positions.weight"] = enc["pos_embed"]
    for part, tree, n in (("encoder", enc, config.dims.encoder_layers),
                          ("decoder", dec, config.dims.decoder_layers)):
        for i in range(n):
            _layer_to_hf(_unstack(tree["layers"], i), f"{pre}.{part}.layers.{i}", out)
        out[f"{pre}.{part}.layer_norm.weight"] = tree["ln_post"]["scale"]
        out[f"{pre}.{part}.layer_norm.bias"] = tree["ln_post"]["bias"]
    out[f"{pre}.decoder.embed_tokens.weight"] = dec["embed_tokens"]
    out[f"{pre}.decoder.embed_positions.weight"] = dec["pos_embed"]
    med = params["medusa"]
    w, b = med["heads"]["w"], med["heads"]["b"]
    for h in range(w.shape[0]):
        for l in range(w.shape[1]):
            out[f"medusa_heads.{h}.{l}.linear.weight"] = w[h, l].t()
            out[f"medusa_heads.{h}.{l}.linear.bias"] = b[h, l]
    for key, prefix in (("block", "medusa_block"), ("teacher_layer", "whisper_layer")):
        if key in med:
            _layer_to_hf(med[key], prefix, out)
    return {k: v.detach().to("cpu").clone(memory_format=torch.contiguous_format)
            for k, v in out.items()}


def reference_config_dict(config: ModelConfig) -> dict:
    """The reference's (HF MedusaConfig) ``config.json`` for ``config``:
    the widths at the top level beside the Medusa fields."""
    import dataclasses

    med = dataclasses.asdict(config.medusa)
    med["medusa_choices"] = list(med["medusa_choices"])
    return {**dataclasses.asdict(config.dims), **med,
            "whisper_model_name": config.whisper_model_name}


def save_reference_checkpoint(path: str, params: Params, config: ModelConfig) -> None:
    """Write ``params`` as a reference checkpoint directory: ``config.json``
    and ``model.safetensors``."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(reference_config_dict(config), f, indent=2)
    save_file(to_reference_state_dict(params, config), os.path.join(path, "model.safetensors"))
