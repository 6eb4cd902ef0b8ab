"""Weights bridge: the one place where parameters enter the port.

The port keeps the JAX package's parameter tree and layouts — weights
(in, out), transformer layers stacked (L, ...), the Medusa heads stacked
(n_heads, n_layers, D, D) — so bridging is a dtype/device conversion, never a
reshape:

  * :func:`params_from_numpy` takes the JAX pytree (``{"whisper": ...,
    "medusa": ...}``) as numpy arrays;
  * :func:`from_random` mirrors ``init_whisper_params`` and
    ``init_medusa_params`` with a ``torch.Generator`` on the target device;
  * :func:`load_checkpoint` reads the framework format (``config.json`` +
    ``params.safetensors``, keys ``whisper/decoder/layers/self/q_w``...,
    ``medusa/block/...`` for the Medusa-Block layer) or, through
    ``models/convert.py``, a reference (``aiola/whisper-medusa-*``)
    checkpoint directory; :func:`generation_metadata` reads either format's
    ``generation_config.json``.

A Medusa-Block model's ``medusa`` tree holds ``heads`` (``medusa_num_heads``
heads, all drafting) and ``block``, one unstacked decoder layer; a model
made with ``output_whisper_original`` also holds ``teacher_layer``.
:func:`flatten` gives the checkpoint's ``/``-joined keys (``save_pretrained``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from whisper_medusa_tpu_torch.config import ModelConfig
from whisper_medusa_tpu_torch.models.whisper import sinusoidal_positions

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


def resolve_device(device) -> torch.device:
    """The requested device; asking for CUDA without a GPU raises instead of
    silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False "
            "(no GPU, or a CPU-only PyTorch build); the port does not fall back "
            "to the CPU")
    return dev


def params_from_numpy(tree: Params, device="cuda", dtype=None) -> Params:
    """Nested dict of numpy arrays -> same tree of torch tensors.

    ``dtype`` casts the floating weights only: integer leaves, and both
    tensors of an int8 weight ``{"q": int8, "s": float32}`` (ops/qmm.py),
    keep their dtypes."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else None

    def conv(x, keep=False):
        if isinstance(x, dict):
            keep = set(x) == {"q", "s"}
            return {k: conv(v, keep) for k, v in x.items()}
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":           # ml_dtypes bf16 from JAX
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        cast = dt is not None and t.is_floating_point() and not keep
        return t.to(device=dev, dtype=dt if cast else t.dtype)

    return conv(tree)


def from_random(config: ModelConfig, seed: int = 0, device="cuda",
                dtype=None) -> Params:
    """Random Whisper + identity-init Medusa params on ``device``.

    Same tree, shapes and distributions as the JAX package's initializers:
    dense weights N(0, 0.02), biases zero, layernorm scales one, sinusoidal
    encoder positions; Medusa weights zero with U(-1/sqrt(D), 1/sqrt(D))
    biases.  The draws differ from jax.random's (different generators)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or config.param_dtype)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dims = config.dims
    d, ld, le = dims.d_model, dims.decoder_layers, dims.encoder_layers

    def normal(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.02).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def attn(nl):
        return {"q_w": normal(nl, d, d), "q_b": zeros(nl, d), "k_w": normal(nl, d, d),
                "v_w": normal(nl, d, d), "v_b": zeros(nl, d),
                "o_w": normal(nl, d, d), "o_b": zeros(nl, d)}

    def ln(*lead):
        return {"scale": ones(*lead, d), "bias": zeros(*lead, d)}

    def stack(nl, ffn, cross):
        layers = {"self_ln": ln(nl), "self": attn(nl)}
        if cross:
            layers.update(cross_ln=ln(nl), cross=attn(nl))
        layers.update(ffn_ln=ln(nl), fc1_w=normal(nl, d, ffn), fc1_b=zeros(nl, ffn),
                      fc2_w=normal(nl, ffn, d), fc2_b=zeros(nl, d))
        return layers

    whisper = {
        "encoder": {
            "conv1_w": normal(3, dims.num_mel_bins, d), "conv1_b": zeros(d),
            "conv2_w": normal(3, d, d), "conv2_b": zeros(d),
            "pos_embed": sinusoidal_positions(dims.max_source_positions, d,
                                              device=dev).to(dt),
            "layers": stack(le, dims.encoder_ffn_dim, cross=False),
            "ln_post": ln(),
        },
        "decoder": {
            "embed_tokens": normal(dims.vocab_size, d),
            "pos_embed": normal(dims.max_target_positions, d),
            "layers": stack(ld, dims.decoder_ffn_dim, cross=True),
            "ln_post": ln(),
        },
    }
    return {"whisper": whisper, "medusa": init_medusa_params(config, whisper, g, dt)}


def init_medusa_params(config: ModelConfig, whisper_params: Params,
                       generator: torch.Generator, dtype) -> Params:
    """Identity-init Medusa params, as the JAX ``init_medusa_params``:
    ``medusa_num_heads`` heads (+1, the base head, for ``base_head``) with
    zero weights and U(-1/sqrt(D), 1/sqrt(D)) biases drawn from
    ``generator``; for ``medusa_block`` also ``block``, a copy of the last
    decoder layer, and with ``output_whisper_original`` ``teacher_layer``,
    another such copy that training keeps frozen."""
    med = config.medusa
    d = config.dims.d_model
    if med.medusa_hidden_size != d:
        raise ValueError("medusa_hidden_size must equal d_model")
    n_heads = med.medusa_num_heads + (1 if med.medusa_heads_type == "base_head" else 0)
    dev = generator.device
    bound = 1.0 / (d ** 0.5)
    bias = (torch.rand((n_heads, med.medusa_num_layers, d), generator=generator,
                       device=dev) * (2 * bound) - bound)
    medusa = {"heads": {"w": torch.zeros((n_heads, med.medusa_num_layers, d, d),
                                         dtype=dtype, device=dev),
                        "b": bias.to(dtype)}}
    if med.medusa_heads_type == "medusa_block":
        medusa["block"] = _last_layer(whisper_params["decoder"]["layers"], dtype)
    if med.output_whisper_original:
        # The frozen teacher: the last decoder layer's original weights,
        # replayed on the penultimate hidden state for the KL target.
        medusa["teacher_layer"] = _last_layer(whisper_params["decoder"]["layers"], dtype)
    return medusa


# The block layer's output projections: they add its three residual branches.
_BLOCK_OUTPUTS = (("self", "o_w"), ("self", "o_b"), ("cross", "o_w"), ("cross", "o_b"),
                  ("fc2_w",), ("fc2_b",))


def random_block_model(model, seed: int):
    """A random Medusa-Block model on ``model``'s Whisper weights (shared,
    not copied), for driving the block path without a checkpoint: 10 heads
    with N(0, 0.02) weights and the block layer, the copy of the last decoder
    layer that :func:`init_medusa_params` makes, perturbed (weights by
    N(0, 0.02), norms and biases by N(0, 0.1)) from a generator seeded with
    ``seed``, so that it differs from that layer.  Its output projections
    are then scaled by 1/20, a stand-in chosen so that drafts get accepted:
    a random layer at full scale adds residuals as large as its input, and
    no draft from its output would ever be accepted.  It models no trained
    block."""
    import dataclasses

    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel

    cfg = model.config.replace(medusa=dataclasses.replace(
        model.config.medusa, medusa_heads_type="medusa_block"))
    g = torch.Generator(device=model.device)
    g.manual_seed(seed)
    med = init_medusa_params(cfg, model.params["whisper"], g, torch_dtype(cfg.param_dtype))
    med["heads"]["w"].normal_(0.0, 0.02, generator=g)

    def perturb(tree):
        for leaf in tree.values():
            if isinstance(leaf, dict):
                perturb(leaf)
            else:
                noise = torch.randn(leaf.shape, generator=g, device=model.device)
                leaf.add_((noise * (0.02 if leaf.dim() == 2 else 0.1)).to(leaf.dtype))

    perturb(med["block"])
    for path in _BLOCK_OUTPUTS:
        leaf = med["block"]
        for k in path:
            leaf = leaf[k]
        leaf.mul_(0.05)
    return WhisperMedusaModel(cfg, {"whisper": model.params["whisper"], "medusa": med},
                              device=model.device,
                              generation_config=model.generation_config,
                              special_tokens=model.special)


def _last_layer(stacked: Params, dtype) -> Params:
    return {k: _last_layer(v, dtype) if isinstance(v, dict) else v[-1].to(dtype).clone()
            for k, v in stacked.items()}


def flatten(tree: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested parameter dict -> {"a/b/c": tensor}, the checkpoint keys."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Params:
    tree: Params = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_checkpoint(path: str, device="cuda", dtype=None) -> Tuple[ModelConfig, Params]:
    """Read a checkpoint directory: the framework's (config.json +
    params.safetensors) or the reference's (an HF MedusaConfig config.json
    and ``*.safetensors`` / ``*.bin`` state dicts, converted by
    ``models/convert.py``)."""
    from safetensors.torch import load_file

    from whisper_medusa_tpu_torch.models import convert

    dev = resolve_device(device)
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(f"no config.json under {path}")
    with open(cfg_path) as f:
        raw = json.load(f)
    if "dims" not in raw:       # the reference's HF MedusaConfig: widths at the top level
        return convert.load_reference(path, device=dev, dtype=dtype)
    config = ModelConfig.from_dict(raw)
    if dtype:
        config = config.replace(param_dtype=str(dtype).replace("torch.", ""))
    dt = torch_dtype(config.param_dtype)
    flat = load_file(os.path.join(path, "params.safetensors"))
    params = _unflatten({k: v.to(device=dev, dtype=dt) for k, v in flat.items()})
    return config, params


def generation_metadata(path: str, config: ModelConfig) -> Tuple[Optional[Any], Optional[Any]]:
    """(GenerationConfig, SpecialTokens) from a checkpoint's
    ``generation_config.json``, or (None, None) when absent — the JAX
    ``api._load_generation_config``.  The framework's own save format
    carries ``special_tokens`` and round-trips exactly; an HF Whisper
    generation config gives the special-token layout from its ``lang_to_id``
    / ``task_to_id`` / ``no_timestamps_token_id`` / ``prev_sot_token_id``
    over the vocabulary's defaults, and its suppress lists, thresholds,
    posterior hyperparameters and decay."""
    import dataclasses

    from whisper_medusa_tpu_torch.config import (GenerationConfig, SpecialTokens,
                                                 default_begin_suppress_tokens,
                                                 default_suppress_tokens)

    p = os.path.join(path, "generation_config.json")
    if not os.path.isfile(p):
        return None, None
    with open(p) as f:
        raw = json.load(f)
    if "special_tokens" in raw:
        return GenerationConfig.from_dict(raw), SpecialTokens(**raw["special_tokens"])
    kw = {}
    if raw.get("eos_token_id") is not None:
        kw["eos"] = int(raw["eos_token_id"])
    if raw.get("decoder_start_token_id") is not None:
        kw["sot"] = int(raw["decoder_start_token_id"])
    if raw.get("lang_to_id"):
        ids = sorted(int(v) for v in raw["lang_to_id"].values())
        kw["first_language"] = ids[0]
        kw["num_languages"] = len(ids)
    for task in ("transcribe", "translate"):
        if task in (raw.get("task_to_id") or {}):
            kw[task] = int(raw["task_to_id"][task])
    if raw.get("prev_sot_token_id") is not None:
        kw["start_of_prev"] = int(raw["prev_sot_token_id"])
        kw["start_of_lm"] = int(raw["prev_sot_token_id"]) - 1
    if raw.get("no_timestamps_token_id") is not None:
        nt = int(raw["no_timestamps_token_id"])
        kw.update(no_timestamps=nt, timestamp_begin=nt + 1, no_speech=nt - 1)
    special = dataclasses.replace(config.dims.special, **kw)
    gen = dict(
        max_length=int(raw.get("max_length", config.dims.max_target_positions)),
        eos_token_id=special.eos,
        pad_token_id=(int(raw["pad_token_id"]) if raw.get("pad_token_id") is not None
                      else special.eos),
        decoder_start_token_id=special.sot,
        suppress_tokens=(tuple(raw["suppress_tokens"]) if raw.get("suppress_tokens") is not None
                         else default_suppress_tokens(special)),
        begin_suppress_tokens=(tuple(raw["begin_suppress_tokens"])
                               if raw.get("begin_suppress_tokens") is not None
                               else default_begin_suppress_tokens(special)))
    for k in ("posterior_threshold", "posterior_alpha", "temperature",
              "compression_ratio_threshold", "logprob_threshold", "no_speech_threshold"):
        if raw.get(k) is not None:
            gen[k] = float(raw[k])
    if raw.get("max_initial_timestamp_index") is not None:
        gen["max_initial_timestamp_index"] = int(raw["max_initial_timestamp_index"])
    for k in ("exponential_decay_length_penalty", "temperature_fallback"):
        if raw.get(k) is not None:
            gen[k] = tuple(raw[k])
    return GenerationConfig(**gen), special
