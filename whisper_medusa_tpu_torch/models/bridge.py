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
    ``params.safetensors``, keys ``whisper/decoder/layers/self/q_w``...).
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
    med = config.medusa
    if med.medusa_heads_type != "base_head":
        raise NotImplementedError("medusa_block is not ported yet "
                                  "(ROADMAP queue 1: medusa_block variant)")
    if med.medusa_hidden_size != d:
        raise ValueError("medusa_hidden_size must equal d_model")
    n_heads = med.medusa_num_heads + 1
    bound = 1.0 / (d ** 0.5)
    bias = (torch.rand((n_heads, med.medusa_num_layers, d), generator=g, device=dev)
            * (2 * bound) - bound)
    medusa = {"heads": {"w": zeros(n_heads, med.medusa_num_layers, d, d),
                        "b": bias.to(dt)}}
    return {"whisper": whisper, "medusa": medusa}


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
    """Read a framework checkpoint directory (config.json + params.safetensors)."""
    from safetensors.torch import load_file

    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    if "dims" not in raw:
        raise NotImplementedError(
            "only the framework's own checkpoint format is ported; reference "
            "torch checkpoints wait for the converter (ROADMAP queue 1)")
    config = ModelConfig.from_dict(raw)
    if dtype:
        config = config.replace(param_dtype=str(dtype).replace("torch.", ""))
    dt = torch_dtype(config.param_dtype)
    flat = load_file(os.path.join(path, "params.safetensors"))
    params = _unflatten({k: v.to(device=dev, dtype=dt) for k, v in flat.items()})
    return config, params


def generation_metadata(path: str, config: ModelConfig) -> Tuple[Optional[Any], Optional[Any]]:
    """(GenerationConfig, SpecialTokens) from a checkpoint's
    ``generation_config.json`` in the framework's own save format, or
    (None, None) when absent."""
    from whisper_medusa_tpu_torch.config import GenerationConfig, SpecialTokens

    p = os.path.join(path, "generation_config.json")
    if not os.path.isfile(p):
        return None, None
    with open(p) as f:
        raw = json.load(f)
    if "special_tokens" not in raw:
        raise NotImplementedError(
            "HF-format generation_config.json is not ported yet (ROADMAP queue 1)")
    return GenerationConfig.from_dict(raw), SpecialTokens(**raw["special_tokens"])
