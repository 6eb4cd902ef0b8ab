"""Public model API — counterpart of whisper_medusa_tpu/models/api.py.

``WhisperMedusaModel`` with ``from_random``, ``from_pretrained``, ``encode``,
``detect_language`` and ``generate`` for the shortform, single-temperature,
greedy path of both Medusa variants (``base_head``, and ``medusa_block``,
chosen by ``config.medusa.medusa_heads_type``) and vanilla decoding
(``disable_medusa=True``) at any batch size: ``language`` given (one code, or
one per example) or detected per example, ``max_length`` /
``max_new_tokens``, the suppress lists, the exponential decay length penalty
and the no-speech probability.  Every other option of the JAX ``generate``
raises NotImplementedError naming its ROADMAP item.  ``quantize()`` gives
the int8 serving copy (W8A16 decoder, embedding, heads and Medusa-Block
layer; int8 caches).  Everything runs on the card unless the model was made
with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from whisper_medusa_tpu_torch.config import (GenerationConfig, ModelConfig, SpecialTokens,
                                       default_begin_suppress_tokens,
                                       default_suppress_tokens, language_token_id)
from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig
from whisper_medusa_tpu_torch.decoding.speculative import speculative_generate
from whisper_medusa_tpu_torch.models import bridge, whisper


@dataclasses.dataclass
class GenerateOutput:
    sequences: np.ndarray          # (B, max_length) int32, EOS backfilled
    lengths: np.ndarray            # (B,)
    steps: int                     # decoder loop iterations
    accepted: np.ndarray           # (B,) accepted draft tokens
    mean_accept_length: float      # accepted drafts per step
    detected_language: Optional[List[str]] = None
    no_speech_probs: Optional[np.ndarray] = None   # (B,) prob of <|nospeech|>
    token_logprobs: Optional[np.ndarray] = None    # (B, max_length)
    avg_logprobs: Optional[np.ndarray] = None      # (B,)
    steps_per_example: Optional[np.ndarray] = None  # (B,)


# generate() options of the JAX package that this slice does not run: the
# default (accepted, a no-op) and the ROADMAP queue-1 item that brings it.
_TIMESTAMPS = "timestamps + longform"
_UNPORTED = {
    "num_beams": (1, "beam search"),
    "length_penalty": (1.0, "beam search"),
    "temperature": (0.0, "remaining decode modes"),
    "seed": (0, "remaining decode modes"),
    "compression_ratio_threshold": (None, "remaining decode modes"),
    "return_timestamps": (False, _TIMESTAMPS),
    "max_initial_timestamp_index": ("default", _TIMESTAMPS),
    "time_precision": (0.02, _TIMESTAMPS),
    "condition_on_prev_tokens": (False, _TIMESTAMPS),
    "prompt_ids": (None, _TIMESTAMPS),
    "prompt_condition_type": (None, _TIMESTAMPS),
    "attention_mask": (None, _TIMESTAMPS),
    "logits_processor": (None, _TIMESTAMPS),
    "return_scores": (False, "capture surfaces"),
    "return_cross_attentions": (False, "capture surfaces"),
    "return_decoder_attentions": (False, "capture surfaces"),
    "return_hidden_states": (False, "capture surfaces"),
    "return_token_timestamps": (False, "capture surfaces"),
    "word_timestamps": (False, "capture surfaces"),
    "alignment_heads": (None, "capture surfaces"),
    "tokenizer": (None, "capture surfaces"),
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to whisper_medusa_tpu_torch yet "
        f"(ROADMAP queue 1: {item})")


class WhisperMedusaModel:
    def __init__(self, config: ModelConfig, params, device="cuda",
                 generation_config: Optional[GenerationConfig] = None,
                 special_tokens: Optional[SpecialTokens] = None):
        self.config = config
        self.params = params             # {"whisper": ..., "medusa": ...}
        self.device = bridge.resolve_device(device)
        self.special = special_tokens or config.dims.special
        self.generation_config = generation_config or GenerationConfig(
            max_length=config.dims.max_target_positions,
            eos_token_id=self.special.eos,
            pad_token_id=self.special.eos,
            decoder_start_token_id=self.special.sot,
            suppress_tokens=default_suppress_tokens(self.special),
            begin_suppress_tokens=default_begin_suppress_tokens(self.special),
        )

    # ------------------------------------------------------------------ loading
    @classmethod
    def from_random(cls, config: ModelConfig, seed: int = 0, device="cuda",
                    dtype=None) -> "WhisperMedusaModel":
        """Random Whisper + identity-init Medusa heads, drawn on ``device``."""
        if dtype is not None:
            config = config.replace(param_dtype=str(dtype).replace("torch.", ""))
        params = bridge.from_random(config, seed=seed, device=device)
        return cls(config, params, device=device)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda", dtype=None) -> "WhisperMedusaModel":
        """Load a framework checkpoint directory (config.json + params.safetensors)."""
        config, params = bridge.load_checkpoint(path, device=device, dtype=dtype)
        gen_cfg, special = bridge.generation_metadata(path, config)
        return cls(config, params, device=device, generation_config=gen_cfg,
                   special_tokens=special)

    def quantize(self) -> "WhisperMedusaModel":
        """The int8 weight-only serving copy (ops/qmm.py::quantize_decoder):
        decoder layer weights, the tied embedding, the Medusa heads and the
        Medusa-Block layer stored int8 with per-output-channel f32 scales,
        quantized on the model's device, where the copy stays; the encoder,
        layer norms, biases and positional embeddings are shared with this
        model, and a weight that is int8 already is kept as it is.  ``generate``,
        ``detect_language`` and ``encode`` run on it unchanged, with int8
        cross and self caches."""
        from whisper_medusa_tpu_torch.ops.qmm import quantize_decoder

        wp, mp = quantize_decoder(self.params["whisper"], self.params.get("medusa"))
        return WhisperMedusaModel(self.config, {"whisper": wp, "medusa": mp},
                                  device=self.device,
                                  generation_config=self.generation_config,
                                  special_tokens=self.special)

    def save_pretrained(self, path: str) -> None:
        """Write the framework checkpoint format the JAX package reads
        (``config.json``, ``generation_config.json`` with ``special_tokens``,
        ``params.safetensors`` with ``/``-joined keys), so a checkpoint
        trained here loads there, and the other way round.  int8 serving
        copies are not saved (the JAX package saves bf16 or f32 weights)."""
        import json
        import os

        from safetensors.torch import save_file

        flat = bridge.flatten(self.params)
        if any(k.endswith(("/q", "/s")) for k in flat):
            raise ValueError("save_pretrained saves bf16/f32 weights, not the int8 "
                             "serving copy")
        os.makedirs(path, exist_ok=True)
        self.config.save(path)
        gd = self.generation_config.to_dict()
        gd["special_tokens"] = dataclasses.asdict(self.special)
        with open(os.path.join(path, "generation_config.json"), "w") as f:
            json.dump(gd, f, indent=2)
        save_file({k: v.detach().contiguous().cpu() for k, v in flat.items()},
                  os.path.join(path, "params.safetensors"))

    # ----------------------------------------------------------------- encoding
    def encode(self, input_features) -> torch.Tensor:
        feats = torch.as_tensor(input_features, dtype=torch.float32,
                                device=self.device)
        return whisper.encode(self.params["whisper"], self.config.dims, feats)

    def detect_language(self, enc_out: torch.Tensor) -> np.ndarray:
        """One decoder step from <|sot|>, argmax over the language tokens."""
        p = self.params["whisper"]
        dims = self.config.dims
        b = enc_out.shape[0]
        cache = whisper.init_cache(p, dims, enc_out, 1)
        sot = torch.full((b, 1), self.special.sot, dtype=torch.int32, device=self.device)
        out = whisper.decode_step(p, dims, sot, cache,
                                  torch.zeros((b,), dtype=torch.int32, device=self.device))
        logits = whisper.project_logits(p, out.hidden[:, -1])
        lo = self.special.first_language
        hi = lo + self.special.num_languages
        return (torch.argmax(logits[:, lo:hi], dim=-1) + lo).cpu().numpy()

    # ----------------------------------------------------------------- generate
    def generate(
        self,
        input_features,
        language: Optional[Union[str, Sequence[str]]] = None,
        task: str = "transcribe",
        max_length: Optional[int] = None,
        max_new_tokens: Optional[int] = None,
        medusa_choices: Optional[Sequence[int]] = None,
        exponential_decay_length_penalty: Optional[Tuple[int, float]] = None,
        disable_medusa: bool = False,
        suppress_tokens: Optional[Sequence[int]] = "default",
        begin_suppress_tokens: Optional[Sequence[int]] = "default",
        logprob_threshold: Optional[float] = None,
        no_speech_threshold: Optional[float] = None,
        draft_corruption: Optional[float] = None,
        **options,
    ) -> GenerateOutput:
        """Transcribe a batch of mel segments (B, n_mels, <= 3000); K2 runs
        the decoder at B <= 8, the per-op step (K10, K11) beyond.

        ``disable_medusa=True`` decodes vanilla: one token per decoder
        forward, verification logits straight from the hidden state.  With
        one temperature ``logprob_threshold`` only gates no-speech
        blanking, as in the JAX package.  ``draft_corruption`` replaces each draft token
        with probability p (a benchmarking knob: the emitted tokens do not
        change, only the accept counts)."""
        for name, value in options.items():
            if name not in _UNPORTED:
                raise TypeError(f"generate() got an unexpected keyword argument {name!r}")
            default, item = _UNPORTED[name]
            if value != default and not (name == "temperature"
                                         and tuple(np.atleast_1d(value)) == (0.0,)):
                raise _not_ported(f"generate({name}={value!r})", item)
        cfg = self.config
        require_servable_dtype(self.params, self.device)
        feats = torch.as_tensor(input_features, dtype=torch.float32,
                                device=self.device)
        if feats.dim() == 2:
            feats = feats[None]
        b, n_mels, n_frames = feats.shape
        if n_mels != cfg.dims.num_mel_bins:
            raise ValueError(f"expected {cfg.dims.num_mel_bins} mel bins, got {n_mels}")
        if n_frames > cfg.dims.num_frames:
            raise _not_ported("longform (> 30 s) input", _TIMESTAMPS)
        if n_frames < cfg.dims.num_frames:
            feats = torch.nn.functional.pad(feats, (0, cfg.dims.num_frames - n_frames))
        if max_new_tokens is not None and int(max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")

        enc_out = self.encode(feats)
        st = self.special
        detected = None
        if language is None:
            lang_ids = self.detect_language(enc_out)
            detected = [st.languages[i - st.first_language] for i in lang_ids]
        elif isinstance(language, str):
            lang_ids = np.full((b,), language_token_id(language, st), np.int64)
        else:
            if len(language) != b:
                raise ValueError("per-example language list length != batch size")
            lang_ids = np.array([language_token_id(l, st) for l in language])
        task_id = st.transcribe if task == "transcribe" else st.translate
        prompt = np.stack([np.full((b,), st.sot), lang_ids, np.full((b,), task_id),
                           np.full((b,), st.no_timestamps)], axis=1).astype(np.int32)

        max_length = max_length or cfg.dims.max_target_positions
        if max_new_tokens is not None:
            max_length = min(prompt.shape[1] + int(max_new_tokens),
                             cfg.dims.max_target_positions)
        if prompt.shape[1] >= max_length:
            raise ValueError(f"prompt length {prompt.shape[1]} exceeds max_length "
                             f"{max_length}")
        gd = self.generation_config
        sup = tuple(suppress_tokens) if suppress_tokens not in (None, "default") else (
            gd.suppress_tokens if suppress_tokens == "default" else None)
        bsup = tuple(begin_suppress_tokens) if begin_suppress_tokens not in (
            None, "default") else (gd.begin_suppress_tokens
                                   if begin_suppress_tokens == "default" else None)
        decay = exponential_decay_length_penalty
        pcfg = ProcessorConfig(
            vocab_size=cfg.dims.vocab_size, suppress_tokens=sup,
            begin_suppress_tokens=bsup, begin_index=prompt.shape[1],
            exponential_decay_length_penalty=(
                (int(decay[0]) + prompt.shape[1], float(decay[1])) if decay else None),
            eos_token_id=st.eos)
        gen = GenerationConfig(max_length=max_length, temperature=0.0,
                               eos_token_id=st.eos, pad_token_id=gd.pad_token_id,
                               decoder_start_token_id=st.sot, suppress_tokens=sup,
                               begin_suppress_tokens=bsup)
        if disable_medusa:
            choices, variant, medusa_params = (1,), "vanilla", None
        else:
            choices = tuple(medusa_choices or cfg.medusa.medusa_choices)
            variant, medusa_params = cfg.medusa.medusa_heads_type, self.params["medusa"]
        result = speculative_generate(
            self.params["whisper"], medusa_params, cfg.dims,
            generate_medusa_buffers(choices), pcfg, gen, enc_out,
            torch.as_tensor(prompt, device=self.device), variant=variant,
            draft_corruption=draft_corruption)

        tokens = result.tokens.cpu().numpy()
        lengths = result.lengths.cpu().numpy()
        logprobs = result.logprobs.cpu().numpy()
        accepted = result.accepted.cpu().numpy()
        steps = np.full((b,), result.steps, np.int64)
        mean_acc = float(np.sum(accepted / np.maximum(steps, 1)))
        fl = result.first_logits.float().cpu().numpy()
        p = np.exp(fl - fl.max(-1, keepdims=True))
        no_speech_probs = (p / p.sum(-1, keepdims=True))[:, st.no_speech]
        # The average from before no-speech blanking, as the JAX package
        # returns it.
        avg_lp = _avg_from_captured(logprobs, lengths, prompt.shape[1])
        if no_speech_threshold is not None:
            silent = no_speech_probs > no_speech_threshold
            if logprob_threshold is not None:
                silent &= avg_lp < logprob_threshold
            for i in np.where(silent)[0]:
                tokens[i, prompt.shape[1]:] = gd.pad_token_id
                lengths[i] = prompt.shape[1]
        return GenerateOutput(
            sequences=tokens, lengths=lengths, steps=result.steps,
            accepted=accepted, mean_accept_length=mean_acc,
            detected_language=detected, no_speech_probs=no_speech_probs,
            token_logprobs=logprobs, avg_logprobs=avg_lp, steps_per_example=steps)


def require_servable_dtype(params, device) -> None:
    """Serving on the card takes bf16 weights (or the int8 copy): K1, K2, K10
    and K11 have no f32 mode, so f32 floating-point weights on a CUDA
    ``device`` raise NotImplementedError naming the ROADMAP item.  CPU
    serving takes any dtype."""
    if torch.device(device).type != "cuda":
        return
    flat = bridge.flatten(params)
    # An int8 weight's f32 scales ({"q", "s"}) belong to the int8 copy.
    if any(a.dtype == torch.float32 and not (k.endswith("/s") and f"{k[:-2]}/q" in flat)
           for k, a in flat.items()):
        raise NotImplementedError(
            "f32 weights are not served on the card yet (ROADMAP queue 1, item 19: "
            "f32 modes of K1 and K9, and f32 serving); load the checkpoint with "
            "from_pretrained(path, dtype=\"bfloat16\")")


def _avg_from_captured(logprobs: np.ndarray, lengths: np.ndarray,
                       prompt_len: int) -> np.ndarray:
    """Mean generated-token logprob from the loop-captured per-token scores."""
    pos = np.arange(logprobs.shape[1])[None, :]
    mask = (pos >= prompt_len) & (pos < lengths[:, None])
    return np.where(mask, logprobs, 0.0).sum(-1) / np.maximum(mask.sum(-1), 1)
