"""Public model API — counterpart of whisper_medusa_tpu/models/api.py.

``WhisperMedusaModel`` with ``from_random``, ``from_pretrained``, ``encode``,
``detect_language``, ``generate`` and ``generate_stream`` for both Medusa
variants (``base_head``, and ``medusa_block``, chosen by
``config.medusa.medusa_heads_type``) and vanilla decoding
(``disable_medusa=True``) at any batch size: ``language`` given (one code,
or one per example) or detected per example, ``max_length`` /
``max_new_tokens``, ``medusa_choices`` chains and branching trees, the
suppress lists, the exponential decay length penalty, the no-speech
probability, the temperature-fallback ladder (``temperature`` lists,
``seed``, ``compression_ratio_threshold``, ``logprob_threshold``; typical
acceptance and sampling at temperature > 0), ``return_timestamps`` with its
segments, ``prompt_ids``, longform input (> 30 s) through the seek loop
(``condition_on_prev_tokens``, ``prompt_condition_type``,
``attention_mask``), the ``logits_processor`` hook and beam search
(``num_beams``, ``length_penalty``; shortform and longform) and the
capture surfaces (``return_scores="full"``, ``return_cross_attentions``,
``return_decoder_attentions``, ``return_hidden_states``,
``return_token_timestamps``, ``word_timestamps``; each served by one
post-hoc teacher-forced pass, ``decoding/scores.py`` and
``decoding/word_timestamps.py``), and ``score_sequences``.
``quantize()`` gives
the int8 serving copy (W8A16 decoder, embedding, heads and Medusa-Block
layer; int8 caches).  Everything runs on the card unless the model was made
with ``device="cpu"``.

``shard(dp=, tp=)`` serves over a (data, model) mesh of ``torch.distributed``
ranks (``parallel/mesh.py``): ``encode``, ``detect_language`` and
``generate`` split a batch that divides by dp into each data rank's
examples, run them there (K2, the heads and the verify kernels as a
single-process call would, each rank's decode loop on its own: no
collective inside it) and all-gather the outputs in example order, so every
rank returns the whole result; a batch that does not divide is served whole
on every rank, as the JAX package replicates it.  Over the model axis every
layer runs on this rank's heads and FFN columns (``models/whisper.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import logging
import zlib
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from whisper_medusa_tpu_torch.config import (GenerationConfig, ModelConfig, SpecialTokens,
                                       default_begin_suppress_tokens,
                                       default_suppress_tokens, language_token_id)
from whisper_medusa_tpu_torch.decoding import scores as scores_mod
from whisper_medusa_tpu_torch.decoding import word_timestamps as wt
from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig
from whisper_medusa_tpu_torch.decoding.speculative import speculative_generate
from whisper_medusa_tpu_torch.models import bridge, whisper
from whisper_medusa_tpu_torch.parallel import distributed
from whisper_medusa_tpu_torch.parallel import mesh as mesh_mod

# ROADMAP queue 1 item of a tp that splits an attention head.
_HEAD_SPLIT_ITEM = "ROADMAP queue 1, item 24"


@dataclasses.dataclass
class GenerateOutput:
    sequences: np.ndarray          # (B, max_length) int32, EOS backfilled
    lengths: np.ndarray            # (B,)
    steps: int                     # decoder loop iterations
    accepted: np.ndarray           # (B,) accepted draft tokens
    mean_accept_length: float      # accepted drafts per step
    detected_language: Optional[List[str]] = None
    segments: Optional[List[List[dict]]] = None    # per-example timestamped segments
    no_speech_probs: Optional[np.ndarray] = None   # (B,) prob of <|nospeech|>
    token_logprobs: Optional[np.ndarray] = None    # (B, max_length)
    avg_logprobs: Optional[np.ndarray] = None      # (B,)
    steps_per_example: Optional[np.ndarray] = None  # (B,)
    # ``return_scores="full"``: the processed score stack, (B, max_length -
    # prompt_len, V) float32 log-probs, one row per generated position
    # (decoding/scores.py).
    scores: Optional[np.ndarray] = None
    # ``return_cross_attentions``: (L, B, H, T, S) for ``True``, (N_sel, B,
    # T, S) for a (layer, head) selection, float32.
    cross_attentions: Optional[np.ndarray] = None
    # ``word_timestamps=True``: per-example [{"word", "start", "end"}] lists
    # from the cross-attention DTW (decoding/word_timestamps.py).
    words: Optional[List[List[dict]]] = None
    # ``return_token_timestamps=True``: per-example (T_gen_i, 2) float64 DTW
    # (start, end) seconds per generated token (timestamp / EOS rows NaN).
    token_timestamps: Optional[List[np.ndarray]] = None
    # ``return_decoder_attentions``: self-attention maps, (L, B, H, T, T) for
    # ``True``, (N_sel, B, T, T) for a selection, float32.
    decoder_attentions: Optional[np.ndarray] = None
    # ``return_hidden_states``: (L+1, B, T, D) float32, row 0 the embedding
    # output, row 1 + l layer l's output (before ln_post).
    decoder_hidden_states: Optional[np.ndarray] = None
    # Longform (> 30 s): ``scores`` is (B, T_out, V), row j the row that
    # emitted ``sequences[:, j]``; ``words`` and ``token_timestamps`` carry
    # absolute times; the attention and hidden-state surfaces become
    # per-example lists of per-window dicts {"time_offset", "cross_attentions",
    # "decoder_attentions", "decoder_hidden_states"} under
    # ``cross_attentions``.


_BATCH_AXIS1 = ("cross_attentions", "decoder_attentions", "decoder_hidden_states")


def _merge_outputs(parts: List[GenerateOutput], pad_id: int, longform: bool) -> GenerateOutput:
    """The data ranks' GenerateOutputs, in rank order, as one: per-example
    fields concatenated (the capture maps on their batch axis 1; rows padded
    to the widest rank's, sequences with ``pad_id``, scores and log-probs
    with 0, as a longform batch pads them), lists joined, ``steps`` the
    largest rank's loop count, ``mean_accept_length`` re-formed from the
    per-example terms (longform: the summed accepts over ``steps``)."""
    out = {}
    for f in dataclasses.fields(GenerateOutput):
        vals = [getattr(p, f.name) for p in parts]
        if vals[0] is None or f.name == "mean_accept_length":
            out[f.name] = None
        elif f.name == "steps":
            out[f.name] = max(vals)
        elif isinstance(vals[0], list):
            out[f.name] = [x for v in vals for x in v]
        elif f.name in _BATCH_AXIS1:
            out[f.name] = np.concatenate(vals, axis=1)
        elif f.name == "accepted" and longform:
            out[f.name] = np.asarray([int(sum(int(np.sum(v)) for v in vals))])
        else:
            width = max(v.shape[1] for v in vals) if vals[0].ndim > 1 else None
            fill = pad_id if f.name == "sequences" else 0
            padded = [v if width is None or v.shape[1] == width else np.concatenate(
                [v, np.full((v.shape[0], width - v.shape[1]) + v.shape[2:], fill, v.dtype)],
                axis=1) for v in vals]
            out[f.name] = np.concatenate(padded, axis=0)
    if longform:
        out["mean_accept_length"] = int(out["accepted"][0]) / max(out["steps"], 1)
    else:
        out["mean_accept_length"] = float(sum(p.mean_accept_length for p in parts))
    return GenerateOutput(**out)


def _batch_size(x) -> Optional[int]:
    shape = getattr(x, "shape", None)
    if shape is None:
        shape = np.shape(x)
    return int(shape[0]) if len(shape) == 3 else None


def _data_parallel(gather):
    """Serve a batch method over the mesh's data axis.  The method's first
    argument is the (B, ...) batch; where dp divides B, each data rank runs
    the method on its examples (with ``attention_mask`` and a per-example
    ``language`` list cut alike) and ``gather(self, mesh, out, batch)``
    assembles every rank's result; else every rank runs the whole batch.
    Nested calls (``generate`` calls ``encode``) run as they are, inside the
    outer call's split.  Everything runs under the mesh (its model axis)."""
    def wrap(fn):
        sig = inspect.signature(fn)
        first = list(sig.parameters)[1]

        @functools.wraps(fn)
        def run(self, *args, **kwargs):
            mesh = self.mesh
            if mesh is None or self._local:
                return fn(self, *args, **kwargs)
            bound = sig.bind(self, *args, **kwargs)
            batch = bound.arguments[first]
            b = _batch_size(batch)
            with mesh_mod.use_mesh(mesh):
                self._local = True
                try:
                    if mesh.dp == 1 or b is None or b % mesh.dp:
                        return fn(self, *args, **kwargs)
                    cut = lambda x: distributed.local_rows(x, mesh.data_index, mesh.dp)
                    bound.arguments[first] = cut(batch)
                    if bound.arguments.get("attention_mask") is not None:
                        bound.arguments["attention_mask"] = cut(
                            np.asarray(bound.arguments["attention_mask"]).reshape(b, -1))
                    lang = bound.arguments.get("language")
                    if isinstance(lang, (list, tuple)) and len(lang) == b:
                        bound.arguments["language"] = list(cut(np.asarray(lang, object)))
                    out = fn(*bound.args, **bound.kwargs)
                finally:
                    self._local = False
                return gather(self, mesh, out, batch)
        return run
    return wrap


def _on_mesh(fn):
    """Run a method (or iterate a generator method) under the model's mesh,
    the batch whole on every rank."""
    if inspect.isgeneratorfunction(fn):
        @functools.wraps(fn)
        def gen(self, *args, **kwargs):
            with mesh_mod.use_mesh(self.mesh):
                yield from fn(self, *args, **kwargs)
        return gen

    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        with mesh_mod.use_mesh(self.mesh):
            return fn(self, *args, **kwargs)
    return run


def _gather_rows(self, mesh, out: torch.Tensor, batch) -> torch.Tensor:
    return distributed.all_gather(out, mesh.data_group, dim=0)


def _gather_array(self, mesh, out: np.ndarray, batch) -> np.ndarray:
    return np.concatenate(distributed.all_gather_objects(out, mesh.data_group), axis=0)


def _gather_generate(self, mesh, out: GenerateOutput, batch) -> GenerateOutput:
    longform = np.shape(batch)[-1] > self.config.dims.num_frames
    return _merge_outputs(distributed.all_gather_objects(out, mesh.data_group),
                          self.generation_config.pad_token_id, longform)


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
        self.mesh = None               # set by shard(); None = one process
        self._local = False            # inside a data-parallel call's split

    # --------------------------------------------------------------- sharding
    def shard(self, mesh=None, dp: Optional[int] = None,
              tp: Optional[int] = None) -> "WhisperMedusaModel":
        """Serve over a (data, model) mesh of ``torch.distributed`` ranks
        (JAX ``shard``): every rank calls it after
        ``parallel.distributed.initialize``.  The weights become this rank's
        shard (``parallel/mesh.py::shard_params``), except the tied
        embedding, which is all-gathered back whole once here: the vocab
        side (K3, K4, K5 and the embedding lookup) runs on every model rank
        on the all-reduced rows.  ``tp`` must divide d_model and both FFN
        widths (ValueError, JAX's check) and both head counts
        (NotImplementedError: the per-op attention does not split a head).
        A mesh wider than the world raises; nothing serves unsharded in
        its place."""
        if mesh is None:
            mesh = mesh_mod.make_mesh((dp or 1) * (tp or 1) if dp and tp else None,
                                      dp=dp, tp=tp)
        d = self.config.dims
        for name, v in (("d_model", d.d_model), ("encoder_ffn_dim", d.encoder_ffn_dim),
                        ("decoder_ffn_dim", d.decoder_ffn_dim)):
            if v % mesh.tp != 0:
                raise ValueError(f"tensor-parallel size {mesh.tp} does not divide {name}={v}")
        for name, v in (("encoder_attention_heads", d.encoder_attention_heads),
                        ("decoder_attention_heads", d.decoder_attention_heads)):
            if v % mesh.tp != 0:
                raise NotImplementedError(
                    f"tensor-parallel size {mesh.tp} does not divide {name}={v}: a head "
                    f"split across ranks is not ported ({_HEAD_SPLIT_ITEM})")
        specs = mesh_mod.param_specs(self.params, mesh.tp)
        params = mesh_mod.shard_params(self.params, mesh)
        params["whisper"]["decoder"]["embed_tokens"] = mesh_mod.gather_params(
            params["whisper"]["decoder"]["embed_tokens"],
            specs["whisper"]["decoder"]["embed_tokens"], mesh)
        self.params = params
        self.mesh = mesh
        return self

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
        """Load a checkpoint directory: the framework's (config.json +
        params.safetensors) or a reference (``aiola/whisper-medusa-*``)
        one, converted (``models/convert.py``); ``generation_config.json``
        in either format when present."""
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

        if self.mesh is not None:
            raise ValueError("quantize() before shard(): a shard's row-parallel weights "
                             "would take per-shard scales")
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

        if self.mesh is not None:
            raise ValueError("save_pretrained saves a whole model, not a rank's shard")
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
    @_data_parallel(_gather_rows)
    def encode(self, input_features) -> torch.Tensor:
        feats = torch.as_tensor(input_features, dtype=torch.float32,
                                device=self.device)
        return whisper.encode(self.params["whisper"], self.config.dims, feats)

    @_data_parallel(_gather_array)
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
    @_data_parallel(_gather_generate)
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
        return_timestamps: bool = False,
        prompt_ids: Optional[Sequence[int]] = None,
        max_initial_timestamp_index: Optional[int] = "default",
        time_precision: float = 0.02,
        condition_on_prev_tokens: bool = False,
        prompt_condition_type: Optional[str] = None,
        attention_mask=None,
        num_beams: int = 1,
        length_penalty: float = 1.0,
        logits_processor: Optional[Callable] = None,
        temperature: Union[float, Sequence[float]] = 0.0,
        compression_ratio_threshold: Optional[float] = None,
        seed: int = 0,
        return_scores: Union[bool, str] = False,
        return_cross_attentions: Union[bool, Sequence[Tuple[int, int]]] = False,
        word_timestamps: bool = False,
        alignment_heads: Optional[Sequence[Tuple[int, int]]] = None,
        tokenizer=None,
        return_decoder_attentions: Union[bool, Sequence[Tuple[int, int]]] = False,
        return_hidden_states: bool = False,
        return_token_timestamps: bool = False,
    ) -> GenerateOutput:
        """Transcribe a batch of mel features (B, n_mels, frames); K2 runs
        the decoder at B <= 8, the per-op step (K10, K11) beyond.

        ``disable_medusa=True`` decodes vanilla: one token per decoder
        forward, verification logits straight from the hidden state.  With
        one temperature ``logprob_threshold`` only gates no-speech
        blanking, as in the JAX package.  ``draft_corruption`` replaces each draft token
        with probability p (a benchmarking knob: the emitted tokens do not
        change, only the accept counts).  ``medusa_choices`` may be a
        branching tree (per-level branching factors, e.g. (1, 2, 2, 1)).

        ``temperature``: one value or a fallback ladder (t0, t1, ...).  A
        rung at 0 decodes greedily; a rung at t > 0 verifies by typical
        acceptance and samples from softmax(logits / t) with a
        ``torch.Generator`` seeded from (``seed``, rung index).  After each
        rung the examples whose generated tokens compress by more than
        ``compression_ratio_threshold`` or whose mean log-prob is below
        ``logprob_threshold`` are decoded again, alone, at the next rung;
        every returned field of an example comes from the rung that
        produced its kept sequence, ``steps`` sums the rungs' loop
        iterations (:meth:`_decode_ladder`).

        ``return_timestamps=True`` drops ``<|notimestamps|>`` from the prompt,
        applies the Whisper timestamp rules at every verified position and
        returns ``segments``; ``prompt_ids`` are prepended to the prompt.
        Input longer than 30 s runs the seek loop (:meth:`_generate_longform`):
        each 30 s window decoded with timestamps, the seek advanced to the
        end of its last complete segment; ``condition_on_prev_tokens`` puts
        the previous window's kept text (the last 64, 32 or 16 tokens) in
        front of the next window's prompt, ``prompt_condition_type``
        ("first-segment" or "all-segments") says which windows ``prompt_ids``
        condition, and ``attention_mask`` (B, frames) bounds each example's
        real audio.

        ``logits_processor``: a torch function ``(logits (..., V) float32,
        pred_pos (...,) int32) -> logits`` on the logits' device, applied
        after the built-in processors at every scored position; the decode
        loop then verifies from materialized logits (no K4 / K5).
        ``num_beams > 1`` runs beam search (:meth:`_generate_beam`; longform
        input through the seek loop) with the GNMT ``length_penalty``;
        ``avg_logprobs`` are then the beams' length-normalized scores.

        The capture surfaces (greedy and sampled decodes, not beams) are
        served after the decode by one teacher-forced pass over the final
        tokens (:meth:`_capture`): ``return_scores="full"`` the processed
        score stack; ``return_cross_attentions`` / ``return_decoder_attentions``
        the cross- / self-attention maps (every head for ``True``, or a
        tuple of (layer, head) pairs); ``return_hidden_states`` the
        per-layer hidden states; ``return_token_timestamps`` per-token DTW
        times and ``word_timestamps`` (``return_timestamps=True`` and a
        ``tokenizer`` required) DTW word times attached to the segments, on
        ``alignment_heads`` (else the generation config's, else the upper
        half of the decoder's heads).  ``attention_mask`` bounds each
        example's audio for the DTW.  Longform input composes them per
        window (see :class:`GenerateOutput`)."""
        captures = dict(
            return_scores=return_scores, return_cross_attentions=return_cross_attentions,
            word_timestamps=word_timestamps, alignment_heads=alignment_heads,
            tokenizer=tokenizer, return_decoder_attentions=return_decoder_attentions,
            return_hidden_states=return_hidden_states,
            return_token_timestamps=return_token_timestamps)
        if return_scores not in (False, True, "full"):
            raise ValueError(f"return_scores must be False/True/'full', got {return_scores!r}")
        if word_timestamps:
            if not return_timestamps:
                raise ValueError("word_timestamps=True requires return_timestamps=True "
                                 "(words are attached to segments)")
            if tokenizer is None:
                raise ValueError("word_timestamps=True requires tokenizer= (token->word "
                                 "splitting needs the vocabulary)")
        if num_beams != 1:
            _check_beam_options(num_beams, temperature, compression_ratio_threshold,
                                logprob_threshold, no_speech_threshold, captures)
        if max_new_tokens is not None and int(max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt_condition_type is None:
            prompt_condition_type = "first-segment"
        if prompt_condition_type not in ("first-segment", "all-segments"):
            raise ValueError(f"prompt_condition_type must be 'first-segment' or "
                             f"'all-segments', got {prompt_condition_type!r}")
        if prompt_condition_type == "all-segments" and not condition_on_prev_tokens:
            raise ValueError("prompt_condition_type='all-segments' requires "
                             "condition_on_prev_tokens=True")
        cfg = self.config
        feats = self._features(input_features)
        b, _, n_frames = feats.shape
        frame_counts = None
        if attention_mask is not None:
            am = np.asarray(attention_mask).reshape(b, -1)
            if am.shape[1] != n_frames:
                raise ValueError(
                    f"attention_mask shape {np.asarray(attention_mask).shape} does not "
                    f"match features (B={b}, frames={n_frames})")
            # Each example's real frames: they bound the DTW's live audio.
            frame_counts = am.astype(bool).sum(axis=1)
        if n_frames > cfg.dims.num_frames:
            return self._generate_longform(
                feats, language=language, task=task, max_length=max_length,
                max_new_tokens=max_new_tokens, medusa_choices=medusa_choices,
                disable_medusa=disable_medusa,
                exponential_decay_length_penalty=exponential_decay_length_penalty,
                logprob_threshold=logprob_threshold,
                no_speech_threshold=no_speech_threshold, draft_corruption=draft_corruption,
                return_timestamps=return_timestamps, time_precision=time_precision,
                condition_on_prev_tokens=condition_on_prev_tokens, prompt_ids=prompt_ids,
                prompt_condition_type=prompt_condition_type, attention_mask=attention_mask,
                num_beams=num_beams, length_penalty=length_penalty,
                logits_processor=logits_processor, temperature=temperature,
                compression_ratio_threshold=compression_ratio_threshold, seed=seed,
                captures=captures)
        if num_beams != 1:
            return self._generate_beam(
                feats, language=language, task=task, max_length=max_length,
                max_new_tokens=max_new_tokens, num_beams=num_beams,
                suppress_tokens=suppress_tokens, begin_suppress_tokens=begin_suppress_tokens,
                length_penalty=length_penalty,
                exponential_decay_length_penalty=exponential_decay_length_penalty,
                prompt_ids=prompt_ids, return_timestamps=return_timestamps,
                time_precision=time_precision, logits_processor=logits_processor)
        enc_out, prompt, detected, pcfg, gen = self._setup(
            feats, language=language, task=task, max_length=max_length,
            max_new_tokens=max_new_tokens, suppress_tokens=suppress_tokens,
            begin_suppress_tokens=begin_suppress_tokens,
            exponential_decay_length_penalty=exponential_decay_length_penalty,
            return_timestamps=return_timestamps, prompt_ids=prompt_ids,
            max_initial_timestamp_index=max_initial_timestamp_index,
            logits_processor=logits_processor)
        st, gd = self.special, self.generation_config
        merged, steps_total = self._decode_ladder(
            enc_out, prompt, pcfg, gen, disable_medusa, medusa_choices, draft_corruption,
            temperature, compression_ratio_threshold, logprob_threshold, seed)
        tokens, lengths, logprobs = merged["tokens"], merged["lengths"], merged["logprobs"]
        accepted, steps = merged["accepted"], merged["steps"]
        # Accepted drafts per step, each example against its own rung's loop
        # count (accepted.sum() / steps when no fallback ran).
        mean_acc = float(np.sum(accepted / np.maximum(steps, 1)))
        fl = merged["first_logits"]
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
        segments = None
        if return_timestamps:
            segments = [_extract_segments(tokens[i], int(lengths[i]), prompt.shape[1],
                                          time_precision, st) for i in range(b)]
        surfaces = self._capture(enc_out, tokens, lengths, prompt.shape[1], pcfg,
                                 gen.max_length, n_frames, frame_counts, segments,
                                 **captures)
        return GenerateOutput(
            sequences=tokens, lengths=lengths, steps=steps_total,
            accepted=accepted, mean_accept_length=mean_acc,
            detected_language=detected, segments=segments,
            no_speech_probs=no_speech_probs, token_logprobs=logprobs,
            avg_logprobs=avg_lp, steps_per_example=steps, **surfaces)

    def _capture(self, enc_out: torch.Tensor, tokens: np.ndarray, lengths: np.ndarray,
                 prompt_len: int, pcfg: ProcessorConfig, max_length: int, n_frames: int,
                 frame_counts, segments, *, return_scores, return_cross_attentions,
                 word_timestamps, alignment_heads, tokenizer, return_decoder_attentions,
                 return_hidden_states, return_token_timestamps) -> dict:
        """The capture surfaces of one shortform request, on its final
        tokens (after the ladder and the no-speech blanking): the score
        stack (decoding/scores.py), then ONE teacher-forced capture pass
        (``whisper.decode_train_capture``, its maps moved to the host layer
        by layer) for every map and hidden-state surface: the union of the
        user's (layer, head) selection and the alignment heads, or every
        head for ``return_cross_attentions=True``.  The pass runs one
        example at a time, as ``init_cache`` projects the cross K/V: a
        library GEMM may round another way at another row count, and the
        DTW's path can move by many frames on a small change of its maps, so
        an example's maps, hidden states and times do not depend on the batch
        it is in.  One DTW an example serves both token and word times.
        {GenerateOutput field: value}."""
        cfg, st = self.config, self.special
        p = self.params["whisper"]
        out = dict(scores=None, cross_attentions=None, words=None, token_timestamps=None,
                   decoder_attentions=None, decoder_hidden_states=None)
        if return_scores == "full":
            out["scores"] = scores_mod.full_scores(p, cfg.dims, tokens, lengths, enc_out,
                                                   pcfg, max_length)
        want_align = word_timestamps or return_token_timestamps
        if not (return_cross_attentions or want_align or return_decoder_attentions
                or return_hidden_states):
            return out
        select = None
        if return_cross_attentions and return_cross_attentions is not True:
            select = tuple((int(l), int(h)) for l, h in return_cross_attentions)
        align_sel = ()
        if want_align:
            align_sel = tuple((int(l), int(h)) for l, h in (
                alignment_heads or self.generation_config.alignment_heads
                or wt.default_alignment_heads(cfg.dims.decoder_layers,
                                              cfg.dims.decoder_attention_heads)))
        full_capture = return_cross_attentions is True
        want = None if full_capture else tuple(dict.fromkeys((select or ()) + align_sel))
        cross_arg = (None if not (return_cross_attentions or want_align)
                     else "all" if full_capture else want)
        self_arg = None
        if return_decoder_attentions is True:
            self_arg = "all"
        elif return_decoder_attentions:
            self_arg = tuple((int(l), int(h)) for l, h in return_decoder_attentions)
        dec_in = torch.as_tensor(tokens[:, :max_length], dtype=torch.int32, device=self.device)
        with torch.no_grad():
            parts = [whisper.decode_train_capture(
                p, cfg.dims, dec_in[i:i + 1], enc_out[i:i + 1], cross=cross_arg,
                self_attn=self_arg, collect_hidden=return_hidden_states, to_host=True)
                for i in range(tokens.shape[0])]
        # Every surface has the batch on axis 1.
        maps, smaps, hid = (None if parts[0][k] is None
                            else torch.cat([part[k] for part in parts], dim=1)
                            for k in (1, 2, 3))
        if smaps is not None:
            out["decoder_attentions"] = smaps.float().numpy()
        if hid is not None:
            out["decoder_hidden_states"] = hid.float().numpy()
        maps = None if maps is None else maps.float().numpy()
        if full_capture:
            out["cross_attentions"] = maps                       # (L, B, H, T, S)
        elif select:
            out["cross_attentions"] = maps[[want.index(pair) for pair in select]]
        if not want_align:
            return out
        if full_capture:
            amaps = np.stack([maps[l][:, h] for l, h in align_sel])
        else:
            amaps = maps[[want.index(pair) for pair in align_sel]]
        live_frames = min(n_frames, cfg.dims.num_frames) // 2
        words = [] if word_timestamps else None
        token_tts = [] if return_token_timestamps else None
        for i in range(tokens.shape[0]):
            li = int(lengths[i])
            # A generated token's row is the query at its own position (it
            # is the input there in the teacher-forced pass).
            gen_i = tokens[i, prompt_len:li]
            maps_i = amaps[:, i][:, np.arange(prompt_len, li)]
            # attention_mask narrows each example's live audio: the DTW must
            # not align tokens onto padding frames.
            lf_i = (live_frames if frame_counts is None
                    else max(min(int(frame_counts[i]), cfg.dims.num_frames) // 2, 1))
            spans = None
            if return_token_timestamps:
                spans = wt.per_token_times(gen_i, maps_i, lf_i, st.eos)
                token_tts.append(spans)
            if word_timestamps:
                words.append(wt.words_with_times(gen_i, maps_i, tokenizer, lf_i, st.eos,
                                                 st.timestamp_begin, token_spans=spans))
        if word_timestamps and segments is not None:
            _attach_words_to_segments(segments, words)
        out["words"], out["token_timestamps"] = words, token_tts
        return out

    def _features(self, input_features) -> torch.Tensor:
        """(B, n_mels, frames) f32 features on the model's device, checked."""
        require_servable_dtype(self.params, self.device)
        feats = torch.as_tensor(input_features, dtype=torch.float32, device=self.device)
        if feats.dim() == 2:
            feats = feats[None]
        if feats.shape[1] != self.config.dims.num_mel_bins:
            raise ValueError(f"expected {self.config.dims.num_mel_bins} mel bins, got "
                             f"{feats.shape[1]}")
        return feats

    def _setup(self, feats: torch.Tensor, *, language, task, max_length,
               max_new_tokens=None, suppress_tokens="default",
               begin_suppress_tokens="default", exponential_decay_length_penalty=None,
               return_timestamps=False, prompt_ids=None,
               max_initial_timestamp_index="default", logits_processor=None):
        """One shortform request's setup, shared by :meth:`generate`,
        :meth:`_generate_beam` and :meth:`generate_stream`: the features
        padded to 30 s and encoded, the language (detected where None), the
        prompt, the processors (``logits_processor`` their ``custom`` hook)
        and the generation config.  (enc_out, prompt, detected, pcfg, gen)."""
        cfg, st, gd = self.config, self.special, self.generation_config
        b, _, n_frames = feats.shape
        if n_frames > cfg.dims.num_frames:
            raise ValueError(f"{n_frames} frames: a shortform request takes at most "
                             f"{cfg.dims.num_frames}")
        if n_frames < cfg.dims.num_frames:
            feats = torch.nn.functional.pad(feats, (0, cfg.dims.num_frames - n_frames))
        enc_out = self.encode(feats)
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
        cols = [np.full((b,), st.sot), lang_ids, np.full((b,), task_id)]
        if not return_timestamps:
            cols.append(np.full((b,), st.no_timestamps))
        prompt = np.stack(cols, axis=1).astype(np.int32)
        if prompt_ids is not None:
            pids = np.asarray(prompt_ids, np.int32).reshape(1, -1)
            prompt = np.concatenate([np.tile(pids, (b, 1)), prompt], axis=1)

        max_length = max_length or cfg.dims.max_target_positions
        if max_new_tokens is not None:
            max_length = min(prompt.shape[1] + int(max_new_tokens),
                             cfg.dims.max_target_positions)
        if prompt.shape[1] >= max_length:
            raise ValueError(f"prompt length {prompt.shape[1]} exceeds max_length "
                             f"{max_length}")
        sup = tuple(suppress_tokens) if suppress_tokens not in (None, "default") else (
            gd.suppress_tokens if suppress_tokens == "default" else None)
        bsup = tuple(begin_suppress_tokens) if begin_suppress_tokens not in (
            None, "default") else (gd.begin_suppress_tokens
                                   if begin_suppress_tokens == "default" else None)
        if max_initial_timestamp_index == "default":
            max_initial_timestamp_index = gd.max_initial_timestamp_index
        decay = exponential_decay_length_penalty
        pcfg = ProcessorConfig(
            vocab_size=cfg.dims.vocab_size, suppress_tokens=sup,
            begin_suppress_tokens=bsup, begin_index=prompt.shape[1],
            exponential_decay_length_penalty=(
                (int(decay[0]) + prompt.shape[1], float(decay[1])) if decay else None),
            eos_token_id=st.eos, timestamp_rules=return_timestamps,
            timestamp_begin=st.timestamp_begin, no_timestamps_id=st.no_timestamps,
            max_initial_timestamp_index=max_initial_timestamp_index,
            custom=logits_processor)
        gen = GenerationConfig(max_length=max_length, temperature=0.0,
                               eos_token_id=st.eos, pad_token_id=gd.pad_token_id,
                               decoder_start_token_id=st.sot, suppress_tokens=sup,
                               begin_suppress_tokens=bsup,
                               posterior_threshold=gd.posterior_threshold,
                               posterior_alpha=gd.posterior_alpha)
        return enc_out, prompt, detected, pcfg, gen

    def _decode_mode(self, disable_medusa: bool, medusa_choices=None):
        """(choices, variant, medusa params) of a request."""
        if disable_medusa:
            return (1,), "vanilla", None
        return (tuple(medusa_choices or self.config.medusa.medusa_choices),
                self.config.medusa.medusa_heads_type, self.params["medusa"])

    def _decode_ladder(self, enc_out: torch.Tensor, prompt: np.ndarray, pcfg, gen,
                       disable_medusa: bool, medusa_choices, draft_corruption, temperature,
                       compression_ratio_threshold, logprob_threshold, seed: int):
        """The temperature-fallback ladder with subset retry (the JAX
        package's, api.py:560-626): rung 0 decodes every example, each later
        rung only the examples that still fail :func:`_needs_fallback`, and
        every per-example field (tokens, lengths, log-probs, accepted,
        steps, first logits) comes from the rung that produced the
        example's kept sequence.  The JAX package pads a retry batch to a
        power of two to bound its jit cache; the port has none to bound and
        decodes exactly the failing rows.  ({field: (B, ...) numpy},
        summed loop iterations)."""
        cfg = self.config
        b, p_len = prompt.shape
        choices, variant, medusa_params = self._decode_mode(disable_medusa, medusa_choices)
        buffers = generate_medusa_buffers(choices)
        temps = ((temperature,) if isinstance(temperature, (int, float))
                 else tuple(temperature))
        keep = np.zeros((b,), bool)
        merged, steps_total = {}, 0
        for t_i, temp in enumerate(temps):
            fail = np.arange(b) if t_i == 0 else np.where(~keep)[0]
            rng = None
            if float(temp) > 0.0:
                # Sampled rungs draw from a generator seeded from (seed, rung).
                rng = torch.Generator(device=self.device)
                rng.manual_seed(int(np.random.SeedSequence([seed, t_i]).generate_state(1)[0]))
            rows_idx = torch.as_tensor(fail, device=self.device)
            result = speculative_generate(
                self.params["whisper"], medusa_params, cfg.dims, buffers, pcfg,
                dataclasses.replace(gen, temperature=float(temp)),
                enc_out if t_i == 0 else enc_out[rows_idx],
                torch.as_tensor(prompt[fail], device=self.device), variant=variant,
                draft_corruption=draft_corruption, rng=rng)
            steps_total += result.steps
            rows = {"tokens": result.tokens.cpu().numpy(),
                    "lengths": result.lengths.cpu().numpy(),
                    "logprobs": result.logprobs.cpu().numpy(),
                    "accepted": result.accepted.cpu().numpy(),
                    "steps": np.full((len(fail),), result.steps, np.int64),
                    "first_logits": result.first_logits.float().cpu().numpy()}
            if t_i == 0:
                merged = rows
            else:
                for k, v in rows.items():
                    merged[k][fail] = v
            avg_lp = _avg_from_captured(rows["logprobs"], rows["lengths"], p_len)
            bad = _needs_fallback(rows["tokens"], rows["lengths"], p_len,
                                  compression_ratio_threshold, avg_lp, logprob_threshold,
                                  vocab_size=cfg.dims.vocab_size)
            keep[fail] = ~bad
            if keep.all():
                break
        return merged, steps_total

    def _generate_beam(self, feats: torch.Tensor, *, language, task, max_length,
                       max_new_tokens, num_beams, suppress_tokens="default",
                       begin_suppress_tokens="default", length_penalty=1.0,
                       exponential_decay_length_penalty=None, prompt_ids=None,
                       return_timestamps=False, time_precision=0.02,
                       logits_processor=None) -> GenerateOutput:
        """One 30 s window's beam search (decoding/beam.py): the prompt,
        processors and ``max_new_tokens`` precedence of :meth:`generate`,
        per-example languages, timestamps with their segments;
        ``avg_logprobs`` are the beams' length-normalized scores, ``steps``
        the expansions."""
        from whisper_medusa_tpu_torch.decoding.beam import beam_search

        st = self.special
        enc_out, prompt, _, pcfg, gen = self._setup(
            feats, language=language, task=task, max_length=max_length,
            max_new_tokens=max_new_tokens, suppress_tokens=suppress_tokens,
            begin_suppress_tokens=begin_suppress_tokens,
            exponential_decay_length_penalty=exponential_decay_length_penalty,
            return_timestamps=return_timestamps, prompt_ids=prompt_ids,
            logits_processor=logits_processor)
        res = beam_search(self.params["whisper"], self.config.dims, pcfg, gen, enc_out,
                          torch.as_tensor(prompt, device=self.device), num_beams=num_beams,
                          length_penalty=length_penalty)
        b = prompt.shape[0]
        sequences = res.tokens.cpu().numpy()
        lengths = res.lengths.cpu().numpy()
        segments = None
        if return_timestamps:
            segments = [_extract_segments(sequences[i], int(lengths[i]), prompt.shape[1],
                                          time_precision, st) for i in range(b)]
        return GenerateOutput(
            sequences=sequences, lengths=lengths, steps=res.steps,
            accepted=np.zeros((b,), np.int32), mean_accept_length=0.0,
            avg_logprobs=res.scores.cpu().numpy(), segments=segments)

    def _generate_longform(self, feats: torch.Tensor, *, language, task, max_length,
                           max_new_tokens, medusa_choices, disable_medusa,
                           exponential_decay_length_penalty, logprob_threshold,
                           no_speech_threshold, draft_corruption, return_timestamps,
                           time_precision, condition_on_prev_tokens, prompt_ids,
                           prompt_condition_type, attention_mask, num_beams=1,
                           length_penalty=1.0, logits_processor=None, temperature=0.0,
                           compression_ratio_threshold=None, seed=0,
                           captures: dict) -> GenerateOutput:
        """The seek loop over 30 s windows (the JAX package's
        ``_generate_longform``).  Each
        window decodes with timestamps; where it holds a complete segment and
        audio remains, the seek advances to that segment's end (mel frame =
        10 ms) and what follows it is dropped, to be decoded again from the
        next window's start; else the whole window is kept and the seek
        advances 30 s.  Timestamps are stripped unless ``return_timestamps``.

        B > 1 without ``condition_on_prev_tokens``: each round decodes every
        example's current window in one batched call (finished examples ride
        along, their outputs ignored).  Else each example runs alone, its
        window prompt ``[<|startofprev|>, *context]`` with the previous
        windows' kept text bucketed to its last 64, 32 or 16 tokens, and
        ``prompt_ids`` on the first window ("first-segment") or in front of
        every window's context ("all-segments").  ``steps`` sums the loop
        iterations over rounds; ``accepted`` counts active examples only.
        With ``num_beams > 1`` every window is beam-decoded and no per-token
        log-probs are returned (``token_logprobs`` and ``avg_logprobs`` None),
        as in the JAX package.  Every window runs the temperature ladder
        (``temperature``, ``compression_ratio_threshold``,
        ``logprob_threshold``, ``seed``) of :meth:`generate`.

        The capture surfaces (``captures``: :meth:`generate`'s capture
        options by name) compose per window: each window's shortform call
        runs its own capture; score and token-time rows follow the
        kept tokens (token times and words shifted by the window's offset,
        words past the cut dropped), and the attention maps and hidden
        states become per-example lists of per-window dicts keyed by
        ``time_offset`` (windows share no positional layout to stack on)."""
        cfg = self.config
        st = self.special
        b, _, total_frames = feats.shape
        if attention_mask is not None:
            totals = [int(c) for c in np.asarray(attention_mask).reshape(b, -1)
                      .astype(bool).sum(axis=1)]
        else:
            totals = [total_frames] * b
        win = cfg.dims.num_frames
        prompt_len = 3  # [sot, lang, task]: timestamp mode
        user_prompt = (list(np.asarray(prompt_ids, np.int32).reshape(-1))
                       if prompt_ids is not None else None)
        user_prompt_text = None
        if user_prompt:
            user_prompt_text = (user_prompt[1:] if user_prompt[0] == st.start_of_prev
                                else list(user_prompt))
        all_tokens: List[List[int]] = [[] for _ in range(b)]
        all_segments: List[List[dict]] = [[] for _ in range(b)]
        all_lp_rows: List[List[np.ndarray]] = [[] for _ in range(b)]
        all_score_rows: List[List[np.ndarray]] = [[] for _ in range(b)]
        all_tt_rows: List[List[np.ndarray]] = [[] for _ in range(b)]
        all_words: List[List[dict]] = [[] for _ in range(b)]
        all_caps: List[List[dict]] = [[] for _ in range(b)]
        want_caps = bool(captures["return_cross_attentions"]
                         or captures["return_decoder_attentions"]
                         or captures["return_hidden_states"])
        totals_run = {"steps": 0, "accepted": 0}
        inner = dict(task=task, max_length=max_length, max_new_tokens=max_new_tokens,
                     medusa_choices=medusa_choices, disable_medusa=disable_medusa,
                     exponential_decay_length_penalty=exponential_decay_length_penalty,
                     logprob_threshold=logprob_threshold,
                     no_speech_threshold=no_speech_threshold,
                     draft_corruption=draft_corruption, return_timestamps=True,
                     time_precision=time_precision, num_beams=num_beams,
                     length_penalty=length_penalty, logits_processor=logits_processor,
                     temperature=temperature,
                     compression_ratio_threshold=compression_ratio_threshold, seed=seed,
                     **captures)

        def fold_window(i, out, row, p_len, seek):
            """Example i's kept tokens, log-probs, segments and capture
            surfaces from window output row ``row``: (advance in frames,
            kept tokens)."""
            t_off = seek * 0.01
            segs = out.segments[row]
            complete_ends = [sg["end"] for sg in segs if sg["end"] is not None]
            advance, cut_time = win, None
            if complete_ends and seek + win < totals[i]:
                adv = int(round(complete_ends[-1] / 0.01))
                if adv > 0:
                    advance = min(adv, win)
                    cut_time = complete_ends[-1]
                    segs = [sg for sg in segs if sg["end"] is not None]
            raw = np.asarray(out.sequences[row, p_len: out.lengths[row]])
            if cut_time is not None:
                cut = _cut_after_last_complete(raw, st.timestamp_begin, st.eos)
                if cut is not None:
                    raw = raw[:cut]
            keep = raw != st.eos
            if not return_timestamps:
                keep &= raw < st.timestamp_begin
            all_tokens[i].extend(raw[keep].tolist())
            if out.token_logprobs is not None:        # beam windows have none
                lp = np.asarray(out.token_logprobs[row, p_len: p_len + len(raw)])
                all_lp_rows[i].append(lp[keep])
            if out.scores is not None:
                all_score_rows[i].append(out.scores[row, :len(raw)][keep])
            if out.token_timestamps is not None:
                # Rows align with the generated region (the same cut as raw);
                # NaN rows stay NaN.
                all_tt_rows[i].append(out.token_timestamps[row][:len(raw)][keep] + t_off)
            for sg in segs:
                all_segments[i].append({
                    "start": sg["start"] + t_off,
                    "end": None if sg["end"] is None else sg["end"] + t_off,
                    "tokens": sg["tokens"]})
            if out.words is not None:
                all_words[i].extend({**w, "start": w["start"] + t_off, "end": w["end"] + t_off}
                                    for w in out.words[row]
                                    if cut_time is None or w["start"] < cut_time)
            if want_caps:
                entry = {"time_offset": t_off}
                for name in ("cross_attentions", "decoder_attentions",
                             "decoder_hidden_states"):
                    if getattr(out, name) is not None:
                        entry[name] = getattr(out, name)[:, row]
                all_caps[i].append(entry)
            return advance, raw[keep].tolist()

        def window_at(i, seek):
            """Example i's (1, n_mels, win) window from frame ``seek``, padded
            with its own minimum."""
            w = feats[i:i + 1, :, seek: seek + win]
            if w.shape[-1] < win:
                floor = float(w.min()) if w.numel() else 0.0
                w = torch.nn.functional.pad(w, (0, win - w.shape[-1]), value=floor)
            return w

        def live_mask(i, seek):
            return (np.arange(win) < min(max(totals[i] - seek, 0), win)).astype(np.int32)

        def run(window, lang, mask, wprompt):
            out = self.generate(window, language=lang, attention_mask=mask,
                                prompt_ids=wprompt, **inner)
            totals_run["steps"] += out.steps
            return out

        if b > 1 and not condition_on_prev_tokens:
            seeks, active = [0] * b, [True] * b
            guard, guard_max = 0, 4 * (total_frames // win + 2)
            while any(active) and guard < guard_max:
                guard += 1
                windows = torch.cat([window_at(i, seeks[i]) for i in range(b)])
                mask = None if attention_mask is None else np.stack(
                    [live_mask(i, seeks[i]) for i in range(b)])
                # first-segment: round 1 is every example's first window.
                round_prompt = user_prompt if guard == 1 else None
                out = run(windows, language, mask, round_prompt)
                p_len = prompt_len + (len(round_prompt) if round_prompt else 0)
                totals_run["accepted"] += int(sum(out.accepted[i] for i in range(b)
                                                  if active[i]))
                for i in range(b):
                    if not active[i]:
                        continue
                    adv, _ = fold_window(i, out, i, p_len, seeks[i])
                    seeks[i] += adv
                    if seeks[i] >= totals[i]:
                        active[i] = False
            if any(active):
                _warn_longform_truncation([(i, seeks[i], totals[i])
                                           for i in range(b) if active[i]])
        else:
            for i in range(b):
                lang_i = language if (language is None or isinstance(language, str)) \
                    else language[i]
                seek = 0
                guard, guard_max = 0, 4 * (total_frames // win + 2)
                prev_text: List[int] = []
                while seek < totals[i] and guard < guard_max:
                    guard += 1
                    # The rolling context, bucketed, shrunk to fit max_length.
                    fixed = 1 + (len(user_prompt_text) if (
                        user_prompt_text and prompt_condition_type == "all-segments") else 0)
                    room = (max_length or cfg.dims.max_target_positions) - prompt_len - 1
                    bucket = 0
                    if condition_on_prev_tokens and prev_text:
                        for cand in (64, 32, 16):
                            if len(prev_text) >= cand and fixed + cand <= room:
                                bucket = cand
                                break
                    rolling = prev_text[-bucket:] if bucket else []
                    wprompt = None
                    if user_prompt and seek == 0 and prompt_condition_type == "first-segment":
                        wprompt = list(user_prompt)
                    elif user_prompt_text and prompt_condition_type == "all-segments":
                        wprompt = [st.start_of_prev] + user_prompt_text + rolling
                    elif rolling:
                        wprompt = [st.start_of_prev] + rolling
                    mask = None if attention_mask is None else live_mask(i, seek)[None]
                    out = run(window_at(i, seek), lang_i, mask, wprompt)
                    totals_run["accepted"] += int(out.accepted.sum())
                    p_len = prompt_len + (len(wprompt) if wprompt else 0)
                    adv, kept = fold_window(i, out, 0, p_len, seek)
                    prev_text = [t for t in kept if t < st.eos]
                    seek += adv
                if seek < totals[i]:
                    _warn_longform_truncation([(i, seek, totals[i])])
        return _longform_output(
            all_tokens, all_segments, all_lp_rows if num_beams == 1 else None,
            totals_run["steps"], totals_run["accepted"], return_timestamps, st,
            all_score_rows=all_score_rows if captures["return_scores"] == "full" else None,
            vocab_size=cfg.dims.vocab_size,
            all_words=all_words if captures["word_timestamps"] else None,
            all_tt_rows=all_tt_rows if captures["return_token_timestamps"] else None,
            all_caps=all_caps if want_caps else None)

    @_on_mesh
    def score_sequences(self, enc_out, sequences: np.ndarray, lengths: np.ndarray,
                        prompt_len: int) -> np.ndarray:
        """Mean log-probability of each example's generated tokens (positions
        >= ``prompt_len`` and < its length), (B,) float32, by one
        teacher-forced pass (:func:`_avg_logprobs`): the quantity the
        ``logprob_threshold`` fallback reads."""
        enc = torch.as_tensor(enc_out, device=self.device)
        return _avg_logprobs(self.params["whisper"], enc, sequences, lengths, prompt_len,
                             self.config.dims)

    @_on_mesh
    def generate_stream(self, input_features, language: Optional[str] = None,
                        task: str = "transcribe", max_length: Optional[int] = None,
                        chunk_tokens: int = 16, disable_medusa: bool = False):
        """Yield ``(sequences_so_far, lengths, finished)`` every ~``chunk_tokens``
        committed tokens of a greedy shortform decode (no timestamps), the
        loop's state kept on the device between segments; the last yield's
        tokens equal one :meth:`generate` call's."""
        cfg = self.config
        enc_out, prompt, _, pcfg, gen = self._setup(
            self._features(input_features), language=language, task=task,
            max_length=max_length)
        choices, variant, mp = self._decode_mode(disable_medusa)
        run = lambda stop, state: speculative_generate(
            self.params["whisper"], mp, cfg.dims, generate_medusa_buffers(choices), pcfg,
            gen, enc_out, torch.as_tensor(prompt, device=self.device), variant=variant,
            resume_state=state, stop_len=stop, return_state=True)
        result, state = run(prompt.shape[1] + chunk_tokens, None)
        while True:
            lengths = result.lengths.cpu().numpy()
            finished = bool(state.finished.all())
            yield result.tokens.cpu().numpy(), lengths, finished
            if finished:
                return
            result, state = run(int(lengths.max()) + chunk_tokens, state)


def require_servable_dtype(params, device) -> None:
    """Serving on the card takes all-bf16 weights, all-f32 weights (the JAX
    package's default dtype: the f32 modes of K1, K3, K4, K5, K10 and K11,
    the per-op decoder step), the int8 copy of a bf16 model and the int8
    copy of an f32 model (int8 streamed weights beside f32 norms, biases,
    encoder and positions: the W8A32 modes of K2, K4, K5, head_rows and
    K10).  Weights that mix bf16 and f32 raise NotImplementedError before
    anything runs; f32 weights, int8 copy or not, raise ValueError while
    cuBLAS may use TF32 (the encoder's f32 products run there).  CPU
    serving takes any dtype."""
    if torch.device(device).type != "cuda":
        return
    flat = bridge.flatten(params)
    # An int8 weight's f32 scales ({"q", "s"}) belong to the int8 copy.
    scales = {k for k in flat if k.endswith("/s") and f"{k[:-2]}/q" in flat}
    floats = {a.dtype for k, a in flat.items() if a.is_floating_point() and k not in scales}
    if len(floats) > 1:
        raise NotImplementedError(
            f"weights of mixed dtypes {sorted(str(d) for d in floats)} are not served on "
            "the card: cast the model to one of bfloat16 or float32")
    if torch.float32 in floats and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError(
            "f32 serving on the card takes full-f32 products, but "
            "torch.backends.cuda.matmul.allow_tf32 is True (TF32 keeps about three "
            "decimal digits); set it to False")


def _check_beam_options(num_beams: int, temperature, compression_ratio_threshold,
                        logprob_threshold, no_speech_threshold, captures) -> None:
    """Beam search takes no temperature fallback, no quality thresholds and
    no capture surface: ValueError naming each, as the JAX package raises."""
    temps = tuple(np.atleast_1d(temperature).tolist())
    unsupported = []
    if any(float(t) != 0.0 for t in temps) or len(temps) > 1:
        unsupported.append("temperature fallback")
    for name, v in (("compression_ratio_threshold", compression_ratio_threshold),
                    ("logprob_threshold", logprob_threshold),
                    ("no_speech_threshold", no_speech_threshold)):
        if v is not None:
            unsupported.append(name)
    if captures["return_scores"] == "full" or any(captures[name] for name in (
            "return_cross_attentions", "word_timestamps", "return_decoder_attentions",
            "return_hidden_states", "return_token_timestamps")):
        unsupported.append("full scores/attentions/hidden states/word timestamps")
    if unsupported:
        raise ValueError(
            f"num_beams={num_beams} does not support: {', '.join(unsupported)} "
            "(sampling/fallback is a greedy-path feature; run beams at temperature=0 "
            "without thresholds)")


def _compression_ratio(token_ids: np.ndarray, vocab_size: int) -> float:
    """The compression ratio of a token row as transformers'
    ``_retrieve_compression_ratio`` computes it: each token packed
    little-endian into ``int(log2(vocab) / 8) + 1`` bytes, the length over
    the zlib-compressed length."""
    length = int(np.log2(vocab_size) / 8) + 1
    seq = b"".join(int(t).to_bytes(length, "little") for t in token_ids.tolist())
    if not seq:
        return 0.0
    return len(seq) / max(len(zlib.compress(seq)), 1)


def _needs_fallback(tokens, lengths, prompt_len, compression_ratio_threshold,
                    avg_logprobs=None, logprob_threshold=None,
                    vocab_size: int = 51865) -> np.ndarray:
    """(B,) bool: the examples the temperature ladder decodes again — the
    generated tokens compress by more than ``compression_ratio_threshold``,
    or their mean log-prob is below ``logprob_threshold``."""
    b = tokens.shape[0]
    bad = np.zeros((b,), bool)
    if compression_ratio_threshold is not None:
        for i in range(b):
            ratio = _compression_ratio(tokens[i, prompt_len: lengths[i]], vocab_size)
            bad[i] |= ratio > compression_ratio_threshold
    if logprob_threshold is not None and avg_logprobs is not None:
        bad |= np.asarray(avg_logprobs) < logprob_threshold
    return bad


def _avg_from_captured(logprobs: np.ndarray, lengths: np.ndarray,
                       prompt_len: int) -> np.ndarray:
    """Mean generated-token logprob from the loop-captured per-token scores."""
    pos = np.arange(logprobs.shape[1])[None, :]
    mask = (pos >= prompt_len) & (pos < lengths[:, None])
    return np.where(mask, logprobs, 0.0).sum(-1) / np.maximum(mask.sum(-1), 1)


@torch.no_grad()
def _avg_logprobs(params, enc_out: torch.Tensor, sequences, lengths, prompt_len: int,
                  dims) -> np.ndarray:
    """Teacher-forced mean log-prob of the generated tokens: one
    ``decode_train`` pass over ``sequences[:, :-1]`` (K1; the int8 branch on
    a quantized model), K3 (K7 at int8) over the (B, L - 1) rows,
    ``log_softmax`` and a gather at ``sequences[:, 1:]``."""
    dev = enc_out.device
    seq = torch.as_tensor(np.asarray(sequences), dtype=torch.int64, device=dev)
    hidden = whisper.decode_train(params, dims, seq[:, :-1], enc_out).hidden
    logp = torch.log_softmax(whisper.project_logits(params, hidden), dim=-1)
    tgt = seq[:, 1:]
    tok_lp = torch.gather(logp, -1, tgt[..., None])[..., 0]
    pos = torch.arange(tgt.shape[1], device=dev)[None, :]
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int64, device=dev)
    mask = (pos >= prompt_len - 1) & (pos < (lens - 1)[:, None])
    total = torch.where(mask, tok_lp, torch.zeros((), device=dev)).sum(-1)
    return (total / mask.sum(-1).clamp(min=1)).cpu().numpy()


def _warn_longform_truncation(dropped: List[Tuple[int, int, int]]) -> None:
    """Report (not fatal) where the seek loop's guard stopped an example
    before its end: the audio past the seek was dropped."""
    for i, seek, total in dropped:
        logging.getLogger("whisper_medusa_tpu_torch").warning(
            "longform guard tripped for example %d: seek stalled at mel frame %d of %d "
            "- audio beyond %.1f s was dropped", i, seek, total, seek * 0.01)


def _longform_output(all_tokens, all_segments, all_lp_rows, steps_total: int,
                     accepted_total: int, return_timestamps: bool,
                     st: SpecialTokens, all_score_rows=None, vocab_size: int = 0,
                     all_words=None, all_tt_rows=None, all_caps=None) -> GenerateOutput:
    """The seek loop's transcript: (B, longest + 1) EOS-padded sequences, each
    kept token's log-prob and their mean (None without ``all_lp_rows``), the
    summed steps and accepts; and the capture surfaces folded per window:
    ``scores`` (B, longest + 1, V) from ``all_score_rows``, ``words``
    (attached to the segments), ``token_timestamps`` and the per-window
    capture entries under ``cross_attentions``."""
    b = len(all_tokens)
    max_len_out = max((len(t) for t in all_tokens), default=0) + 1
    sequences = np.full((b, max_len_out), st.eos, np.int32)
    lengths = np.zeros((b,), np.int32)
    for i, toks in enumerate(all_tokens):
        sequences[i, :len(toks)] = toks
        lengths[i] = len(toks)
    token_logprobs = avg_logprobs = None
    if all_lp_rows is not None:
        token_logprobs = np.zeros((b, max_len_out), np.float32)
        avg_logprobs = np.zeros((b,), np.float32)
        for i, rows in enumerate(all_lp_rows):
            lp = np.concatenate(rows) if rows else np.zeros((0,), np.float32)
            token_logprobs[i, :len(lp)] = lp
            avg_logprobs[i] = lp.mean() if len(lp) else 0.0
    scores = None
    if all_score_rows is not None:
        scores = np.zeros((b, max_len_out, vocab_size), np.float32)
        for i, rows in enumerate(all_score_rows):
            if rows:
                stack = np.concatenate(rows, axis=0)
                scores[i, :stack.shape[0]] = stack
    if all_words is not None and return_timestamps and all_segments:
        _attach_words_to_segments(all_segments, all_words)
    token_tts = None
    if all_tt_rows is not None:
        token_tts = [np.concatenate(rows, axis=0) if rows else np.zeros((0, 2), np.float64)
                     for rows in all_tt_rows]
    return GenerateOutput(
        sequences=sequences, lengths=lengths, steps=steps_total,
        accepted=np.asarray([accepted_total]),
        mean_accept_length=accepted_total / max(steps_total, 1),
        segments=all_segments if return_timestamps else None,
        token_logprobs=token_logprobs, avg_logprobs=avg_logprobs, scores=scores,
        words=all_words, token_timestamps=token_tts, cross_attentions=all_caps)


def _extract_segments(tokens: np.ndarray, length: int, prompt_len: int,
                      time_precision: float = 0.02,
                      special: Optional[SpecialTokens] = None) -> List[dict]:
    """Split a timestamped token sequence into segments: consecutive
    timestamp pairs bracket text spans; a trailing open timestamp with text
    gives a segment whose ``end`` is None."""
    st = special or SpecialTokens()
    ts_begin = st.timestamp_begin
    segments: List[dict] = []
    start_ts = None
    text: List[int] = []
    for tok in tokens[prompt_len:length].tolist():
        if tok >= ts_begin:
            if start_ts is None:
                start_ts = tok
            else:
                segments.append({"start": (start_ts - ts_begin) * time_precision,
                                 "end": (tok - ts_begin) * time_precision,
                                 "tokens": text})
                start_ts, text = None, []
        elif tok == st.eos:
            break
        else:
            text.append(tok)
    if start_ts is not None and text:
        segments.append({"start": (start_ts - ts_begin) * time_precision, "end": None,
                         "tokens": text})
    return segments


def _attach_words_to_segments(segments: List[List[dict]], words: List[List[dict]]) -> None:
    """Attach each word dict to the segment whose [start, end) holds the
    word's midpoint (an open segment's end is infinite), else to the segment
    that starts nearest the word; every segment gets a ``words`` list."""
    for segs, wrds in zip(segments, words):
        for seg in segs:
            seg["words"] = []
        for w in wrds:
            mid = 0.5 * (w["start"] + w["end"])
            target = None
            for seg in segs:
                end = seg["end"] if seg["end"] is not None else float("inf")
                if seg["start"] <= mid < end:
                    target = seg
                    break
            if target is None and segs:
                target = min(segs, key=lambda sg: abs(sg["start"] - w["start"]))
            if target is not None:
                target["words"].append(w)


def _cut_after_last_complete(raw: np.ndarray, ts_begin: int, eos: int) -> Optional[int]:
    """One past the closing timestamp of the last complete segment (the
    pairing of :func:`_extract_segments`), or None when none closes before
    EOS."""
    cut = None
    start_seen = False
    for j, tok in enumerate(raw.tolist()):
        if tok == eos:
            break
        if tok >= ts_begin:
            if start_seen:
                cut = j + 1
                start_seen = False
            else:
                start_seen = True
    return cut
