"""Model / generation configuration of the PyTorch port — the port's own copy
of whisper_medusa_tpu/config.py.

The field names, defaults and ``config.json`` format are the JAX package's, so
a checkpoint written by either package loads in the other unchanged; tests
that drive both convert with ``ModelConfig.from_dict(other.to_dict())``.

Mirrors the reference configuration surface (reference:
whisper_medusa/utils/config_and_args.py:17-62  ``MedusaConfig(WhisperConfig)`` and
whisper_medusa/models/medusa_utils.py:14-18  ``MedusaGenerationConfig``) as plain
frozen dataclasses: everything that fixes shapes (layer counts, head counts, cache
lengths, number of medusa heads) is static Python, everything that is data
(weights) lives in the params tree.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


# Whisper vocabulary constants (multilingual v2 vocabulary).  These are
# architectural constants of the public OpenAI Whisper tokenizer, mirrored from the
# generation config the reference inherits from `openai/whisper-large-v2`.
EOS_TOKEN_ID = 50257
SOT_TOKEN_ID = 50258            # <|startoftranscript|> == decoder_start_token_id
FIRST_LANGUAGE_TOKEN_ID = 50259  # <|en|>; language tokens are contiguous
TASK_TRANSLATE_ID = 50358
TASK_TRANSCRIBE_ID = 50359
NO_SPEECH_ID = 50362
NO_TIMESTAMPS_ID = 50363
TIMESTAMP_BEGIN_ID = 50364

# Language code ordering of the multilingual Whisper tokenizer; language token id is
# FIRST_LANGUAGE_TOKEN_ID + index in this tuple.  (Public constant from the Whisper
# tokenizer; the reference resolves languages through HF's tokenizer instead.)
WHISPER_LANGUAGES: Tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca", "nl",
    "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms", "cs", "ro",
    "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la", "mi", "ml", "cy",
    "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn", "et", "mk", "br", "eu",
    "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw", "gl", "mr", "pa", "si", "km",
    "sn", "yo", "so", "af", "oc", "ka", "be", "tg", "sd", "gu", "am", "yi", "lo",
    "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my", "bo", "tl", "mg",
    "as", "tt", "haw", "ln", "ha", "ba", "jw", "su",
)


def language_token_id(language: str, special: "SpecialTokens" = None) -> int:
    """Map a language code (e.g. ``"en"``) to its Whisper token id."""
    langs = special.languages if special is not None else WHISPER_LANGUAGES
    first = special.first_language if special is not None else FIRST_LANGUAGE_TOKEN_ID
    lang = language.lower().strip("<|>").replace("_", "-")
    if lang not in langs:
        raise ValueError(f"Unsupported language: {language!r}")
    return first + langs.index(lang)


@dataclass(frozen=True)
class SpecialTokens:
    """Whisper special-token ids, derived from the vocabulary layout.

    The reference reads these from the checkpoint's HF generation config at load
    time (reference: whisper_medusa/models/model.py:279-290, 1177-1186).  We derive
    them structurally: the v3 vocabulary (51866) inserts ``<|yue|>`` at the end of
    the language block, shifting every id after it by one — so hardcoded v2
    constants would mis-tokenize v3 checkpoints.  Checkpoint generation configs
    can still override individual ids via :meth:`WhisperMedusaModel.from_pretrained`.
    """

    eos: int = 50257                 # <|endoftext|>
    sot: int = 50258                 # <|startoftranscript|>
    first_language: int = 50259      # <|en|>; language tokens are contiguous
    num_languages: int = 99
    translate: int = 50358
    transcribe: int = 50359
    start_of_lm: int = 50360
    start_of_prev: int = 50361
    no_speech: int = 50362
    no_timestamps: int = 50363
    timestamp_begin: int = 50364     # <|0.00|>

    @classmethod
    def for_vocab(cls, vocab_size: int) -> "SpecialTokens":
        num_languages = 100 if vocab_size >= 51866 else 99
        base = 50259 + num_languages
        return cls(
            num_languages=num_languages,
            translate=base, transcribe=base + 1, start_of_lm=base + 2,
            start_of_prev=base + 3, no_speech=base + 4, no_timestamps=base + 5,
            timestamp_begin=base + 6,
        )

    @property
    def languages(self) -> Tuple[str, ...]:
        return WHISPER_LANGUAGES + (("yue",) if self.num_languages == 100 else ())

    def language_token_id(self, language: str) -> int:
        return language_token_id(language, self)


@dataclass(frozen=True)
class WhisperDims:
    """Static architecture dimensions of a Whisper model.

    Defaults are whisper-large-v2 (the reference's base model,
    reference: whisper_medusa/utils/config_and_args.py:40).
    """

    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    decoder_layers: int = 32
    decoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    decoder_ffn_dim: int = 5120
    max_source_positions: int = 1500   # encoder output frames (3000 mel frames / 2)
    max_target_positions: int = 448

    @property
    def head_dim(self) -> int:
        return self.d_model // self.decoder_attention_heads

    @property
    def num_frames(self) -> int:
        """Mel-spectrogram frames per 30 s segment (conv stride 2 halves this)."""
        return 2 * self.max_source_positions

    @property
    def special(self) -> "SpecialTokens":
        """Special-token ids implied by this vocabulary (v2 vs v3 layout)."""
        return SpecialTokens.for_vocab(self.vocab_size)


# Known Whisper model sizes, keyed by short name.
WHISPER_PRESETS = {
    "tiny": WhisperDims(d_model=384, encoder_layers=4, decoder_layers=4,
                        encoder_attention_heads=6, decoder_attention_heads=6,
                        encoder_ffn_dim=1536, decoder_ffn_dim=1536),
    "base": WhisperDims(d_model=512, encoder_layers=6, decoder_layers=6,
                        encoder_attention_heads=8, decoder_attention_heads=8,
                        encoder_ffn_dim=2048, decoder_ffn_dim=2048),
    "small": WhisperDims(d_model=768, encoder_layers=12, decoder_layers=12,
                         encoder_attention_heads=12, decoder_attention_heads=12,
                         encoder_ffn_dim=3072, decoder_ffn_dim=3072),
    "medium": WhisperDims(d_model=1024, encoder_layers=24, decoder_layers=24,
                          encoder_attention_heads=16, decoder_attention_heads=16,
                          encoder_ffn_dim=4096, decoder_ffn_dim=4096),
    "large": WhisperDims(),
    "large-v2": WhisperDims(),
    "large-v3": WhisperDims(num_mel_bins=128, vocab_size=51866),
}


# The default token-suppression list of the public whisper-large-v2 generation config.
# The reference pulls this from the HF generation config at runtime
# (reference: whisper_medusa/models/model.py:1177-1186); we ship it as a constant so the
# framework works without network access, and override it from checkpoint metadata when
# available.
DEFAULT_SUPPRESS_TOKENS: Tuple[int, ...] = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63, 90, 91,
    92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350, 1853, 1982, 2460,
    2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667, 6585, 6647, 7273, 9061,
    9383, 10428, 10929, 11938, 12033, 12331, 12562, 13793, 14157, 14635, 15265, 15618,
    16553, 16604, 18362, 18956, 20075, 21675, 22520, 26130, 26161, 26435, 28279,
    29464, 31650, 32302, 32470, 36865, 42863, 47425, 49870, 50254, 50258, 50358,
    50359, 50360, 50361, 50362,
)
DEFAULT_BEGIN_SUPPRESS_TOKENS: Tuple[int, ...] = (220, 50257)


def default_suppress_tokens(special: SpecialTokens) -> Tuple[int, ...]:
    """The standard Whisper suppress list for a given vocabulary layout.

    The text-token entries are vocabulary-invariant; the special-token tail of the
    published list (sot, translate, transcribe, startoflm, startofprev, nospeech —
    the 50258+ entries of DEFAULT_SUPPRESS_TOKENS) is re-derived from ``special``
    so v3 checkpoints suppress the right (shifted) ids.
    """
    text = tuple(t for t in DEFAULT_SUPPRESS_TOKENS if t < 50258)
    tail = (special.sot, special.translate, special.transcribe,
            special.start_of_lm, special.start_of_prev, special.no_speech)
    return text + tail


def default_begin_suppress_tokens(special: SpecialTokens) -> Tuple[int, ...]:
    return (220, special.eos)


@dataclass(frozen=True)
class MedusaConfig:
    """Medusa speculative-decoding configuration.

    Mirrors the reference ``MedusaConfig`` fields
    (reference: whisper_medusa/utils/config_and_args.py:35-62) with the same defaults
    the training CLI uses (reference: whisper_medusa/utils/utils.py — CLI default is
    10 heads / 11 ones in ``medusa_choices``).
    """

    medusa_num_heads: int = 10
    medusa_num_layers: int = 1
    medusa_hidden_size: int = 1280
    # Per-level branching factors, length == medusa_num_heads + 1; all-ones == chain.
    # (reference: config_and_args.py:41, medusa_utils.py:305)
    medusa_choices: Tuple[int, ...] = tuple([1] * 11)
    medusa_heads_type: str = "base_head"  # "base_head" (Linear) | "medusa_block"
    medusa_loss_on_original: bool = False
    medusa_kl_loss: bool = False
    medusa_kl_weight: float = 0.0
    output_whisper_original: bool = False

    def __post_init__(self):
        if self.medusa_heads_type not in ("base_head", "medusa_block"):
            raise ValueError(
                f"medusa_heads_type {self.medusa_heads_type!r} is not supported, "
                "select from ['base_head', 'medusa_block']"
            )
        if len(self.medusa_choices) != self.medusa_num_heads + 1:
            raise ValueError(
                f"medusa_choices must have medusa_num_heads+1={self.medusa_num_heads + 1} "
                f"entries, got {len(self.medusa_choices)}"
            )


@dataclass(frozen=True)
class GenerationConfig:
    """Generation-time knobs.

    Mirrors the live subset of the reference ``MedusaGenerationConfig``
    (reference: whisper_medusa/models/medusa_utils.py:14-18 plus the HF fields the
    decode loop consumes, model.py:404-835).
    """

    max_length: int = 448
    eos_token_id: int = EOS_TOKEN_ID
    pad_token_id: int = EOS_TOKEN_ID
    decoder_start_token_id: int = SOT_TOKEN_ID
    suppress_tokens: Optional[Tuple[int, ...]] = DEFAULT_SUPPRESS_TOKENS
    begin_suppress_tokens: Optional[Tuple[int, ...]] = DEFAULT_BEGIN_SUPPRESS_TOKENS
    # (regulation_start, regulation_factor); None disables.
    # (reference: eval_whisper_medusa.py:53-65, README.md:116-117)
    exponential_decay_length_penalty: Optional[Tuple[int, float]] = None
    # Typical-acceptance hyperparameters (reference: medusa_utils.py:14-18).
    posterior_threshold: float = 0.09
    posterior_alpha: float = 0.3
    temperature: float = 0.0
    # Temperature-fallback ladder + thresholds (reference: model.py:1842-2013).
    temperature_fallback: Tuple[float, ...] = (0.0,)
    compression_ratio_threshold: Optional[float] = None
    logprob_threshold: Optional[float] = None
    no_speech_threshold: Optional[float] = None
    return_timestamps: bool = False
    max_initial_timestamp_index: int = 50
    # (layer, head) pairs of the cross-attention heads that track time —
    # consumed by word-level timestamp DTW (decoding/word_timestamps.py).
    # HF checkpoints ship this in generation_config.json as `alignment_heads`.
    alignment_heads: Optional[Tuple[Tuple[int, int], ...]] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "GenerationConfig":
        d = {k: v for k, v in d.items()
             if k in {f.name for f in dataclasses.fields(cls)}}
        for k in ("suppress_tokens", "begin_suppress_tokens",
                  "exponential_decay_length_penalty", "temperature_fallback"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        if d.get("alignment_heads") is not None:
            d["alignment_heads"] = tuple(
                tuple(int(x) for x in pair) for pair in d["alignment_heads"])
        return cls(**d)


@dataclass(frozen=True)
class ModelConfig:
    """Top-level model configuration: Whisper dims + Medusa + dtype policy."""

    dims: WhisperDims = field(default_factory=WhisperDims)
    medusa: MedusaConfig = field(default_factory=MedusaConfig)
    # Computation dtypes.  Params are stored in `param_dtype`; activations are cast to
    # `compute_dtype`; softmax/layernorm/logits accumulate in float32 regardless.
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    whisper_model_name: str = "openai/whisper-large-v2"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        d = dict(d)
        dims = WhisperDims(**d.pop("dims"))
        med = d.pop("medusa")
        med["medusa_choices"] = tuple(med["medusa_choices"])
        medusa = MedusaConfig(**med)
        return cls(dims=dims, medusa=medusa, **d)

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, directory: str) -> "ModelConfig":
        with open(os.path.join(directory, "config.json")) as f:
            return cls.from_dict(json.load(f))


def tiny_test_config(
    vocab_size: int = 256,
    medusa_num_heads: int = 3,
    medusa_heads_type: str = "base_head",
    max_source_positions: int = 32,
    max_target_positions: int = 64,
) -> ModelConfig:
    """A miniature config for fast unit tests (CPU-friendly shapes)."""
    dims = WhisperDims(
        vocab_size=vocab_size,
        num_mel_bins=16,
        d_model=32,
        encoder_layers=2,
        decoder_layers=2,
        encoder_attention_heads=2,
        decoder_attention_heads=2,
        encoder_ffn_dim=64,
        decoder_ffn_dim=64,
        max_source_positions=max_source_positions,
        max_target_positions=max_target_positions,
    )
    medusa = MedusaConfig(
        medusa_num_heads=medusa_num_heads,
        medusa_hidden_size=dims.d_model,
        medusa_choices=tuple([1] * (medusa_num_heads + 1)),
        medusa_heads_type=medusa_heads_type,
    )
    return ModelConfig(dims=dims, medusa=medusa)
