"""Word-level timestamps via cross-attention DTW alignment — a copy of
whisper_medusa_tpu/decoding/word_timestamps.py (numpy and the standard
library only), kept in the port so that it imports nothing of the JAX
package; its functions give that module's outputs bit for bit.

The OpenAI-Whisper word-alignment recipe on top of the post-hoc capture:

  1. ONE teacher-forced decoder pass over the committed sequence captures the
     alignment heads' cross-attention maps
     (models/whisper.py::decode_train_cross_attn, ``select=`` keeps only the
     configured (layer, head) pairs).
  2. Host-side: softmax rows are std-normalized per head, median-filtered along
     time, averaged over heads, and monotonically aligned with DTW.
  3. Token boundaries become word boundaries via byte-level BPE-aware
     splitting (data/bpe.py), robust to multi-token UTF-8 codepoints.

The serving loop is untouched — word timestamps cost one extra teacher-forced
pass per utterance, off the decode hot path.
"""

from __future__ import annotations

import string
from typing import List, Sequence, Tuple

import numpy as np

# Encoder output frames are 20 ms each (2 mel hops of 10 ms per position).
SECONDS_PER_ENC_FRAME = 0.02

_REPLACEMENT = "\ufffd"
# Characters a subword may start/end with without beginning/ending a word.
_PREPEND_PUNCT = "\"'\u201c\u00bf([{-"
_APPEND_PUNCT = "\"'.\u3002,\uff0c!\uff01?\uff1f:\uff1a\u201d)]}\u3001"


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis with reflect padding (odd width)."""
    if width <= 1 or x.shape[-1] == 0:
        return x
    width = min(width, x.shape[-1] if x.shape[-1] % 2 == 1
                else x.shape[-1] - 1)
    if width < 3:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through a (T_text, T_time) cost matrix.

    Returns (text_indices, time_indices) of the lowest-cost path from (0, 0)
    to (T-1, S-1), allowing (+1, 0), (0, +1) and (+1, +1) moves — the classic
    Whisper alignment recurrence.
    """
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf, np.float64)
    trace = np.zeros((n + 1, m + 1), np.int8)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        row_c = cost[i - 1]
        prev, cur = acc[i - 1], acc[i]
        tr = trace[i]
        for j in range(1, m + 1):
            c0, c1, c2 = prev[j - 1], prev[j], cur[j - 1]
            if c0 <= c1 and c0 <= c2:
                best, t = c0, 0       # diagonal
            elif c1 < c2:
                best, t = c1, 1       # advance text only
            else:
                best, t = c2, 2       # advance time only
            cur[j] = row_c[j - 1] + best
            tr[j] = t
    i, j = n, m
    text_idx, time_idx = [], []
    while i > 0 or j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        t = trace[i, j]
        if i > 0 and (t == 0 or t == 1 or j == 0):
            i -= 1
        if j > 0 and (t == 0 or t == 2):
            j -= 1
        if t == 1 and j > 0 and i == 0:
            j -= 1
    return np.array(text_idx[::-1]), np.array(time_idx[::-1])


def alignment_matrix(maps: np.ndarray, num_frames: int,
                     filter_width: int = 7) -> np.ndarray:
    """(N_heads, T, S) softmax maps -> (T, num_frames) alignment weights.

    Per the OpenAI recipe: restrict to the live audio frames, z-normalize each
    head over time, median-filter along time, average heads.
    """
    w = maps[:, :, :num_frames].astype(np.float64)
    mean = w.mean(-2, keepdims=True)
    std = w.std(-2, keepdims=True)
    w = (w - mean) / np.maximum(std, 1e-10)
    w = median_filter(w, filter_width)
    return w.mean(0)


def token_times(maps: np.ndarray, num_frames: int,
                filter_width: int = 7) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token (start, end) times in seconds from alignment-head maps.

    ``maps``: (N_heads, T, S) — cross-attention of each generated token row.
    Token ``t``'s span is the contiguous run of time indices DTW assigns to
    text index ``t``.
    """
    matrix = alignment_matrix(maps, num_frames, filter_width)
    text_idx, time_idx = dtw_path(-matrix)
    t = matrix.shape[0]
    starts = np.zeros((t,), np.float64)
    ends = np.zeros((t,), np.float64)
    # First time index assigned to each text index = start; the next token's
    # start is this token's end.
    jumps = np.concatenate([[True], np.diff(text_idx) > 0])
    jump_times = time_idx[jumps] * SECONDS_PER_ENC_FRAME
    starts[text_idx[jumps]] = jump_times
    ends[:-1] = starts[1:]
    ends[-1] = num_frames * SECONDS_PER_ENC_FRAME
    return starts, ends


def split_tokens_on_unicode(tokens: Sequence[int], tokenizer
                            ) -> Tuple[List[str], List[List[int]]]:
    """Group token ids into minimal valid-UTF-8 subwords.

    Byte-level BPE can split a codepoint across tokens; a group is closed only
    once its bytes decode without a replacement char (or the full text really
    contains one at that offset)."""
    full = tokenizer.decode(tokens, skip_special_tokens=True)
    words: List[str] = []
    word_tokens: List[List[int]] = []
    current: List[int] = []
    offset = 0
    for tok in tokens:
        current.append(int(tok))
        decoded = tokenizer.decode(current, skip_special_tokens=True)
        pos = decoded.find(_REPLACEMENT)
        if (pos == -1
                or (offset + pos < len(full)
                    and full[offset + pos] == _REPLACEMENT)):
            words.append(decoded)
            word_tokens.append(current)
            current = []
            offset += len(decoded)
    if current:
        words.append(tokenizer.decode(current, skip_special_tokens=True))
        word_tokens.append(current)
    return words, word_tokens


def merge_punctuations(words: List[str], word_tokens: List[List[int]],
                       prepended: str = _PREPEND_PUNCT,
                       appended: str = _APPEND_PUNCT) -> None:
    """In-place punctuation merge (OpenAI's ``merge_punctuations``): leading
    quotes/brackets glue onto the following word, trailing punctuation onto
    the preceding one.  Emptied slots are left as "" for the caller to drop."""
    i, j = len(words) - 2, len(words) - 1
    while i >= 0:
        if words[i].startswith(" ") and words[i].strip() in prepended:
            words[j] = words[i] + words[j]
            word_tokens[j] = word_tokens[i] + word_tokens[j]
            words[i] = ""
            word_tokens[i] = []
        else:
            j = i
        i -= 1
    i, j = 0, 1
    while j < len(words):
        if not words[i].endswith(" ") and words[j] in appended:
            words[i] = words[i] + words[j]
            word_tokens[i] = word_tokens[i] + word_tokens[j]
            words[j] = ""
            word_tokens[j] = []
        else:
            i = j
        j += 1


def split_tokens_on_spaces(tokens: Sequence[int], tokenizer
                           ) -> Tuple[List[str], List[List[int]]]:
    """Space/punctuation-aware word grouping (languages with spaces).

    A subword starts a new word when it begins with a space or is bare
    punctuation; a second pass glues punctuation onto its neighbor (the exact
    OpenAI ``split_tokens_on_spaces`` + ``merge_punctuations`` recipe)."""
    subwords, sub_tokens = split_tokens_on_unicode(tokens, tokenizer)
    words: List[str] = []
    word_tokens: List[List[int]] = []
    for sw, st in zip(subwords, sub_tokens):
        stripped = sw.strip()
        starts_new = (len(words) == 0
                      or sw.startswith(" ")
                      or (len(stripped) > 0
                          and all(c in string.punctuation for c in stripped)))
        if starts_new:
            words.append(sw)
            word_tokens.append(list(st))
        else:
            words[-1] += sw
            word_tokens[-1] += list(st)
    merge_punctuations(words, word_tokens)
    keep = [k for k, w in enumerate(words) if w]
    return [words[k] for k in keep], [word_tokens[k] for k in keep]


def words_with_times(
    gen_tokens: Sequence[int],       # generated tokens (text + ts + EOS)
    maps: np.ndarray,                # (N_heads, T_gen, S) — row i = gen token i
    tokenizer,
    num_frames: int,
    eos_id: int,
    timestamp_begin: int,
    time_offset: float = 0.0,
    filter_width: int = 7,
    token_spans: np.ndarray = None,
) -> List[dict]:
    """Word dicts [{"word", "start", "end"}] for one example.

    ``maps`` rows must correspond 1:1 with ``gen_tokens``.  Only text-token
    rows enter the DTW (OpenAI aligns the text rows of the teacher-forced
    pass; timestamp/EOS rows are dropped before building the cost matrix).
    ``token_spans``: optional precomputed (T_gen, 2) per-token times from
    :func:`per_token_times` on the same rows — reused instead of re-running
    the DTW when the caller wants both surfaces.
    """
    gen_tokens = [int(t) for t in gen_tokens]
    is_text = [t < eos_id for t in gen_tokens]
    text_tokens = [t for t, keep in zip(gen_tokens, is_text) if keep]
    if not text_tokens:
        return []
    text_rows = np.array([i for i, keep in enumerate(is_text) if keep])
    if token_spans is not None:
        starts = token_spans[text_rows, 0]
        ends = token_spans[text_rows, 1]
    else:
        starts, ends = token_times(maps[:, text_rows], num_frames,
                                   filter_width)
    words, word_tokens = split_tokens_on_spaces(text_tokens, tokenizer)
    out: List[dict] = []
    row = 0
    for w, toks in zip(words, word_tokens):
        rows = list(range(row, row + len(toks)))
        row += len(toks)
        if not w.strip() or not rows:
            continue
        out.append({
            "word": w,
            "start": round(time_offset + float(starts[rows[0]]), 3),
            "end": round(time_offset + float(ends[rows[-1]]), 3),
        })
    return out


def per_token_times(
    gen_tokens: Sequence[int],       # generated tokens (text + ts + EOS)
    maps: np.ndarray,                # (N_heads, T_gen, S) — row i = gen token i
    num_frames: int,
    eos_id: int,
    time_offset: float = 0.0,
    filter_width: int = 7,
) -> np.ndarray:
    """(T_gen, 2) DTW start/end seconds per generated token.

    The per-token surface behind HF's ``return_token_timestamps`` (consumed by
    the reference only in its unreachable shortform tail, model.py:1781-1840);
    same recipe as :func:`words_with_times` — only text-token rows enter the
    DTW, timestamp/EOS rows come back NaN."""
    gen_tokens = [int(t) for t in gen_tokens]
    out = np.full((len(gen_tokens), 2), np.nan, np.float64)
    text_rows = np.array(
        [i for i, t in enumerate(gen_tokens) if t < eos_id], np.int64)
    if text_rows.size == 0:
        return out
    starts, ends = token_times(maps[:, text_rows], num_frames, filter_width)
    out[text_rows, 0] = time_offset + starts
    out[text_rows, 1] = time_offset + ends
    return out


def default_alignment_heads(decoder_layers: int, decoder_heads: int
                            ) -> Tuple[Tuple[int, int], ...]:
    """Fallback when a checkpoint ships no ``alignment_heads``: every head of
    the upper half of the decoder (OpenAI's fallback for unknown models)."""
    return tuple((l, h)
                 for l in range(decoder_layers // 2, decoder_layers)
                 for h in range(decoder_heads))
