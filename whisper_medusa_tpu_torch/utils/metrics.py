"""WER/CER metrics with jiwer-compatible normalization (self-contained): the
port's own copy of whisper_medusa_tpu/utils/metrics.py (standard library
only, as there).

Mirrors the reference's metric pipeline (reference: whisper_medusa/utils/
metrics.py:5-84) which uses jiwer transforms; jiwer is not available in this
environment, so the transforms (lowercase, expand common English contractions,
remove Kaldi non-words, collapse whitespace, remove punctuation) and the
Levenshtein S/D/I counting are implemented here and unit-tested against known
values.  Corpus aggregation matches the reference:
``incorrect / total = (S+D+I) / (S+D+H)`` summed over utterances.
"""

from __future__ import annotations

import re
import string
import unicodedata
from typing import Dict, List, Sequence, Tuple

# jiwer ExpandCommonEnglishContractions equivalents.
_CONTRACTIONS = [
    (re.compile(r"won't", re.I), "will not"),
    (re.compile(r"can't", re.I), "can not"),
    (re.compile(r"let's", re.I), "let us"),
    (re.compile(r"n't", re.I), " not"),
    (re.compile(r"'re", re.I), " are"),
    (re.compile(r"'s", re.I), " is"),
    (re.compile(r"'d", re.I), " would"),
    (re.compile(r"'ll", re.I), " will"),
    (re.compile(r"'t", re.I), " not"),
    (re.compile(r"'ve", re.I), " have"),
    (re.compile(r"'m", re.I), " am"),
]
_KALDI_NON_WORDS = re.compile(r"[<\[][^>\]]*[>\]]")
_PUNCT = set(string.punctuation)


def _remove_punct(s: str) -> str:
    return "".join(
        c for c in s
        if c not in _PUNCT and not unicodedata.category(c).startswith("P"))


def normalize_wer(s: str) -> List[str]:
    s = s.lower()
    for pat, rep in _CONTRACTIONS:
        s = pat.sub(rep, s)
    s = _KALDI_NON_WORDS.sub("", s)
    s = re.sub(r"\s+", " ", s)
    s = _remove_punct(s)
    return s.strip().split()


def normalize_cer(s: str) -> List[str]:
    s = s.lower()
    s = re.sub(r"\s+", " ", s)
    s = _remove_punct(s)
    return list(s.strip())


def edit_ops(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """Levenshtein alignment counts: (hits, substitutions, deletions, insertions)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, hits, subs, dels, ins)
    prev = [(j, 0, 0, 0, j) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, 0, i, 0)]
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                c, h, s, d, ins = prev[j - 1]
                cand = [(c, h + 1, s, d, ins)]
            else:
                c, h, s, d, ins = prev[j - 1]
                cand = [(c + 1, h, s + 1, d, ins)]
            c, h, s, d, ins = prev[j]
            cand.append((c + 1, h, s, d + 1, ins))
            c, h, s, d, ins = cur[j - 1]
            cand.append((c + 1, h, s, d, ins + 1))
            cur.append(min(cand))
        prev = cur
    c, h, s, d, ins = prev[m]
    return h, s, d, ins


def _compute(
    predictions: Sequence[str], references: Sequence[str], normalize
) -> Tuple[float, List[float]]:
    incorrect = 0
    total = 0
    rates = []
    for pred, ref in zip(predictions, references):
        r = normalize(ref) or normalize("EMPTY")
        h = normalize(pred) or normalize("EMPTY")
        hits, s, d, i = edit_ops(r, h)
        denom = s + d + hits
        rates.append((s + d + i) / max(denom, 1))
        incorrect += s + d + i
        total += denom
    return incorrect / max(total, 1), rates


def compute_wer(predictions, references):
    """Corpus WER + per-utterance WERs (reference: metrics.py:5-38)."""
    return _compute(predictions, references, normalize_wer)


def compute_cer(predictions, references):
    """Corpus CER + per-utterance CERs (reference: metrics.py:41-71)."""
    return _compute(predictions, references, normalize_cer)


def compute_metrics(pred_ids, label_ids, tokenizer, pad_token_id: int) -> Dict:
    """Trainer predict-with-generate metric hook (reference: metrics.py:74-84)."""
    import numpy as np

    label_ids = np.where(label_ids == -100, pad_token_id, label_ids)
    pred_str = tokenizer.batch_decode(pred_ids, skip_special_tokens=True)
    label_str = tokenizer.batch_decode(label_ids, skip_special_tokens=True)
    wer, _ = compute_wer(pred_str, label_str)
    return dict(wer=wer)
