"""The port's WER / CER (``utils/metrics.py``) against the JAX package's on
the same strings: every normalization step (case, English contractions,
Kaldi non-words, whitespace, punctuation, non-ASCII punctuation), empty
references and predictions, the Levenshtein counts and the corpus
aggregation, bitwise."""

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.utils import metrics as jm
from whisper_medusa_tpu_torch.utils import metrics as tm

CASES = [
    (["hello world"], ["hello world"]),
    (["Hello, World!"], ["hello world"]),
    (["i can't go", "we won't"], ["I can not go", "we will not"]),
    (["the cat sat [noise] on <unk> the mat"], ["the cat sat on the mat"]),
    (["a  b\tc\n d"], ["a b c d"]),
    (["", "something"], ["reference here", ""]),
    (["they're here, it's late; I'd go"], ["they are here it is late i would go"]),
    (["«bonjour» — ça va ?"], ["bonjour ça va"]),
    (["one two three four five"], ["one three four six five seven"]),
    (["abcdef", "kitten"], ["azced", "sitting"]),
]


@pytest.mark.parametrize("preds,refs", CASES)
def test_wer_cer_match_jax(preds, refs):
    for name in ("compute_wer", "compute_cer"):
        got, want = getattr(tm, name)(preds, refs), getattr(jm, name)(preds, refs)
        assert got == want, name
    for p in preds + refs:
        assert tm.normalize_wer(p) == jm.normalize_wer(p)
        assert tm.normalize_cer(p) == jm.normalize_cer(p)


def test_edit_ops_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = list(rng.integers(0, 4, rng.integers(0, 9)))
        b = list(rng.integers(0, 4, rng.integers(0, 9)))
        assert tm.edit_ops(a, b) == jm.edit_ops(a, b)


def test_compute_metrics_matches_jax():
    from whisper_medusa_tpu_torch.data.tokenizer import CharTokenizer

    tok = CharTokenizer()
    pred = np.asarray([tok.encode("hello there") + [0] * 3, tok.encode("abc def") + [0] * 7])
    lab = np.asarray([tok.encode("hello then") + [-100] * 4, tok.encode("abc deg") + [-100] * 7])
    assert tm.compute_metrics(pred, lab, tok, 0) == jm.compute_metrics(pred, lab, tok, 0)
