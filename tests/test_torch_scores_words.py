"""The port's ``decoding/word_timestamps.py`` and ``decoding/scores.py`` vs
the JAX package's, and ``score_sequences``.

word_timestamps is a numpy copy: every function gives the JAX module's
outputs bit for bit on shared numpy inputs (random maps and costs, the
JAX tests' synthetic goldens, a miniature byte-level BPE on each side).
``full_scores`` and ``score_sequences`` run on the fixture of
test_torch_generate.py (tiny_test_config(vocab_size=51865,
medusa_num_heads=3), f32 on the CPU) over fixed token sequences, with and
without the timestamp rules and with a ``logits_processor`` hook: the
finite entries within 1e-4, the -inf entries where JAX has them.  At int8
JAX runs both under ``jit``, where XLA keeps f32 values that its int8 code
rounds to bf16 (test_torch_int8_generate.py): they are held within 5e-3,
the bar of that file (op by op the int8 pass agrees to 1e-4:
test_torch_capture.py).
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import models  # noqa: F401
from whisper_medusa_tpu.data import bpe as jbpe
from whisper_medusa_tpu.decoding import processors as jproc
from whisper_medusa_tpu.decoding import scores as jscores
from whisper_medusa_tpu.decoding import word_timestamps as jwt
from whisper_medusa_tpu_torch.data import bpe as tbpe
from whisper_medusa_tpu_torch.decoding import processors as tproc
from whisper_medusa_tpu_torch.decoding import scores as tscores
from whisper_medusa_tpu_torch.decoding import word_timestamps as twt

EOS, TS = 50257, 50364


class _StubTokenizer:
    """decode() renders each id as a space-separated pseudo-word."""

    def decode(self, ids, skip_special_tokens=True, **kw):
        return "".join(f" t{int(i)}" for i in ids)


def _byte_bpe(mod):
    byte_enc = mod.bytes_to_unicode()
    vocab = {c: i for i, c in enumerate(byte_enc.values())}
    vocab["<|endoftext|>"] = len(vocab)
    return mod.WhisperBPETokenizer(vocab, []), vocab["<|endoftext|>"]


def _same(a, b):
    """Bitwise equality of nested outputs (arrays, tuples, lists, dicts)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


# ----------------------------------------------------------- word_timestamps

@pytest.mark.parametrize("width", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("n", [1, 2, 6, 7, 40])
def test_median_filter_bitwise(width, n):
    x = np.random.default_rng(n * 10 + width).normal(size=(3, 4, n))
    _same(jwt.median_filter(x, width), twt.median_filter(x, width))


def test_median_filter_golden():
    x = np.array([[1.0, 9.0, 1.0, 1.0, 8.0, 1.0, 1.0]])
    np.testing.assert_array_equal(twt.median_filter(x, 3)[0], [9, 1, 1, 1, 1, 1, 1])
    assert twt.median_filter(x, 1) is x


def _brute_force_min_path(cost):
    """Exhaustive min path sum (0,0)->(n-1,m-1) over (+1,0), (0,+1), (+1,+1)."""
    n, m = cost.shape

    @functools.lru_cache(maxsize=None)
    def best(i, j):
        if i == 0 and j == 0:
            return float(cost[0, 0])
        cands = [best(i - 1, j - 1)] if i and j else []
        cands += [best(i - 1, j)] if i else []
        cands += [best(i, j - 1)] if j else []
        return float(cost[i, j]) + min(cands)

    return best(n - 1, m - 1)


@pytest.mark.parametrize("trial", range(8))
def test_dtw_path_bitwise_and_optimal(trial):
    rng = np.random.default_rng(trial)
    for _ in range(5):
        n, m = int(rng.integers(1, 7)), int(rng.integers(1, 9))
        cost = rng.normal(size=(n, m))
        if trial % 2:                       # ties: costs on a coarse grid
            cost = np.round(cost)
        ti, si = twt.dtw_path(cost)
        _same(jwt.dtw_path(cost), (ti, si))
        steps = set(zip(np.diff(ti).tolist(), np.diff(si).tolist()))
        assert steps <= {(1, 0), (0, 1), (1, 1)}
        assert sum(float(cost[i, j]) for i, j in zip(ti, si)) == pytest.approx(
            _brute_force_min_path(cost), abs=1e-9)


def test_dtw_goldens():
    n = 6
    ti, si = twt.dtw_path(np.ones((n, n)) - np.eye(n))
    np.testing.assert_array_equal(ti, np.arange(n))
    np.testing.assert_array_equal(si, np.arange(n))
    att = np.full((4, 16), 1.0)
    for i in range(4):
        att[i, 4 * i: 4 * i + 4] = 0.0
    ti, si = twt.dtw_path(att)
    for i in range(4):
        assert 4 * i <= int(si[np.argmax(ti == i)]) < 4 * i + 4


def _maps(seed, heads=2, t=9, s=30):
    rng = np.random.default_rng(seed)
    m = rng.random((heads, t, s)) * 0.05
    for i in range(t):
        m[:, i, 3 * i: 3 * i + 3] += 1.0
    return (m / m.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("num_frames,width", [(30, 7), (21, 7), (30, 1), (12, 3)])
def test_alignment_and_token_times_bitwise(num_frames, width):
    maps = _maps(num_frames + width)
    _same(jwt.alignment_matrix(maps, num_frames, width),
          twt.alignment_matrix(maps, num_frames, width))
    starts, ends = twt.token_times(maps, num_frames, width)
    _same(jwt.token_times(maps, num_frames, width), (starts, ends))
    assert np.all(np.diff(starts) >= 0) and np.all(ends >= starts)
    assert ends[-1] == pytest.approx(num_frames * twt.SECONDS_PER_ENC_FRAME)


def test_per_token_times_bitwise():
    toks = [TS, 11, 12, 13, TS + 5, 14, 15, TS + 9, EOS]
    maps = _maps(3)
    got = twt.per_token_times(toks, maps, 30, EOS, time_offset=2.5)
    _same(jwt.per_token_times(toks, maps, 30, EOS, time_offset=2.5), got)
    text = np.array(toks) < EOS
    assert np.isnan(got[~text]).all() and np.isfinite(got[text]).all()
    assert got[text, 0].min() >= 2.5
    _same(jwt.per_token_times([TS, EOS], maps[:, :2], 30, EOS),
          twt.per_token_times([TS, EOS], maps[:, :2], 30, EOS))


def test_words_with_times_goldens():
    """The JAX tests' synthetic goldens, on both modules."""
    t, s = 3, 12
    maps = np.full((1, t, s), 0.01)
    for i in range(t):
        maps[:, i, 4 * i: 4 * i + 4] = 1.0
    args = ([11, 12, 13], maps, _StubTokenizer(), s, EOS, TS)
    words = twt.words_with_times(*args)
    assert words == jwt.words_with_times(*args)
    assert [w["word"].strip() for w in words] == ["t11", "t12", "t13"]
    assert words[-1]["end"] == pytest.approx(s * twt.SECONDS_PER_ENC_FRAME)
    tokens = [TS, 11, 12, TS + 16, EOS]
    maps = np.full((1, 5, 10), 0.01)
    for i, (a, b) in enumerate([(0, 2), (2, 5), (5, 8), (8, 10), (8, 10)]):
        maps[:, i, a:b] = 1.0
    args = (tokens, maps, _StubTokenizer(), 10, EOS, TS)
    words = twt.words_with_times(*args, time_offset=10.0)
    assert words == jwt.words_with_times(*args, time_offset=10.0)
    assert [w["word"].strip() for w in words] == ["t11", "t12"]
    assert all(w["start"] >= 10.0 for w in words)


def test_word_times_hand_derived_golden():
    """A block-diagonal map with a known path and the byte-level BPE of each
    package: exact words and times, the same on both sides."""
    tt, eos = _byte_bpe(tbpe)
    jt, _ = _byte_bpe(jbpe)
    ids = tt.encode(" hi yo")
    assert ids == jt.encode(" hi yo") and len(ids) == 6
    maps = np.full((2, len(ids) + 1, 12), 0.01)
    for t in range(len(ids)):
        maps[:, t, 2 * t: 2 * t + 2] = 5.0
    maps[:, -1, -2:] = 5.0
    kw = dict(num_frames=12, eos_id=eos, timestamp_begin=eos + 1, filter_width=1)
    words = twt.words_with_times(list(ids) + [eos], maps, tt, **kw)
    assert words == jwt.words_with_times(list(ids) + [eos], maps, jt, **kw)
    assert [(w["word"], w["start"], w["end"]) for w in words] == [
        (" hi", 0.0, 0.12), (" yo", 0.12, 0.24)]


@pytest.mark.parametrize("text", [" the quick brown fox, naïve café 日本",
                                  ' "Hello," she said (twice)... ok?'])
def test_split_tokens_real_bpe(text):
    tt, _ = _byte_bpe(tbpe)
    jt, _ = _byte_bpe(jbpe)
    ids = tt.encode(text)
    words, groups = twt.split_tokens_on_spaces(ids, tt)
    assert (words, groups) == jwt.split_tokens_on_spaces(ids, jt)
    assert "".join(words) == text and sum(len(g) for g in groups) == len(ids)
    assert twt.split_tokens_on_unicode(ids, tt) == jwt.split_tokens_on_unicode(ids, jt)


def test_merge_punctuations_and_default_heads():
    words = [" a", ' "', "b", ",", " c", "."]
    groups = [[1], [2], [3], [4], [5], [6]]
    w2, g2 = list(words), [list(g) for g in groups]
    twt.merge_punctuations(w2, g2)
    w3, g3 = list(words), [list(g) for g in groups]
    jwt.merge_punctuations(w3, g3)
    assert (w2, g2) == (w3, g3)
    assert twt.default_alignment_heads(4, 2) == jwt.default_alignment_heads(4, 2) == (
        (2, 0), (2, 1), (3, 0), (3, 1))


# ------------------------------------------------------------ score stacks

def _sequences(st, timestamps, max_length=20):
    """Two committed sequences and lengths: text ids (and, with timestamps,
    timestamp pairs), EOS at each length, EOS-padded to ``max_length``."""
    rng = np.random.default_rng(5)
    prompt = [st.sot, st.first_language, st.transcribe] + ([] if timestamps
                                                           else [st.no_timestamps])
    rows, lengths = [], []
    for n in (max_length - len(prompt) - 1, 9):
        body = list(rng.integers(200, 5000, size=n))
        if timestamps:
            body[0], body[4], body[5] = TS, TS + 7, TS + 7
        row = prompt + body + [EOS]
        lengths.append(len(row))
        rows.append(row + [EOS] * (max_length - len(row)))
    return np.array(rows, np.int32)[:, :max_length], np.minimum(lengths, max_length)


def _pcfgs(jm, prompt_len, timestamps, hook):
    st, gd = jm.special, jm.generation_config
    kw = dict(vocab_size=jm.config.dims.vocab_size, suppress_tokens=gd.suppress_tokens,
              begin_suppress_tokens=gd.begin_suppress_tokens, begin_index=prompt_len,
              exponential_decay_length_penalty=(prompt_len + 5, 1.3), eos_token_id=st.eos,
              timestamp_rules=timestamps, timestamp_begin=st.timestamp_begin,
              no_timestamps_id=st.no_timestamps, max_initial_timestamp_index=50)
    jhook = thook = None
    if hook:
        jhook = lambda lg, pos: lg.at[..., 300].add(0.5 * pos.astype(jnp.float32))
        thook = lambda lg, pos: lg.index_add(
            -1, torch.tensor([300]), 0.5 * pos.float()[..., None])
    return (jproc.ProcessorConfig(**kw, custom=jhook),
            tproc.ProcessorConfig(**kw, custom=thook))


def _scores_close(a, c, tol):
    a = np.asarray(a)
    assert a.shape == c.shape
    fin = np.isfinite(a)
    np.testing.assert_array_equal(np.isfinite(c), fin)
    np.testing.assert_array_equal(a[~fin], c[~fin])
    np.testing.assert_allclose(c[fin], a[fin], rtol=0, atol=tol)


@pytest.fixture(scope="module")
def encoded(models):
    jm, _ = models
    f = np.random.default_rng(3).standard_normal(
        (2, jm.config.dims.num_mel_bins, jm.config.dims.num_frames)).astype(np.float32)
    return np.asarray(jm.encode(jnp.asarray(f)))


@pytest.mark.parametrize("timestamps,hook", [(False, False), (True, False), (False, True),
                                             (True, True)],
                         ids=["plain", "timestamps", "hook", "timestamps-hook"])
def test_full_scores_match_jax(models, encoded, timestamps, hook):
    jm, tm = models
    toks, lengths = _sequences(jm.special, timestamps)
    p_len = 3 if timestamps else 4
    jp, tp = _pcfgs(jm, p_len, timestamps, hook)
    a = jscores.full_scores(jm.params["whisper"], jm.config.dims, toks, lengths,
                            jnp.asarray(encoded), jp, 20, chunk=8)
    c = tscores.full_scores(tm.params["whisper"], tm.config.dims, toks, lengths,
                            torch.from_numpy(encoded), tp, 20, chunk=8)
    assert c.shape == (2, 20 - p_len, 51865)
    _scores_close(a, c, 1e-4)
    assert np.all(c[1, lengths[1] - p_len:] == 0.0)
    # Each live row is a log-probability distribution.
    live = c[0, : lengths[0] - p_len]
    lse = np.log(np.exp(np.where(np.isfinite(live), live, -np.inf)).sum(-1))
    np.testing.assert_allclose(lse, 0.0, atol=1e-4)


def test_full_scores_int8_match_jax(models, encoded):
    jm, tm = models
    jq, tq = jm.quantize(), tm.quantize()
    toks, lengths = _sequences(jm.special, False)
    jp, tp = _pcfgs(jm, 4, False, False)
    a = jscores.full_scores(jq.params["whisper"], jq.config.dims, toks, lengths,
                            jnp.asarray(encoded), jp, 20)
    c = tscores.full_scores(tq.params["whisper"], tq.config.dims, toks, lengths,
                            torch.from_numpy(encoded), tp, 20)
    _scores_close(a, c, 5e-3)


def test_timestamp_history_matches_jax():
    special = types.SimpleNamespace(sot=1, first_language=2, transcribe=3, no_timestamps=4)
    toks, _ = _sequences(special, True)
    _same(jscores._timestamp_history(toks, 3, TS), tscores._timestamp_history(toks, 3, TS))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_score_sequences_match_jax(models, encoded, quant):
    jm, tm = models
    if quant:
        jm, tm = jm.quantize(), tm.quantize()
    toks, lengths = _sequences(jm.special, False)
    c = tm.score_sequences(torch.from_numpy(encoded), toks, lengths, 4)
    a = jm.score_sequences(jnp.asarray(encoded), toks, lengths, 4)
    assert c.shape == (2,) and c.dtype == np.float32
    np.testing.assert_allclose(c, np.asarray(a), rtol=0, atol=5e-3 if quant else 1e-4)
