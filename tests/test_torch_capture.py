"""The capture surfaces of the port vs the JAX package's: the teacher-forced
capture pass (``models/whisper.py::decode_train_capture``, the int8
full-sequence attention) and ``generate``'s ``return_scores="full"``,
``return_cross_attentions``, ``return_decoder_attentions``,
``return_hidden_states``, ``return_token_timestamps`` and
``word_timestamps``, shortform and longform.

The fixtures of test_torch_generate.py, test_torch_block_generate.py and
test_torch_longform.py (tiny width, vocab 51865, f32 on the CPU; JAX weights
bridged; the longform model with Whisper's 3000-frame window and 75 s of
noise).  Module level, JAX runs op by op: maps, hidden states and outputs
within 1e-4, at f32 and int8 (``quantize()`` on each side).  Through
``generate`` tokens are equal, score stacks (finite entries; -inf where JAX
has it), maps and hidden states within 1e-4, int8 within 5e-3 (JAX jits
its int8 capture and score passes, where XLA keeps f32 values its code
rounds to bf16: test_torch_int8_generate.py).  Word strings are equal and
every word and token time within one encoder frame (0.02 s): the DTW takes
the lowest-cost path, and maps that agree to 1e-6 can flip a tie by one
frame.  The DTW's NaN rows (timestamps, EOS) are the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_block_generate import block_models  # noqa: F401
from tests.test_torch_generate import _feats, models  # noqa: F401
from tests.test_torch_longform import long_models  # noqa: F401
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu_torch.decoding import word_timestamps as twt
from whisper_medusa_tpu_torch.models import whisper as tw

FRAME = twt.SECONDS_PER_ENC_FRAME


class _StubTokenizer:
    """decode() renders each id as a space-separated pseudo-word."""

    def decode(self, ids, skip_special_tokens=True, **kw):
        return "".join(f" t{int(i)}" for i in ids)


@pytest.fixture(scope="module")
def qmodels(models):
    jm, tm = models
    return jm.quantize(), tm.quantize()


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ------------------------------------------------------------- module level

def _layer0(params, part):
    return jax.tree.map(lambda a: a[0], params["decoder"]["layers"][part])


@pytest.mark.parametrize("part", ["self", "cross"])
def test_int8_attn_full_matches_jax(qmodels, part):
    """The int8 branch of self_attn_full (causal) and cross_attn_full: dense
    (K6 on the card) projections and the plain attention, as JAX's."""
    jq, tq = qmodels
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    enc = rng.standard_normal((2, 32, 32)).astype(np.float32)
    jl = _layer0(jq.params["whisper"], part)
    tl = tw.layer_params(tq.params["whisper"]["decoder"]["layers"], 0)[part]
    assert isinstance(tl["q_w"], dict)
    if part == "self":
        a = jw.self_attn_full(jl, jnp.asarray(x), 2, causal=True)
        c = tw.self_attn_full(tl, torch.from_numpy(x), 2, causal=True)
    else:
        a = jw.cross_attn_full(jl, jnp.asarray(x), jnp.asarray(enc), 2)
        c = tw.cross_attn_full(tl, torch.from_numpy(x), torch.from_numpy(enc), 2)
    np.testing.assert_allclose(_np(c), _np(a), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def teacher_inputs(models):
    jm, _ = models
    rng = np.random.default_rng(2)
    toks = np.concatenate([np.array([[50258, 50259, 50359, 50363]] * 2),
                           rng.integers(200, 9000, (2, 10))], axis=1).astype(np.int32)
    enc = rng.standard_normal((2, 32, 32)).astype(np.float32)
    return toks, enc


CAPTURES = {"all": dict(cross="all", self_attn="all", collect_hidden=True),
            "selected": dict(cross=((1, 0), (0, 1), (1, 1)), self_attn=((0, 1),),
                             collect_hidden=True),
            "cross-only": dict(cross=((1, 1),))}


@pytest.mark.parametrize("what", list(CAPTURES))
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_decode_train_capture_matches_jax(models, qmodels, teacher_inputs, quant, what):
    jm, tm = qmodels if quant else models
    toks, enc = teacher_inputs
    kw = CAPTURES[what]
    a = jw.decode_train_capture(jm.params["whisper"], jm.config.dims, jnp.asarray(toks),
                                jnp.asarray(enc), **kw)
    c = tw.decode_train_capture(tm.params["whisper"], tm.config.dims, torch.from_numpy(toks),
                                torch.from_numpy(enc), **kw)
    for x, y in zip(a, c):
        assert (x is None) == (y is None)
        if x is not None:
            assert tuple(y.shape) == tuple(x.shape)
            np.testing.assert_allclose(_np(y), _np(x), rtol=0, atol=1e-4)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_capture_consistent_with_decode_train(models, qmodels, teacher_inputs, quant):
    """A captured layer's output is the uncaptured layer's: the capture
    pass's hidden is decode_train's, bit for bit; a selection's maps are
    the same heads of the "all" capture, bit for bit; the hidden stack's
    last row after ln_post is the hidden; every map row sums to 1;
    ``to_host`` and decode_train_cross_attn give the same tensors."""
    _, tm = qmodels if quant else models
    p, dims = tm.params["whisper"], tm.config.dims
    toks, enc = (torch.from_numpy(a) for a in teacher_inputs)
    ref = tw.decode_train(p, dims, toks, enc).hidden
    hid, cm, sm, hs = tw.decode_train_capture(p, dims, toks, enc, cross="all",
                                              self_attn="all", collect_hidden=True)
    assert torch.equal(hid, ref)
    sel = ((1, 1), (0, 0))
    h2, cs, ss, _ = tw.decode_train_capture(p, dims, toks, enc, cross=sel, self_attn=sel,
                                            to_host=True)
    assert torch.equal(h2, ref)
    for i, (l, h) in enumerate(sel):
        assert torch.equal(cs[i], cm[l][:, h]) and torch.equal(ss[i], sm[l][:, h])
    dec = p["decoder"]
    assert torch.equal(tw.layer_norm(hs[-1], dec["ln_post"]["scale"], dec["ln_post"]["bias"]),
                       hid)
    torch.testing.assert_close(cm.sum(-1), torch.ones_like(cm.sum(-1)), rtol=0, atol=1e-5)
    torch.testing.assert_close(sm.sum(-1), torch.ones_like(sm.sum(-1)), rtol=0, atol=1e-5)
    assert bool((torch.triu(sm, diagonal=1) == 0).all())
    h3, m3 = tw.decode_train_cross_attn(p, dims, toks, enc, select=sel)
    assert torch.equal(h3, ref) and torch.equal(m3, cs)


# --------------------------------------------------------- generate, shortform

ALL = dict(return_timestamps=True, return_scores="full", word_timestamps=True,
           tokenizer=_StubTokenizer(), return_token_timestamps=True,
           return_cross_attentions=((0, 1), (1, 0)), return_decoder_attentions=True,
           return_hidden_states=True)
# id: (models fixture, batch, feature seed, generate options, tolerance)
REQUESTS = {
    "medusa-B2": ("models", 2, 9, ALL, 1e-4),
    "vanilla-B2": ("models", 2, 4, dict(
        disable_medusa=True, return_scores="full", return_token_timestamps=True,
        return_decoder_attentions=((1, 0), (0, 1)), return_hidden_states=True), 1e-4),
    "block-B1": ("block_models", 1, 5, dict(
        return_timestamps=True, return_scores="full", word_timestamps=True,
        tokenizer=_StubTokenizer(), alignment_heads=((1, 1), (0, 0)),
        return_cross_attentions=True), 1e-4),
    "int8-B2": ("qmodels", 2, 9, ALL, 5e-3),
}
FIELDS = {
    "medusa-B2": ("scores", "cross_attentions", "decoder_attentions",
                  "decoder_hidden_states", "words", "token_timestamps"),
    "vanilla-B2": ("scores", "decoder_attentions", "decoder_hidden_states",
                   "token_timestamps"),
    "block-B1": ("scores", "cross_attentions", "words"),
    "int8-B2": ("scores", "cross_attentions", "decoder_attentions",
                "decoder_hidden_states", "words", "token_timestamps"),
}


@pytest.fixture(scope="module")
def requests(request):
    outs = {}
    for rid, (fixture, b, seed, kw, _) in REQUESTS.items():
        jm, tm = request.getfixturevalue(fixture)
        f = _feats(jm.config, seed=seed, b=b)
        kw = dict(language="en", max_length=20, **kw)
        outs[rid] = (jm.generate(f, **kw), tm.generate(f, **kw))
    return outs


def _scores_close(a, c, tol):
    a = np.asarray(a)
    assert c.shape == a.shape
    fin = np.isfinite(a)
    np.testing.assert_array_equal(np.isfinite(c), fin)
    np.testing.assert_array_equal(c[~fin], a[~fin])
    np.testing.assert_allclose(c[fin], a[fin], rtol=0, atol=tol)


def _words_close(a, c):
    assert len(a) == len(c)
    for wa, wc in zip(a, c):
        assert [w["word"] for w in wa] == [w["word"] for w in wc]
        for x, y in zip(wa, wc):
            assert abs(x["start"] - y["start"]) <= FRAME + 1e-9
            assert abs(x["end"] - y["end"]) <= FRAME + 1e-9


def _times_close(a, c):
    assert len(a) == len(c)
    for x, y in zip(a, c):
        assert y.shape == x.shape and y.dtype == np.float64
        np.testing.assert_array_equal(np.isnan(y), np.isnan(x))
        np.testing.assert_allclose(y, x, rtol=0, atol=FRAME + 1e-9)


def _field_close(a, c, field, tol):
    x, y = getattr(a, field), getattr(c, field)
    assert (x is None) == (y is None) and y is not None
    if field == "scores":
        _scores_close(x, y, tol)
    elif field == "words":
        _words_close(x, y)
    elif field == "token_timestamps":
        _times_close(x, y)
    else:
        assert y.dtype == np.float32 and y.shape == np.asarray(x).shape
        np.testing.assert_allclose(y, np.asarray(x), rtol=0, atol=tol)


@pytest.mark.parametrize("rid,field", [(r, f) for r in REQUESTS for f in FIELDS[r]])
def test_generate_capture_matches_jax(requests, rid, field):
    a, c = requests[rid]
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(c.lengths, np.asarray(a.lengths))
    _field_close(a, c, field, REQUESTS[rid][4])


@pytest.mark.parametrize("rid", ["medusa-B2", "block-B1", "int8-B2"])
def test_generate_words_attach_to_segments(requests, rid):
    """Words attach to the same segments as JAX's."""
    a, c = requests[rid]
    assert any(s["words"] for segs in c.segments for s in segs)
    for sa, sc in zip(a.segments, c.segments):
        assert [[w["word"] for w in s["words"]] for s in sa] == \
            [[w["word"] for w in s["words"]] for s in sc]


@pytest.mark.parametrize("rid,p_len", [("vanilla-B2", 4), ("block-B1", 3)])
def test_generate_scores_gather_loop_logprobs(requests, rid, p_len):
    """Where the loop verifies from the backbone's hidden state (vanilla,
    Medusa-Block), the stack's rows gathered at the emitted tokens are the
    loop's token log-probs.  (``base_head`` verifies from head 0 of the
    hidden state, which the stack, as JAX's, does not apply.)"""
    _, c = requests[rid]
    for i in range(c.sequences.shape[0]):
        pos = np.arange(p_len, int(c.lengths[i]))
        got = c.scores[i, pos - p_len, c.sequences[i, pos]]
        np.testing.assert_allclose(got, c.token_logprobs[i, pos], rtol=0, atol=1e-4)


def test_generate_attention_mask_bounds_dtw(models):
    """attention_mask at shortform: each example's DTW runs over its own
    live frames, as in JAX."""
    jm, tm = models
    f = _feats(jm.config, seed=9, b=2)
    mask = np.ones((2, f.shape[-1]), np.int32)
    mask[1, 40:] = 0
    kw = dict(language="en", max_length=20, return_timestamps=True, word_timestamps=True,
              tokenizer=_StubTokenizer(), return_token_timestamps=True, attention_mask=mask)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    _words_close(a.words, c.words)
    _times_close(a.token_timestamps, c.token_timestamps)
    assert np.nanmax(c.token_timestamps[1]) <= 20 * FRAME + 1e-9
    assert np.nanmax(c.token_timestamps[0]) > 20 * FRAME


def test_capture_validation_and_defaults(models):
    _, tm = models
    f = _feats(tm.config)
    out = tm.generate(f, language="en", max_length=10)
    assert all(getattr(out, k) is None for k in (
        "scores", "cross_attentions", "words", "token_timestamps", "decoder_attentions",
        "decoder_hidden_states"))
    with pytest.raises(ValueError, match="return_scores"):
        tm.generate(f, language="en", max_length=8, return_scores="all")
    with pytest.raises(ValueError, match="return_timestamps"):
        tm.generate(f, language="en", word_timestamps=True, tokenizer=_StubTokenizer())
    with pytest.raises(ValueError, match="tokenizer"):
        tm.generate(f, language="en", return_timestamps=True, word_timestamps=True)
    with pytest.raises(ValueError, match="word timestamps"):
        tm.generate(f, language="en", num_beams=2, return_hidden_states=True)


# --------------------------------------------------------- generate, longform

def test_longform_capture_matches_jax(long_models):
    """75 s at B=1 through the seek loop: scores per kept token, words and
    token times shifted by each window's offset, per-window capture
    entries."""
    jm, tm, feats = long_models
    kw = dict(language="en", max_new_tokens=16, return_timestamps=True,
              return_scores="full", word_timestamps=True, tokenizer=_StubTokenizer(),
              return_token_timestamps=True, return_cross_attentions=((1, 0),),
              return_hidden_states=True)
    a, c = jm.generate(feats[:1], **kw), tm.generate(feats[:1], **kw)
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    _scores_close(a.scores, c.scores, 1e-4)
    _words_close(a.words, c.words)
    _times_close(a.token_timestamps, c.token_timestamps)
    assert len(c.cross_attentions[0]) == len(a.cross_attentions[0]) >= 3
    for ea, ec in zip(a.cross_attentions[0], c.cross_attentions[0]):
        assert ec["time_offset"] == ea["time_offset"]
        for k in ("cross_attentions", "decoder_hidden_states"):
            np.testing.assert_allclose(ec[k], np.asarray(ea[k]), rtol=0, atol=1e-4)
    starts = [w["start"] for w in c.words[0]]
    assert starts == sorted(starts) and starts[-1] > 30.0
    assert any(seg.get("words") for seg in c.segments[0])
