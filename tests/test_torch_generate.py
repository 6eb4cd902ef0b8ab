"""The slice as a whole: port WhisperMedusaModel.generate vs the JAX one.

tiny_test_config(vocab_size=51865, medusa_num_heads=3) with nonzero head
weights, the JAX weights bridged into the port, float32 on the CPU.  Tokens,
lengths, accepted drafts, steps and mean_accept_length are equal; token
log-probs agree to 1e-4.  B = 1 here; batches of 2 and 3 (the JAX package's
two-pass verification) and vanilla decoding are in test_torch_generate_batch.py,
B = 12 in test_torch_generate_b12.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel as TModel


@pytest.fixture(scope="module")
def models():
    cfg = tiny_test_config(vocab_size=51865, medusa_num_heads=3)
    jm = JModel.from_random(cfg, seed=0)
    rng = np.random.default_rng(0)
    w = jm.params["medusa"]["heads"]["w"]
    jm.params["medusa"]["heads"]["w"] = jnp.asarray(
        0.3 * rng.standard_normal(w.shape), jnp.float32)
    tm = TModel(tconfig.ModelConfig.from_dict(cfg.to_dict()),
                bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu"),
                device="cpu")
    return jm, tm


def _feats(cfg, seed=0, b=1):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.dims.num_mel_bins, cfg.dims.num_frames)).astype(np.float32)


def _assert_same(a, b):
    np.testing.assert_array_equal(b.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(b.lengths, np.asarray(a.lengths))
    np.testing.assert_array_equal(b.accepted, np.asarray(a.accepted))
    assert b.steps == a.steps
    assert b.mean_accept_length == pytest.approx(a.mean_accept_length, abs=1e-12)
    np.testing.assert_allclose(b.token_logprobs, a.token_logprobs, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b.avg_logprobs, a.avg_logprobs, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b.no_speech_probs, a.no_speech_probs, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("decay", [None, (5, 1.4)])
def test_generate_matches_jax(models, decay):
    jm, tm = models
    f = _feats(jm.config, seed=1)
    kw = dict(language="en", max_length=24, exponential_decay_length_penalty=decay)
    a, b = jm.generate(f, **kw), tm.generate(f, **kw)
    assert a.steps > 0 and int(np.asarray(a.accepted).sum()) > 0
    _assert_same(a, b)


def test_detect_language_and_max_new_tokens_match_jax(models):
    jm, tm = models
    f = _feats(jm.config, seed=2)
    a = jm.generate(f, max_new_tokens=10)
    b = tm.generate(f, max_new_tokens=10)
    assert b.detected_language == a.detected_language
    _assert_same(a, b)


def test_tokens_invariant_under_draft_corruption(models):
    _, tm = models
    f = _feats(tm.config, seed=1)
    outs = [tm.generate(f, language="en", max_length=24, draft_corruption=c)
            for c in (None, 0.5, 1.0)]
    for o in outs[1:]:
        # The finish rule may stop the loops a few tokens apart.
        n = int(min(o.lengths[0], outs[0].lengths[0]))
        np.testing.assert_array_equal(o.sequences[0, :n], outs[0].sequences[0, :n])
        assert o.steps >= outs[0].steps
    assert outs[0].accepted.sum() > 0 and outs[2].accepted.sum() == 0


def test_from_pretrained_loads_framework_checkpoint(models, tmp_path):
    jm, tm = models
    jm.save_pretrained(str(tmp_path))
    loaded = TModel.from_pretrained(str(tmp_path), device="cpu")
    assert loaded.special == tm.special
    assert dataclasses.asdict(loaded.generation_config) == dataclasses.asdict(
        jm.generation_config)
    for (k, a), (_, b) in zip(_leaves(loaded.params), _leaves(tm.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    f = _feats(tm.config, seed=3)
    np.testing.assert_array_equal(
        loaded.generate(f, language="en", max_length=16).sequences,
        tm.generate(f, language="en", max_length=16).sequences)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


@pytest.mark.parametrize("kwargs,match", [
    (dict(return_cross_attentions=True), "capture"),
    (dict(word_timestamps=True), "timestamps"),
    (dict(return_token_timestamps=True), "timestamps"),
    (dict(return_hidden_states=True), "capture"),
    (dict(return_scores="full"), "capture"),
])
def test_unported_options_raise(models, kwargs, match):
    """Once refusals, these options are now served: each surface ("capture":
    maps, hidden states, scores; "timestamps": the DTW times) equals the JAX
    package's on the same request (tests/test_torch_capture.py holds them
    all at B = 1 and 2, int8, Medusa-Block and longform)."""
    jm, tm = models
    name = next(iter(kwargs))
    if name == "word_timestamps":
        kwargs = dict(kwargs, return_timestamps=True, tokenizer=_PseudoWords())
    kw = dict(language="en", max_length=16, **kwargs)
    f = _feats(tm.config, seed=5)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    field = {"return_cross_attentions": "cross_attentions",
             "return_hidden_states": "decoder_hidden_states",
             "return_scores": "scores", "word_timestamps": "words",
             "return_token_timestamps": "token_timestamps"}[name]
    x, y = getattr(a, field), getattr(c, field)
    if match == "timestamps":
        if field == "words":
            x, y = [[w["word"] for w in ws] for ws in x], [[w["word"] for w in ws] for ws in y]
            assert y == x and len(y[0]) > 0
        else:
            np.testing.assert_allclose(y[0], x[0], rtol=0, atol=0.02 + 1e-9)
        return
    x = np.asarray(x)
    fin = np.isfinite(x)
    np.testing.assert_array_equal(np.isfinite(y), fin)
    np.testing.assert_allclose(y[fin], x[fin], rtol=0, atol=1e-4)


class _PseudoWords:
    """A tokenizer stand-in: each id decodes to a space-separated pseudo-word."""

    def decode(self, ids, skip_special_tokens=True, **kw):
        return "".join(f" t{int(i)}" for i in ids)


def test_batch_and_longform_raise(models):
    """B=9 (past K2's batch) serves through the per-op step; longform input
    serves through the seek loop, with beams too; an unknown option
    raises."""
    _, tm = models
    cfg = tm.config
    out = tm.generate(np.zeros((9, cfg.dims.num_mel_bins, cfg.dims.num_frames),
                               np.float32), language="en", max_new_tokens=4)
    assert out.sequences.shape[0] == 9 and out.lengths.shape == (9,)
    long = _feats(cfg, seed=4)[..., :cfg.dims.num_frames // 2]
    long = np.concatenate([_feats(cfg, seed=4), long], axis=-1)
    out = tm.generate(long, language="en", max_new_tokens=12)
    assert out.sequences.shape[0] == 1 and out.steps > 0
    out = tm.generate(long, language="en", num_beams=2, max_new_tokens=6)
    assert out.sequences.shape[0] == 1 and out.steps > 0 and out.token_logprobs is None
    with pytest.raises(TypeError, match="unexpected"):
        tm.generate(_feats(cfg), language="en", no_such_option=1)


def test_beams_with_fallback_temperature_raise(models):
    """Beams take no temperature fallback: ValueError, as the JAX package
    raises (without beams the ladder runs: test_torch_fallback.py)."""
    jm, tm = models
    f = _feats(tm.config)
    for m in (jm, tm):
        with pytest.raises(ValueError, match="temperature fallback"):
            m.generate(f, language="en", num_beams=2, temperature=(0.0, 0.2))
