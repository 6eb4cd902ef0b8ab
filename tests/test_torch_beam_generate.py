"""``generate(num_beams=...)`` of the port vs the JAX package's.

The fixtures of test_torch_generate.py and test_torch_longform.py
(tiny_test_config(vocab_size=51865, medusa_num_heads=3), float32 on the
CPU; the longform one with Whisper's 3000-frame window and 75 s of seeded
noise).  Shortform at B = 1 and 2, K = 2 and 3, length_penalty 0, 1 and 2,
with timestamps, with a 20-token ``prompt_ids`` (a 23-token prompt: the
pieced prefill), with per-example languages, with a ``logits_processor``
hook, on the int8 copy; longform through the seek loop with beam-decoded
windows, B = 1 and 2.  Sequences, lengths, steps and segments are equal and
``avg_logprobs`` (the beams' length-normalized scores) agree to 1e-4 (5e-3
at int8); longform beams return no per-token log-probs, as in JAX.  Beams
with a fallback temperature or a quality threshold raise ValueError.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _feats, models  # noqa: F401
from tests.test_torch_longform import _same as _same_long
from tests.test_torch_longform import long_models  # noqa: F401

TS_BEGIN = 50364


def _same(a, c, tol=1e-4):
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(c.lengths, np.asarray(a.lengths))
    assert c.steps == a.steps
    np.testing.assert_array_equal(c.accepted, np.asarray(a.accepted))
    np.testing.assert_allclose(c.avg_logprobs, np.asarray(a.avg_logprobs), rtol=0, atol=tol)
    assert c.segments == a.segments
    assert c.token_logprobs is None and a.token_logprobs is None


@pytest.mark.parametrize("b,k,lp,kw", [
    (1, 2, 1.0, {}),
    (2, 3, 0.0, {}),
    (2, 2, 2.0, dict(return_timestamps=True)),
    (1, 3, 1.0, dict(prompt_ids=[50361] + list(range(300, 319)), max_new_tokens=10)),
    (2, 2, 1.0, dict(language=["en", "fr"])),
    (1, 2, 1.0, dict(exponential_decay_length_penalty=(3, 1.5), max_new_tokens=12)),
], ids=["B1-K2", "B2-K3-lp0", "B2-K2-lp2-timestamps", "B1-K3-prompt20", "B2-languages",
        "B1-decay-max_new_tokens"])
def test_generate_beam_matches_jax(models, b, k, lp, kw):
    jm, tm = models
    f = _feats(jm.config, seed=60 + b + k, b=b)
    args = dict(language="en", max_length=24, num_beams=k, length_penalty=lp)
    args.update(kw)
    a, c = jm.generate(f, **args), tm.generate(f, **args)
    _same(a, c)
    assert c.steps > 0
    if kw.get("return_timestamps"):
        assert c.segments is not None and len(c.segments) == b
        for i in range(b):
            seq = [t for t in c.sequences[i, 3:c.lengths[i]].tolist() if t != 50257]
            ts = [t for t in seq if t >= TS_BEGIN]
            assert 50363 not in seq and ts == sorted(ts)
    if "language" in kw and not isinstance(kw["language"], str):
        assert c.sequences[0, 1] != c.sequences[1, 1]


def test_generate_beam_hook_matches_jax(models):
    """A forced-token hook reaches every beam (JAX tests/test_api.py's
    test_custom_logits_processor, at num_beams=2)."""
    jm, tm = models
    f = _feats(jm.config, seed=70, b=2)

    def force_jax(logits, pred_pos):
        return jnp.where(jnp.arange(logits.shape[-1]) == 1234, jnp.zeros_like(logits),
                         jnp.full_like(logits, -1e9))

    def force_torch(logits, pred_pos):
        return torch.where(torch.arange(logits.shape[-1]) == 1234, torch.zeros_like(logits),
                           torch.full_like(logits, -1e9))

    kw = dict(language="en", max_length=10, num_beams=2)
    a = jm.generate(f, logits_processor=force_jax, **kw)
    c = tm.generate(f, logits_processor=force_torch, **kw)
    _same(a, c)
    for i in range(2):
        gen = c.sequences[i, 4:int(c.lengths[i])]
        assert len(gen) > 0 and (gen == 1234).all()


def test_generate_beam_int8_matches_jax(models):
    jm, tm = models
    jq, tq = jm.quantize(), tm.quantize()
    f = _feats(jm.config, seed=71)
    kw = dict(language="en", max_length=20, num_beams=2)
    _same(jq.generate(f, **kw), tq.generate(f, **kw), tol=5e-3)


@pytest.mark.parametrize("b", [1, 2])
def test_longform_beam_matches_jax(long_models, b):
    jm, tm, feats = long_models
    kw = dict(language="en", max_new_tokens=12, num_beams=2, return_timestamps=b == 1)
    a, c = jm.generate(feats[:b], **kw), tm.generate(feats[:b], **kw)
    assert a.token_logprobs is None and c.token_logprobs is None
    assert a.avg_logprobs is None and c.avg_logprobs is None
    a.token_logprobs = c.token_logprobs = np.zeros(1)      # no per-token scores to compare
    _same_long(a, c)
    assert c.steps > 12      # several windows


def test_beam_option_guards(models):
    """As in JAX: beams take no fallback temperature, no quality thresholds
    and no capture surface (ValueError); an oversize prompt raises."""
    _, tm = models
    f = _feats(tm.config)
    for bad in (dict(temperature=(0.0, 0.2)), dict(temperature=0.4),
                dict(logprob_threshold=-1.0), dict(compression_ratio_threshold=2.4),
                dict(return_cross_attentions=True)):
        with pytest.raises(ValueError, match="num_beams=2 does not support"):
            tm.generate(f, language="en", num_beams=2, **bad)
    with pytest.raises(ValueError, match="exceeds max_length"):
        tm.generate(f, language="en", num_beams=2, max_length=6, prompt_ids=list(range(300, 304)))
