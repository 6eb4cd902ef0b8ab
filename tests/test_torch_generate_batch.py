"""Batched and vanilla generate of the port vs the JAX package (the port's
batch invariance is in test_torch_batch_invariance.py).

The fixture and comparisons of test_torch_generate.py: tiny_test_config(
vocab_size=51865, medusa_num_heads=3), float32 on the CPU.  At B = 2 and 3
the JAX package verifies in two passes (its ``auto`` rule) and so does the
port; ``disable_medusa=True`` decodes vanilla.  Tokens, lengths, accepted
drafts, steps and mean_accept_length are equal; token log-probs within 1e-4.
"""

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _assert_same, _feats, models  # noqa: F401


def test_batched_generate_matches_jax_per_example_language(models):
    jm, tm = models
    f = _feats(jm.config, seed=4, b=3)
    kw = dict(language=["en", "de", "en"], max_length=24)
    a, b = jm.generate(f, **kw), tm.generate(f, **kw)
    assert int(np.asarray(a.accepted).sum()) > 0
    _assert_same(a, b)
    np.testing.assert_array_equal(b.steps_per_example, np.asarray(a.steps_per_example))


def test_batched_generate_detects_language_like_jax(models):
    jm, tm = models
    f = _feats(jm.config, seed=5, b=2)
    a = jm.generate(f, max_new_tokens=12)
    b = tm.generate(f, max_new_tokens=12)
    assert b.detected_language == a.detected_language and len(b.detected_language) == 2
    _assert_same(a, b)


@pytest.mark.parametrize("b", [1, 3])
def test_disable_medusa_matches_jax_vanilla(models, b):
    jm, tm = models
    f = _feats(jm.config, seed=6, b=b)
    kw = dict(language="en", max_length=20, disable_medusa=True)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    _assert_same(a, c)
    assert c.accepted.sum() == 0 and c.mean_accept_length == 0.0
    # One token per iteration: every step commits exactly one token.
    assert c.steps == int(c.lengths.max()) - 5


def test_no_speech_blanking_keeps_avg_logprobs_like_jax(models):
    """A B=2 batch where the no-speech rule blanks one example: with
    ``no_speech_threshold=0`` every example passes the probability test and
    ``logprob_threshold``, set between the two examples' average log-probs,
    picks the one below it.  The blanked example keeps its average log-prob
    from before blanking, as the JAX package returns it; both packages blank
    the same example."""
    jm, tm = models
    f = _feats(jm.config, seed=24, b=2)
    kw = dict(language="en", max_length=16)
    probe = tm.generate(f, **kw).avg_logprobs
    # The random model's log-probs lie close together; the two packages'
    # averages agree far inside this gap's half (f32).
    assert abs(probe[0] - probe[1]) > 1e-4
    kw.update(no_speech_threshold=0.0, logprob_threshold=float(probe.mean()))
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    blanked = int(np.argmin(probe))
    assert c.lengths[blanked] == 4 and c.lengths[1 - blanked] > 4
    _assert_same(a, c)
    np.testing.assert_allclose(c.avg_logprobs, probe, rtol=1e-6)
