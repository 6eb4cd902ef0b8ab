"""The temperature-fallback ladder of ``generate``, port vs the JAX package.

``_compression_ratio`` and ``_needs_fallback`` are the JAX package's on
fixed token rows (exact).  On the fixture of test_torch_generate.py
(tiny_test_config(vocab_size=51865, medusa_num_heads=3), float32 on the
CPU): a deterministic ladder ``temperature=(0.0, 0.0)`` whose
``logprob_threshold`` lies between a B=2 batch's two average log-probs
retries exactly one example, and every ``GenerateOutput`` field equals the
JAX package's (tokens, lengths, accepted, per-example steps from each
example's own rung, the summed steps, mean_accept_length, log-probs within
1e-4); with ``temperature=(0.0, 0.5)`` the retry decodes only the failing
example (a spy on ``speculative_generate``'s batch) and the kept one keeps
its rung-0 output; sampled rungs draw per rung; a longform request runs
the ladder in every window (equal to the JAX package's under the
deterministic ladder, and with a sampled rung).
"""

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _assert_same, _feats, models  # noqa: F401
from whisper_medusa_tpu.models import api as japi
from whisper_medusa_tpu_torch.models import api as tapi


def test_compression_ratio_and_needs_fallback_match_jax():
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 51865, size=60), np.full((50,), 123), np.tile(np.arange(17), 5),
            rng.integers(0, 51866, size=3), np.zeros((0,), np.int64)]
    for vocab in (51865, 51866, 256):
        for toks in rows:
            assert tapi._compression_ratio(toks, vocab) == japi._compression_ratio(toks, vocab)
    tokens = np.zeros((4, 64), np.int32)
    tokens[0, 4:] = np.tile([0, 0, 0, 7, 7], 12)
    tokens[1, 4:] = rng.integers(0, 51865, size=60)
    tokens[2, 4:20] = 5
    tokens[3, 4:] = rng.integers(0, 51865, size=60)
    lengths = np.array([64, 64, 20, 30])
    avg = np.array([-0.5, -2.0, -0.1, -1.5])
    for crt, lpt in ((2.4, None), (None, -1.0), (2.4, -1.0), (1.0, -3.0), (None, None)):
        want = japi._needs_fallback(tokens, lengths, 4, crt, avg, lpt, vocab_size=51865)
        got = tapi._needs_fallback(tokens, lengths, 4, crt, avg, lpt, vocab_size=51865)
        np.testing.assert_array_equal(got, want)


def _split_threshold(tm, f, **kw):
    """A logprob threshold between the batch's two average log-probs, and
    the index of the example below it.  The random model's averages lie
    close together; the packages' agree far inside half this gap (f32)."""
    probe = tm.generate(f, **kw).avg_logprobs
    assert abs(probe[0] - probe[1]) > 2e-4
    return float(probe.mean()), int(np.argmin(probe))


def test_deterministic_ladder_matches_jax(models):
    jm, tm = models
    f = _feats(jm.config, seed=31, b=2)
    kw = dict(language="en", max_length=20)
    thr, fail_i = _split_threshold(tm, f, **kw)
    kw.update(temperature=(0.0, 0.0), logprob_threshold=thr)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    _assert_same(a, c)
    np.testing.assert_array_equal(c.steps_per_example, np.asarray(a.steps_per_example))
    # The failing example was decoded twice: the summed steps count both rungs.
    assert c.steps == int(c.steps_per_example.max()) + int(c.steps_per_example[fail_i])


def test_retry_decodes_only_the_failing_rows(models, monkeypatch):
    jm, tm = models
    f = _feats(tm.config, seed=31, b=2)
    kw = dict(language="en", max_length=20)
    base = tm.generate(f, **kw)
    thr, fail_i = _split_threshold(tm, f, **kw)
    batches = []
    real = tapi.speculative_generate

    def spy(*args, **kwargs):
        batches.append((int(args[6].shape[0]), kwargs["rng"] is not None))
        return real(*args, **kwargs)

    monkeypatch.setattr(tapi, "speculative_generate", spy)
    out = tm.generate(f, temperature=(0.0, 0.5), logprob_threshold=thr, seed=7, **kw)
    assert batches == [(2, False), (1, True)]
    keep_i = 1 - fail_i
    np.testing.assert_array_equal(out.sequences[keep_i], base.sequences[keep_i])
    np.testing.assert_array_equal(out.token_logprobs[keep_i], base.token_logprobs[keep_i])
    assert out.accepted[keep_i] == base.accepted[keep_i]
    assert out.steps_per_example[keep_i] == base.steps
    assert out.steps > int(out.steps_per_example.max()) >= 1
    want = sum(out.accepted[i] / max(out.steps_per_example[i], 1) for i in range(2))
    assert out.mean_accept_length == pytest.approx(float(want), abs=1e-12)
    for i in range(2):
        gen_lp = out.token_logprobs[i, 4:out.lengths[i]]
        np.testing.assert_allclose(out.avg_logprobs[i], gen_lp.mean(), rtol=1e-5)
    # A ladder that every example passes at rung 0 decodes once.
    batches.clear()
    tm.generate(f, temperature=(0.0, 0.5), logprob_threshold=-1e9, **kw)
    assert batches == [(2, False)]


def test_ladder_rungs_draw_apart(models):
    """Each sampled rung seeds its generator from (seed, rung index): a
    second rung at the same temperature draws other tokens (the JAX test
    test_ladder_steps_use_distinct_randomness)."""
    _, tm = models
    f = _feats(tm.config, seed=9, b=1)
    kw = dict(language="en", max_length=32, seed=0)
    one = tm.generate(f, temperature=(0.7,), **kw)
    two = tm.generate(f, temperature=(0.7, 0.7), compression_ratio_threshold=1e-9, **kw)
    assert not np.array_equal(one.sequences, two.sequences)
    assert two.steps > one.steps


def _long_feats(cfg, seed):
    f = _feats(cfg, seed=seed)
    return np.concatenate([f, f[..., :cfg.dims.num_frames // 2]], axis=-1)


def test_longform_ladder(models):
    jm, tm = models
    f = _long_feats(tm.config, seed=4)
    kw = dict(language="en", max_new_tokens=12, temperature=(0.0, 0.0),
              compression_ratio_threshold=0.1)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(c.lengths, np.asarray(a.lengths))
    assert c.steps == a.steps
    np.testing.assert_allclose(c.token_logprobs, a.token_logprobs, rtol=0, atol=1e-4)
    once = tm.generate(f, language="en", max_new_tokens=12)
    assert c.steps > once.steps
    sampled = tm.generate(f, language="en", max_new_tokens=12, temperature=(0.0, 0.4),
                          compression_ratio_threshold=0.1, seed=3)
    assert sampled.sequences.shape[0] == 1 and sampled.steps > once.steps
