"""``generate(return_timestamps=True)`` of the port vs the JAX package's.

The fixtures of test_torch_generate.py and test_torch_block_generate.py
(tiny_test_config(vocab_size=51865, medusa_num_heads=3): the real timestamp
ids exist), float32 on the CPU.  B = 1 (K4's route, the rules fused into
the verification pass), B = 3 (two passes: pass A's rows take the rules,
pass B's drafts the base processors), vanilla, Medusa-Block, the int8 copy
and a 20-token ``prompt_ids`` (a 23-token prompt: two prefill pieces).
Sequences, lengths, accepted drafts, steps and segments are equal; token
log-probs agree to 1e-4 (5e-3 at int8, the bar of
test_torch_int8_generate.py).  Medusa and vanilla decoding of the block
model give the same tokens under the timestamp rules.
"""

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_block_generate import block_models  # noqa: F401
from tests.test_torch_generate import _feats, models  # noqa: F401

TS_BEGIN = 50364


def _same(a, c, lp_tol=1e-4):
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(c.lengths, np.asarray(a.lengths))
    np.testing.assert_array_equal(c.accepted, np.asarray(a.accepted))
    assert c.steps == a.steps
    assert c.segments == a.segments
    np.testing.assert_allclose(c.token_logprobs, a.token_logprobs, rtol=0, atol=lp_tol)


def _grammar(out, prompt_len):
    """The timestamp grammar on every example: no <|notimestamps|>, a
    timestamp first, timestamps non-decreasing."""
    for i in range(out.sequences.shape[0]):
        seq = [t for t in out.sequences[i, prompt_len:out.lengths[i]].tolist() if t != 50257]
        assert 50363 not in seq
        ts = [t for t in seq if t >= TS_BEGIN]
        assert ts == sorted(ts)
        if seq:
            assert seq[0] >= TS_BEGIN


@pytest.mark.parametrize("b,kw", [
    (1, {}), (3, {}), (1, dict(disable_medusa=True)),
    (2, dict(prompt_ids=[50361] + list(range(300, 319)))),
], ids=["B1-K4", "B3-two-pass", "vanilla", "prompt20"])
def test_generate_timestamps_matches_jax(models, b, kw):
    jm, tm = models
    f = _feats(jm.config, seed=20 + b, b=b)
    args = dict(language="en", max_new_tokens=20, return_timestamps=True, **kw)
    a, c = jm.generate(f, **args), tm.generate(f, **args)
    _same(a, c)
    p_len = 3 + len(kw.get("prompt_ids", ()))
    assert c.segments is not None and len(c.segments) == b
    _grammar(c, p_len)


def test_generate_timestamps_int8_matches_jax(models):
    jm, tm = models
    jq, tq = jm.quantize(), tm.quantize()
    f = _feats(jm.config, seed=31)
    args = dict(language="en", max_new_tokens=20, return_timestamps=True)
    _same(jq.generate(f, **args), tq.generate(f, **args), lp_tol=5e-3)


@pytest.mark.parametrize("b", [1, 2])
def test_block_generate_timestamps_matches_jax(block_models, b):
    jm, tm = block_models
    f = _feats(jm.config, seed=40 + b, b=b)
    args = dict(language="en", max_new_tokens=20, return_timestamps=True)
    a, c = jm.generate(f, **args), tm.generate(f, **args)
    _same(a, c)
    van = tm.generate(f, disable_medusa=True, **args)
    for i in range(b):
        n = int(min(c.lengths[i], van.lengths[i]))
        np.testing.assert_array_equal(c.sequences[i, :n], van.sequences[i, :n])
