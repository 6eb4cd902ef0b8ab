"""The ``logits_processor`` hook (``ProcessorConfig.custom``) and the unfused
verification route it takes, port vs the JAX package.

The fixtures of test_torch_generate.py, test_torch_block_generate.py and
test_torch_int8_generate.py (tiny_test_config(vocab_size=51865,
medusa_num_heads=3), float32 on the CPU, nonzero heads).  Each hook is
written twice, in jnp for the JAX package and in torch for the port: one
that forces a token at every position, one that raises a token chosen by
``pred_pos``.  With a hook both packages verify from materialized logits;
the port then calls neither ``verify_hidden`` (K4) nor ``verify_rows`` (K5).
B = 1, 3 and 9, vanilla, Medusa-Block, int8 and ``return_timestamps=True``:
sequences, lengths, steps and accepted drafts are equal, token log-probs
agree to 1e-4 (5e-3 at int8, the bar of test_torch_int8_generate.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_block_generate import block_models  # noqa: F401
from tests.test_torch_generate import _assert_same, _feats, models  # noqa: F401
from tests.test_torch_generate_timestamps import _same as _same_ts
from whisper_medusa_tpu_torch.decoding import speculative as tspec

TOK = 1234
POS_BIAS = 2.0


def _force_jax(logits, pred_pos):
    mask = jnp.arange(logits.shape[-1]) == TOK
    return jnp.where(mask, jnp.zeros_like(logits), jnp.full_like(logits, -1e9))


def _force_torch(logits, pred_pos):
    mask = torch.arange(logits.shape[-1], device=logits.device) == TOK
    return torch.where(mask, torch.zeros_like(logits), torch.full_like(logits, -1e9))


def _pos_jax(logits, pred_pos):
    hit = jnp.arange(logits.shape[-1]) == (300 + pred_pos % 3)[..., None]
    return logits + POS_BIAS * hit.astype(jnp.float32)


def _pos_torch(logits, pred_pos):
    assert pred_pos.dtype == torch.int32
    hit = torch.arange(logits.shape[-1], device=logits.device) == (300 + pred_pos % 3)[..., None]
    return logits + POS_BIAS * hit.float()


HOOKS = {"force": (_force_jax, _force_torch), "pos": (_pos_jax, _pos_torch)}


@pytest.fixture
def verify_calls(monkeypatch):
    """Calls of the fused verification entries from the decode loop."""
    calls = {"verify_hidden": 0, "verify_rows": 0}
    for name in calls:
        real = getattr(tspec.verify_mod, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tspec.verify_mod, name, counted)
    return calls


def _run(jm, tm, f, hook, **kw):
    jh, th = HOOKS[hook]
    return (jm.generate(f, logits_processor=jh, **kw),
            tm.generate(f, logits_processor=th, **kw))


@pytest.mark.parametrize("hook,b,kw", [
    ("force", 1, {}), ("pos", 1, {}), ("pos", 3, {}), ("force", 3, {}), ("pos", 9, {}),
    ("pos", 1, dict(disable_medusa=True)), ("pos", 3, dict(disable_medusa=True)),
], ids=["force-B1", "pos-B1", "pos-B3", "force-B3", "pos-B9", "pos-vanilla",
        "pos-vanilla-B3"])
def test_hook_generate_matches_jax(models, verify_calls, hook, b, kw):
    jm, tm = models
    f = _feats(jm.config, seed=30 + b, b=b)
    a, c = _run(jm, tm, f, hook, language="en", max_length=24, **kw)
    _assert_same(a, c)
    assert verify_calls == {"verify_hidden": 0, "verify_rows": 0}
    if hook == "force":
        for i in range(b):
            gen = c.sequences[i, 4:int(c.lengths[i])]
            assert len(gen) > 0 and (gen == TOK).all()
        if not kw:
            assert int(c.accepted.sum()) > 0


def test_hook_changes_tokens_and_fused_route_without_it(models, verify_calls):
    """The position hook moves tokens (it is applied), and the same request
    without a hook takes the fused route again (at d_model 32 the B = 1 loop
    verifies in two passes, K5)."""
    _, tm = models
    f = _feats(tm.config, seed=31)
    plain = tm.generate(f, language="en", max_length=24)
    assert verify_calls["verify_rows"] > 0
    hooked = tm.generate(f, language="en", max_length=24, logits_processor=_pos_torch)
    assert not np.array_equal(plain.sequences, hooked.sequences)
    # An identity hook takes the unfused route and gives the fused tokens.
    before = dict(verify_calls)
    same = tm.generate(f, language="en", max_length=24, logits_processor=lambda x, p: x)
    assert verify_calls == before
    np.testing.assert_array_equal(same.sequences, plain.sequences)
    np.testing.assert_array_equal(same.accepted, plain.accepted)
    np.testing.assert_allclose(same.token_logprobs, plain.token_logprobs, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b", [1, 2])
def test_hook_block_generate_matches_jax(block_models, verify_calls, b):
    jm, tm = block_models
    f = _feats(jm.config, seed=40 + b, b=b)
    a, c = _run(jm, tm, f, "pos", language="en", max_length=24)
    _assert_same(a, c)
    assert int(c.accepted.sum()) > 0
    assert verify_calls == {"verify_hidden": 0, "verify_rows": 0}


def test_hook_int8_generate_matches_jax(models, verify_calls):
    jm, tm = models
    jq, tq = jm.quantize(), tm.quantize()
    f = _feats(jm.config, seed=44)
    a, c = _run(jq, tq, f, "pos", language="en", max_length=24)
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(c.lengths, np.asarray(a.lengths))
    np.testing.assert_array_equal(c.accepted, np.asarray(a.accepted))
    assert c.steps == a.steps
    np.testing.assert_allclose(c.token_logprobs, a.token_logprobs, rtol=0, atol=5e-3)
    assert verify_calls == {"verify_hidden": 0, "verify_rows": 0}


@pytest.mark.parametrize("b", [1, 3])
def test_hook_timestamps_match_jax(models, verify_calls, b):
    jm, tm = models
    f = _feats(jm.config, seed=50 + b, b=b)
    a, c = _run(jm, tm, f, "pos", language="en", max_new_tokens=20, return_timestamps=True)
    _same_ts(a, c)
    assert c.segments is not None and len(c.segments) == b
    assert verify_calls == {"verify_hidden": 0, "verify_rows": 0}
