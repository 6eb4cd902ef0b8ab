"""Serving past eight examples: the port's ``generate`` at B = 12 vs the JAX
package's, on the same weights.

B = 12 is past K2's batch (``megastep.fits``: B <= 8), so the port decodes
through the per-op step (``models/whisper.py::decoder_layers_ops``) and the
JAX package through its ``lax.scan`` over ``decoder_layer_step``; both verify
in two passes.  The fixtures of test_torch_generate.py (base_head and
vanilla) and test_torch_block_generate.py (medusa_block), float32 on the
CPU: tokens, lengths, accepted drafts, steps and ``steps_per_example`` are
equal; token log-probs agree to 1e-4.
"""

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_block_generate import block_models  # noqa: F401
from tests.test_torch_generate import _assert_same, _feats, models  # noqa: F401

B = 12


def _check(a, c):
    _assert_same(a, c)
    np.testing.assert_array_equal(c.steps_per_example, np.asarray(a.steps_per_example))
    assert c.sequences.shape[0] == B


@pytest.mark.parametrize("disable_medusa", [False, True], ids=["base_head", "vanilla"])
def test_b12_generate_matches_jax(models, disable_medusa):
    jm, tm = models
    f = _feats(jm.config, seed=20, b=B)
    kw = dict(language="en", max_length=20, disable_medusa=disable_medusa)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    if not disable_medusa:
        assert int(np.asarray(a.accepted).sum()) > 0
    _check(a, c)


def test_b12_block_generate_matches_jax(block_models):
    jm, tm = block_models
    f = _feats(jm.config, seed=21, b=B)
    kw = dict(language="en", max_length=20)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    assert int(np.asarray(a.accepted).sum()) > 0
    _check(a, c)
