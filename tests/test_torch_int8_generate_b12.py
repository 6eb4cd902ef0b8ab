"""int8 serving past eight examples: the port's ``model.quantize().generate``
at B = 12 vs the JAX package's ``quantize().generate``.

The fixture of test_torch_int8_generate.py.  At B = 12 the port decodes
through the per-op step, whose int8 FFN goes through ``ffn`` (``dense`` ->
GELU -> ``dense``, K6 on the card) as the JAX scan path's does, and whose
cross-attention reads the int8 cross K/V with their scales (K10's int8 mode
on the card).  Tokens, lengths, accepted drafts, steps and
``steps_per_example`` are equal; token log-probs agree within 5e-3, the bar
of test_torch_int8_generate.py (the JAX package runs its int8 decode under
one ``jit``, where XLA may keep f32 values its code rounds to bf16).
"""

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _feats, models  # noqa: F401
from tests.test_torch_int8_generate import qmodels  # noqa: F401

B = 12


@pytest.mark.parametrize("disable_medusa", [False, True], ids=["medusa", "vanilla"])
def test_int8_b12_generate_matches_jax(qmodels, disable_medusa):
    jq, tq = qmodels
    assert tq.params["whisper"]["decoder"]["layers"]["fc1_w"]["q"].dtype == torch.int8
    f = _feats(jq.config, seed=22, b=B)
    kw = dict(language="en", max_length=20, disable_medusa=disable_medusa)
    a, c = jq.generate(f, **kw), tq.generate(f, **kw)
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(c.lengths, np.asarray(a.lengths))
    np.testing.assert_array_equal(c.accepted, np.asarray(a.accepted))
    np.testing.assert_array_equal(c.steps_per_example, np.asarray(a.steps_per_example))
    assert c.steps == a.steps and c.sequences.shape[0] == B
    if not disable_medusa:
        assert int(c.accepted.sum()) > 0
    np.testing.assert_allclose(c.token_logprobs, a.token_logprobs, rtol=0, atol=5e-3)
