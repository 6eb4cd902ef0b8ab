"""The slice as a whole at B=3: the int8 copy of an f32 model at d_model
256, the port's ``generate`` vs the JAX package's with its megastep and
verification kernels in interpret mode (the fixtures and tolerances of
test_torch_w8a32_generate.py).  Medusa (two-pass verification on both
sides) and vanilla: tokens, lengths, accepted drafts and steps equal,
token log-probs within 2e-3; each example's tokens at B=3 equal its tokens
decoded alone.
"""

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _feats
from tests.test_torch_w8a32_generate import check_same, kernels, w8a32_pair  # noqa: F401


@pytest.mark.parametrize("disable_medusa", [False, True], ids=["medusa", "vanilla"])
def test_w8a32_generate_b3_matches_jax_kernels(w8a32_pair, kernels,  # noqa: F811
                                               disable_medusa):
    jq, tq = w8a32_pair
    f = _feats(jq.config, seed=12, b=3)
    kw = dict(language="en", max_length=16, disable_medusa=disable_medusa)
    a, c = jq.generate(f, **kw), tq.generate(f, **kw)
    check_same(a, c, kernels, medusa=not disable_medusa)
    if not disable_medusa:
        alone = tq.generate(f[1:2], **kw)
        np.testing.assert_array_equal(alone.sequences[0], c.sequences[1])
