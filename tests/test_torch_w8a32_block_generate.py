"""The slice as a whole in Medusa-Block: the int8 copy of an f32
Medusa-Block model at d_model 256 (the block layer quantized beside the
decoder), the port's ``generate`` vs the JAX package's with its megastep
kernel (the block as grid layer L) and its verification kernel (identity0
rows) in interpret mode; the fixtures and tolerances of
test_torch_w8a32_generate.py.  B=1: tokens, lengths, accepted drafts and
steps equal, token log-probs within 2e-3.
"""

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _feats
from tests.test_torch_w8a32_generate import check_same, kernels, w8a32_models  # noqa: F401


@pytest.fixture(scope="module")
def block_pair():
    return w8a32_models("medusa_block")


def test_w8a32_block_generate_matches_jax_kernels(block_pair, kernels):  # noqa: F811
    jq, tq = block_pair
    assert "block" in tq.params["medusa"]
    f = _feats(jq.config, seed=13)
    kw = dict(language="en", max_length=24)
    a, c = jq.generate(f, **kw), tq.generate(f, **kw)
    check_same(a, c, kernels)
