"""f32 Medusa-Block and timestamp requests take the per-op decoder step.

The fixtures of test_torch_block_generate.py and test_torch_generate.py
(tiny_test_config, float32 on the CPU): a Medusa-Block ``generate`` at B=1
(identity0 rows) and a ``return_timestamps=True`` request at B=1 (the rules
fused into the verification pass) give the JAX package's tokens, lengths,
accepted drafts, steps (and segments) with every decoder step on the per-op
route: ``megastep.fits`` refuses f32 weights, as the JAX gate does.
"""

import numpy as np

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_block_generate import block_models  # noqa: F401
from tests.test_torch_f32_generate import routes  # noqa: F401
from tests.test_torch_generate import _assert_same, _feats, models  # noqa: F401
from tests.test_torch_generate_timestamps import _grammar, _same


def test_f32_block_generate_takes_the_per_op_step(block_models, routes):  # noqa: F811
    jm, tm = block_models
    f = _feats(jm.config, seed=41)
    kw = dict(language="en", max_length=20)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    assert int(np.asarray(a.accepted).sum()) > 0
    _assert_same(a, c)
    assert routes["fused"] == 0 and routes["ops"] >= c.steps > 0


def test_f32_timestamps_take_the_per_op_step(models, routes):  # noqa: F811
    jm, tm = models
    f = _feats(jm.config, seed=42)
    kw = dict(language="en", max_new_tokens=16, return_timestamps=True)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    _same(a, c)
    _grammar(c, 3)
    assert routes["fused"] == 0 and routes["ops"] >= c.steps > 0
