"""f32 serving (ModelConfig's default dtype) takes the per-op decoder step.

K2 takes bf16 or all-int8 streamed weights only (``megastep.fits``, as the
JAX gate ``megastep.available``), so every f32 decoder step runs
``models/whisper.py::decoder_layers_ops`` — on the card the f32 modes of
K10 and K11 — at every B, as JAX's f32 step is its scan.  Here, on the CPU:
``fits`` refuses f32 streamed weights and takes bf16 and int8 ones at the
same shapes; f32 ``generate`` at B = 1 and 3, Medusa and vanilla, gives the
JAX package's tokens, lengths, accepted drafts and steps (log-probs within
1e-4) with every decoder step on the per-op route.  The tiny test config,
float32, the fixtures of test_torch_generate.py.
"""

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _assert_same, _feats, models  # noqa: F401
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.ops import megastep as tmegastep
from whisper_medusa_tpu_torch.ops import qmm as tqmm

_STREAMED = (("self", "q_w"), ("self", "k_w"), ("self", "v_w"), ("self", "o_w"),
             ("cross", "q_w"), ("cross", "o_w"), ("fc1_w",), ("fc2_w",))


@pytest.fixture
def routes(monkeypatch):
    """Calls of each route of decode_step."""
    calls = {"fused": 0, "ops": 0}

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(tmegastep, "fused_decoder_layers",
                        counted("fused", tmegastep.fused_decoder_layers))
    monkeypatch.setattr(tw, "decoder_layers_ops", counted("ops", tw.decoder_layers_ops))
    return calls


def _layers(kind):
    """A (2-layer) stack of K2's streamed weights at large-v2's shapes (one
    row each stands for the weight: ``fits`` reads dtypes and fc1_b's
    shape), in ``kind``: f32, bf16, int8, or int8 with one bf16 weight."""
    def leaf(path):
        shape = (2, 1, 1280)
        if kind == "f32" or (kind == "mixed" and path == ("fc2_w",)):
            return torch.zeros(shape, dtype=torch.float32 if kind == "f32" else torch.bfloat16)
        if kind == "bf16":
            return torch.zeros(shape, dtype=torch.bfloat16)
        return {"q": torch.zeros(shape, dtype=torch.int8), "s": torch.ones((2, 1280))}

    layers = {"fc1_b": torch.zeros((2, 5120))}
    for path in _STREAMED:
        node = layers
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf(path)
    return layers


@pytest.mark.parametrize("kind,fits", [("f32", False), ("bf16", True), ("int8", True),
                                       ("mixed", False)])
def test_fits_refuses_f32_streamed_weights(kind, fits):
    layers = _layers(kind)
    assert tqmm.is_quantized(layers["fc1_w"]) == (kind in ("int8", "mixed"))
    x, ck = torch.zeros((1, 11, 1280)), torch.zeros((2, 1, 20, 64, 1500))
    sk = torch.zeros((2, 1, 460, 1280))
    assert tmegastep.streamed_dtypes_fit(layers) == fits
    assert tmegastep.fits(layers, x, sk, ck, 20) == fits


@pytest.mark.parametrize("b,vanilla", [(1, False), (1, True), (3, False), (3, True)],
                         ids=["B1-medusa", "B1-vanilla", "B3-medusa", "B3-vanilla"])
def test_f32_generate_takes_the_per_op_step(models, routes, b, vanilla):  # noqa: F811
    jm, tm = models
    assert tm.params["whisper"]["decoder"]["layers"]["fc1_w"].dtype == torch.float32
    f = _feats(jm.config, seed=30 + b, b=b)
    kw = dict(language="en", max_length=20, disable_medusa=vanilla)
    a, c = jm.generate(f, **kw), tm.generate(f, **kw)
    if not vanilla:
        assert int(np.asarray(a.accepted).sum()) > 0
    _assert_same(a, c)
    assert routes["fused"] == 0 and routes["ops"] >= c.steps > 0
