"""Verification at B=1 on long chains: the port's ``generate`` against the
JAX package's on the same weights, with the verification route counted.

K4 (``ops/verify.py::verify_hidden``) takes the JAX gate's scope
(``verify.hidden_available``): R = (heads) * B * N <= 1024 rows and a head
stack of at most 40 MiB; past that the decode loop verifies in two passes
(``head_rows`` + K5 ``verify_rows``, then the draft heads at the accepted
node), as the JAX package does where its ``hidden_available`` is False.  A
d_model-256 variant of ``tiny_test_config`` (4 heads of 64, ffn 256: K2's
widths, so D % 64 == 0 and only R decides), float32 on the CPU: 10 draft
heads give R = 121, 11 give R = 144 and 16 give a 17-node chain, R = 289,
all one K4 pass a step; the 17-node chain also runs the per-op decoder step
at bf16 too (T = 17 > 16; f32 weights run it at every T).  Tokens, lengths,
accepted drafts and steps equal the JAX package's; token log-probs agree to
1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _assert_same, _feats
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel as TModel
from whisper_medusa_tpu_torch.ops import megastep as tmegastep
from whisper_medusa_tpu_torch.ops import verify as tverify


def _models(heads):
    cfg = tiny_test_config(vocab_size=51865, medusa_num_heads=heads)
    dims = dataclasses.replace(cfg.dims, d_model=256, encoder_attention_heads=4,
                               decoder_attention_heads=4, encoder_ffn_dim=256,
                               decoder_ffn_dim=256)
    cfg = dataclasses.replace(cfg, dims=dims, medusa=dataclasses.replace(
        cfg.medusa, medusa_hidden_size=256))
    jm = JModel.from_random(cfg, seed=0)
    rng = np.random.default_rng(0)
    w = jm.params["medusa"]["heads"]["w"]
    jm.params["medusa"]["heads"]["w"] = jnp.asarray(
        0.01 * rng.standard_normal(w.shape), jnp.float32)
    tm = TModel(tconfig.ModelConfig.from_dict(cfg.to_dict()),
                bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu"),
                device="cpu")
    return jm, tm


def _counted(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def run(*args, **kw):
        calls[name] += 1
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, run)


@pytest.mark.parametrize("heads,fused,per_op", [(10, True, False), (11, True, False),
                                                (16, True, True)])
def test_b1_route_matches_jax(monkeypatch, heads, fused, per_op):
    jm, tm = _models(heads)
    nodes = heads + 1
    assert tverify.hidden_available(1, nodes, heads + 1, False, 51865, 256) == fused
    calls = {"verify_hidden": 0, "verify_rows": 0, "head_rows": 0, "decoder_layers_ops": 0}
    for name in ("verify_hidden", "verify_rows", "head_rows"):
        _counted(monkeypatch, tverify, name, calls)
    _counted(monkeypatch, tw, "decoder_layers_ops", calls)
    f = _feats(jm.config, seed=1)
    kw = dict(language="en", max_length=48)
    a, b = jm.generate(f, **kw), tm.generate(f, **kw)
    assert a.steps > 0 and int(np.asarray(a.accepted).sum()) > 0
    _assert_same(a, b)
    steps = b.steps
    if fused:
        assert calls["verify_hidden"] == steps and calls["verify_rows"] == 0
    else:
        # Pass A on every step: head 0's rows, then K5 over them.
        assert calls["verify_hidden"] == 0
        assert calls["verify_rows"] == steps and calls["head_rows"] >= steps
    # f32 weights take the per-op step at every T (megastep.fits refuses f32,
    # as JAX's gate does); per_op marks the chain that K2 would not take at
    # bf16 either (T = 17 > 16).
    assert calls["decoder_layers_ops"] >= steps
    assert (nodes > tmegastep.MAX_T) == per_op


@pytest.mark.parametrize("b,n,heads,identity0,d,want", [
    (1, 11, 11, False, 1280, True),      # R = 121: the 10-head chain
    (1, 12, 12, False, 1280, True),      # R = 144, a 39.3 MB stack: the 11-head chain
    (1, 11, 10, True, 1280, True),       # Medusa-Block: (10 + 1) * 11
    (1, 12, 11, True, 1280, True),
    (2, 8, 8, False, 1280, True),        # B * N = 16, R = 128
    (1, 17, 1, False, 1280, True),       # B * N = 17
    (1, 17, 17, False, 384, True),       # tiny's 16-head chain: R = 289
    (1, 17, 17, False, 1280, False),     # large-v2's 16-head chain: a 55.7 MB stack
    (8, 11, 11, False, 1280, True),      # R = 968
    (1, 33, 32, False, 256, False),      # R = 1056 > 1024
    (1, 11, 11, False, 32, False),       # D % 64
    (1, 11, 0, False, 1280, False),      # no heads
])
def test_hidden_available(b, n, heads, identity0, d, want):
    assert tverify.hidden_available(b, n, heads, identity0, 51865, d) is want
