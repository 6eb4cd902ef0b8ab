"""The slice as a whole: ``quantize().generate`` of an f32 model (the int8
copy of an f32 model, W8A32) in the port vs the JAX package with its
megastep and verification kernels in interpret mode, its route on a TPU.

tiny_test_config(vocab_size=51865, medusa_num_heads=3) widened to d_model
256 (4 heads of 64, FFN 512): the width at which both packages take their
whole-stack kernel (the port's K2 takes d_model % 256 == 0, the JAX kernel
% 128) and their fused verification (V >= 8192, d_model % 128).  f32
weights from the JAX ``from_random``, heads near the identity (so drafts
of a repeating random model get accepted), each side quantized by its own
``quantize()``.  Medusa and vanilla at B=1 here, B=3 in
test_torch_w8a32_generate_b3.py, Medusa-Block in
test_torch_w8a32_block_generate.py.  Tokens, lengths, accepted drafts and
steps are equal.  Token log-probs agree within 2e-3: each side's unfused
vocab projection (the prefill's first token, K7 as JAX's ``qmm_nt``)
rounds its f32 rows to bf16, where the ~2e-6 by which the two sides'
hidden states differ can flip a rounding; the fused verification scores
f32 rows in f32 on both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_generate import _feats
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel
from whisper_medusa_tpu.ops import megastep as jmegastep
from whisper_medusa_tpu.ops import verify as jverify
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel as TModel
from whisper_medusa_tpu_torch.ops import megastep as tmegastep

LOGPROB_TOL = 2e-3


@pytest.fixture(autouse=True)
def kernels(monkeypatch):
    """The JAX kernels in interpret mode; calls of each side's route."""
    for mod in (jmegastep, jverify):
        monkeypatch.setattr(mod, "_INTERPRET", True)
        monkeypatch.setattr(mod, "_ENABLED", True)
    for var in ("WM_MEGASTEP_PREFETCH", "WM_MEGASTEP_PREFETCH_CROSS", "WM_MEGASTEP_MAX_B",
                "WM_MEGASTEP_W8A8", "WM_INT8_SELF_KV", "WM_VERIFY_TWOPASS",
                "WM_VERIFY_FUSE_ROWS"):
        monkeypatch.delenv(var, raising=False)
    calls = {"jax_fused": 0, "port_fused": 0, "port_ops": 0}

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(jmegastep, "fused_decoder_layers",
                        counted("jax_fused", jmegastep.fused_decoder_layers))
    monkeypatch.setattr(tmegastep, "fused_decoder_layers",
                        counted("port_fused", tmegastep.fused_decoder_layers))
    monkeypatch.setattr(tw, "decoder_layers_ops", counted("port_ops", tw.decoder_layers_ops))
    return calls


def w8a32_models(heads_type="base_head"):
    """(JAX, port) int8 copies of one f32 model at d_model 256."""
    cfg = tiny_test_config(vocab_size=51865, medusa_num_heads=3,
                           medusa_heads_type=heads_type)
    dims = dataclasses.replace(cfg.dims, d_model=256, encoder_attention_heads=4,
                               decoder_attention_heads=4, encoder_ffn_dim=512,
                               decoder_ffn_dim=512)
    cfg = dataclasses.replace(cfg, dims=dims,
                              medusa=dataclasses.replace(cfg.medusa, medusa_hidden_size=256))
    jm = JModel.from_random(cfg, seed=0)
    rng = np.random.default_rng(0)
    med = jm.params["medusa"]
    med["heads"]["w"] = jnp.asarray(0.01 * rng.standard_normal(med["heads"]["w"].shape),
                                    jnp.float32)
    if "block" in med:
        med["block"] = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a) + (0.05 if a.ndim < 2 else 0.02)
                                  * rng.standard_normal(a.shape), jnp.float32),
            med["block"])
    tm = TModel(tconfig.ModelConfig.from_dict(cfg.to_dict()),
                bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu"),
                device="cpu")
    jq, tq = jm.quantize(), tm.quantize()
    layers = tq.params["whisper"]["decoder"]["layers"]
    assert layers["self"]["q_w"]["q"].dtype.is_floating_point is False
    assert layers["self_ln"]["scale"].dtype == layers["self"]["q_b"].dtype
    assert str(layers["self_ln"]["scale"].dtype) == "torch.float32"
    return jq, tq


@pytest.fixture(scope="module")
def w8a32_pair():
    return w8a32_models()


def check_same(a, c, calls, medusa=True):
    """Tokens, lengths, accepts and steps equal, log-probs within
    LOGPROB_TOL; both sides took their whole-stack kernel's route."""
    np.testing.assert_array_equal(c.sequences, np.asarray(a.sequences))
    np.testing.assert_array_equal(c.lengths, np.asarray(a.lengths))
    np.testing.assert_array_equal(c.accepted, np.asarray(a.accepted))
    assert c.steps == a.steps
    assert c.mean_accept_length == pytest.approx(a.mean_accept_length, abs=1e-12)
    if medusa:
        assert int(c.accepted.sum()) > 0
    np.testing.assert_allclose(c.token_logprobs, a.token_logprobs, rtol=0, atol=LOGPROB_TOL)
    assert calls["jax_fused"] > 0 and calls["port_fused"] >= c.steps > 0
    assert tmegastep.w8a32_launches == tmegastep.w8a32_block_launches == 0


@pytest.mark.parametrize("disable_medusa", [False, True], ids=["medusa", "vanilla"])
def test_w8a32_generate_matches_jax_kernels(w8a32_pair, kernels, disable_medusa):
    jq, tq = w8a32_pair
    f = _feats(jq.config, seed=11)
    kw = dict(language="en", max_length=24, disable_medusa=disable_medusa)
    a, c = jq.generate(f, **kw), tq.generate(f, **kw)
    check_same(a, c, kernels, medusa=not disable_medusa)
