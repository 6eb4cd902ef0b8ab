"""The Medusa-Block decode step: port init_cache(extra_layers=1) +
set_block_cross_kv + decode_step(block=...) (ops/megastep.py plain path, the
plain version of K2's block mode) vs the JAX package's
decode_step(block_params=...) on its scan path.

At the dims of test_torch_megastep.py (d=128, 2 layers, 2 heads of 64), a
block layer perturbed away from the last decoder layer, a 5-token prefill
and then a 4-token chunk at offset 5.  Compared: hidden, pre_norm,
block_hidden and the rows [0, 9) of every self slab slot, slot L (the
block's) included, and the block's cross K/V: f32 within 1e-4, bf16 within
3e-2 (ROADMAP R3).  int8 (each side's tree from the JAX quantize_decoder):
the port's step runs on the JAX cache (the port's own int8 cross K/V lie
within one int8 step of it, checked too), hidden and block_hidden within
3e-2, the written rows dequantized within 3e-2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_int8_decode import _dequant, _port_cache
from tests.test_torch_megastep import MAX_LEN, _dims, _np, _t
from whisper_medusa_tpu.config import MedusaConfig
from whisper_medusa_tpu.models import medusa as jmedusa
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu.ops import megastep as jmegastep
from whisper_medusa_tpu.ops import qmm as jqmm
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.ops import megastep as tmegastep

PRE, T = 5, 4


@pytest.fixture(autouse=True)
def scan_path(monkeypatch):
    monkeypatch.setattr(jmegastep, "_ENABLED", False)
    for var in ("WM_MEGASTEP_PREFETCH", "WM_MEGASTEP_PREFETCH_CROSS", "WM_INT8_SELF_KV"):
        monkeypatch.delenv(var, raising=False)


@functools.lru_cache(maxsize=None)
def _setup(dtype, quantize=False, seed=0):
    """JAX params, a perturbed block, encoder rows and tokens, and the same
    params bridged into the port (read-only: the steps write only caches)."""
    dims = _dims()
    rng = np.random.default_rng(seed)
    perturb = lambda a, s: (a + s * rng.standard_normal(a.shape)).astype(dtype)
    wp = jw.init_whisper_params(jax.random.PRNGKey(seed), dims, dtype)
    wp["decoder"]["layers"] = jax.tree.map(
        lambda a: a if a.ndim >= 3 else perturb(a, 0.05), wp["decoder"]["layers"])
    mc = MedusaConfig(medusa_num_heads=2, medusa_hidden_size=dims.d_model,
                      medusa_heads_type="medusa_block", medusa_choices=(1, 1, 1))
    mp = jmedusa.init_medusa_params(jax.random.PRNGKey(7), dims, mc, wp, dtype)
    block = jax.tree.map(lambda a: perturb(a, 0.05 if a.ndim < 2 else 0.02), mp["block"])
    if quantize:
        wp, mq = jqmm.quantize_decoder(wp, {"block": block})
        block = mq["block"]
    enc = np.asarray(rng.standard_normal((1, 32, dims.d_model)), np.float32)
    tokens = rng.integers(0, 255, (1, PRE + T)).astype(np.int32)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, {"w": wp, "b": block}),
                                  device="cpu")
    return dims, wp, block, jnp.asarray(enc, dtype), tokens, tp


def _steps_jax(dims, wp, block, cache, tokens):
    kw = dict(block_params=block)
    _, cache = jw.decode_step(wp, dims, jnp.asarray(tokens[:, :PRE]), cache,
                              jnp.zeros((1,), jnp.int32), **kw)
    return jw.decode_step(wp, dims, jnp.asarray(tokens[:, PRE:]), cache,
                          jnp.full((1,), PRE, jnp.int32), **kw)


def _steps_port(dims, tp, cache, tokens):
    tdims = tconfig.WhisperDims(**dataclasses.asdict(dims))
    tok = torch.from_numpy(tokens)
    tw.decode_step(tp["w"], tdims, tok[:, :PRE], cache, torch.zeros((1,), dtype=torch.int32),
                   block=tp["b"])
    out = tw.decode_step(tp["w"], tdims, tok[:, PRE:], cache,
                         torch.full((1,), PRE, dtype=torch.int32), block=tp["b"])
    assert tmegastep.block_launches == 0 and tmegastep.q_block_launches == 0
    return out


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-4), (jnp.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_block_decode_step_matches_jax(dtype, tol):
    dims, wp, block, enc, tokens, tp = _setup(dtype)
    nl = dims.decoder_layers
    jc = jw.set_block_cross_kv(jw.init_cache(wp, dims, enc, MAX_LEN, extra_layers=1),
                               block, enc, dims.decoder_attention_heads)
    out_j, jc = _steps_jax(dims, wp, block, jc, tokens)
    tdims = tconfig.WhisperDims(**dataclasses.asdict(dims))
    tc = tw.init_cache(tp["w"], tdims, _t(enc), MAX_LEN, extra_layers=1)
    assert tc.self_k.shape[0] == tc.cross_k.shape[0] == nl + 1
    tw.set_block_cross_kv(tc, tp["b"], _t(enc), dims.decoder_attention_heads)
    out_t = _steps_port(dims, tp, tc, tokens)
    assert out_t.block_hidden is not None
    pairs = {name: (getattr(out_j, name), getattr(out_t, name))
             for name in ("hidden", "pre_norm", "block_hidden")}
    for slot in range(nl + 1):
        pairs[f"self_k[{slot}]"] = (jc.self_k[slot, :, :PRE + T], tc.self_k[slot, :, :PRE + T])
        pairs[f"self_v[{slot}]"] = (jc.self_v[slot, :, :PRE + T], tc.self_v[slot, :, :PRE + T])
    pairs["cross_k[L]"] = (jc.cross_k[nl], tc.cross_k[nl])
    pairs["cross_v[L]"] = (jc.cross_v[nl], tc.cross_v[nl])
    for name, (a, b) in pairs.items():
        np.testing.assert_allclose(_np(b), np.asarray(a, np.float32), rtol=tol, atol=tol,
                                   err_msg=name)


def test_block_decode_step_matches_jax_int8():
    dims, wq, block, enc, tokens, tq = _setup(jnp.bfloat16, quantize=True)
    nl, nh = dims.decoder_layers, dims.decoder_attention_heads
    jc = jw.set_block_cross_kv(jw.init_cache(wq, dims, enc, MAX_LEN, extra_layers=1),
                               block, enc, nh)
    # The port's own block cross K/V: within one int8 step of the JAX ones.
    tdims = tconfig.WhisperDims(**dataclasses.asdict(dims))
    own = tw.set_block_cross_kv(tw.init_cache(tq["w"], tdims, _t(enc), MAX_LEN,
                                              extra_layers=1), tq["b"], _t(enc), nh)
    js = _t(jc.cross_k_s)[nl]
    np.testing.assert_allclose(own.cross_k_s[nl].numpy(), js.numpy(), rtol=1e-2, atol=0)
    deq = lambda q, s: q.float() * s[:, :, None, :]
    step = float(torch.maximum(own.cross_k_s[nl], js).max())
    assert float((deq(own.cross_k[nl], own.cross_k_s[nl])
                  - deq(_t(jc.cross_k)[nl], js)).abs().max()) <= 1.0001 * step
    tc = _port_cache(jc, nh)
    out_j, jc = _steps_jax(dims, wq, block, jc, tokens)
    out_t = _steps_port(dims, tq, tc, tokens)
    for name in ("hidden", "block_hidden"):
        np.testing.assert_allclose(_np(getattr(out_t, name)),
                                   np.asarray(getattr(out_j, name), np.float32),
                                   rtol=3e-2, atol=3e-2, err_msg=name)
    js = _t(jc.self_s)[..., :2 * nh]
    rows = slice(PRE, PRE + T)
    for lanes, jslab, tslab in ((slice(0, nh), jc.self_k, tc.self_k),
                                (slice(nh, 2 * nh), jc.self_v, tc.self_v)):
        a = _dequant(_t(jslab)[:, 0, rows], js[:, 0, rows, lanes], nh)
        b = _dequant(tslab[:, 0, rows], tc.self_s[:, 0, rows, lanes], nh)
        assert a.shape[0] == nl + 1
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=3e-2, atol=3e-2)


def test_block_slots_are_checked():
    """The layer loop refuses slabs without the block's slot, and with one
    that no block fills."""
    dims, wp, block, enc, tokens, tp = _setup(jnp.float32)
    tdims = tconfig.WhisperDims(**dataclasses.asdict(dims))
    tok = torch.from_numpy(tokens[:, :PRE])
    zero = torch.zeros((1,), dtype=torch.int32)
    plain = tw.init_cache(tp["w"], tdims, _t(enc), MAX_LEN)
    with pytest.raises(ValueError, match="3 layer slots"):
        tw.decode_step(tp["w"], tdims, tok, plain, zero, block=tp["b"])
    extra = tw.init_cache(tp["w"], tdims, _t(enc), MAX_LEN, extra_layers=1)
    with pytest.raises(ValueError, match="2 layer slots"):
        tw.decode_step(tp["w"], tdims, tok, extra, zero)
