"""int8 serving decode: port init_cache / decode_step (ops/megastep.py plain
path, the plain version of K2's int8 mode) vs the JAX package on a tree
quantized by the JAX quantize_decoder.

init_cache (f32): the dequantized cross K/V lie within one int8 step (times
the scale) of the JAX ones and the scales within 1e-6 relative; both sides
round half to even, but the projections sum in another order.

decode_step (bf16): the JAX whole-stack megastep kernel in its int8 mode,
in interpret mode, at the dims of test_torch_megastep.py, B=1 T=11 and B=3
with offsets that differ at T=1.  hidden and pre_norm within 3e-2; the self
rows the step wrote, dequantized, within 3e-2 (a row's K/V may round to the
neighbouring int8 step); their bf16 scales within one bf16 ulp.  The JAX
cache carries +16 rows of TPU slack and 128 scale lanes; only the rows each
example's step writes are compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_megastep import MAX_LEN, _dims, _np, _t
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu.ops import megastep as jmegastep
from whisper_medusa_tpu.ops import qmm as jqmm
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.ops import megastep as tmegastep


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jmegastep, "_INTERPRET", True)
    monkeypatch.setattr(jmegastep, "_ENABLED", True)
    for var in ("WM_MEGASTEP_PREFETCH", "WM_MEGASTEP_PREFETCH_CROSS", "WM_MEGASTEP_MAX_B",
                "WM_MEGASTEP_W8A8", "WM_INT8_SELF_KV"):
        monkeypatch.delenv(var, raising=False)


def _quantized(dtype, seed):
    dims = _dims()
    rng = np.random.default_rng(seed)
    wp = jw.init_whisper_params(jax.random.PRNGKey(seed), dims, dtype)
    wp["decoder"]["layers"] = jax.tree.map(
        lambda a: a if a.ndim >= 3 else (a + 0.05 * rng.standard_normal(a.shape)).astype(dtype),
        wp["decoder"]["layers"])
    wq, _ = jqmm.quantize_decoder(wp)
    tq = bridge.params_from_numpy(jax.tree.map(np.asarray, wq), device="cpu")
    return dims, wq, tq, rng


def _port_cache(cache, nh):
    """The JAX cache in the port's layout: no slack rows, 2H scale lanes."""
    cut = lambda a: _t(a)[:, :, :MAX_LEN].contiguous()
    return tw.KVCache(self_k=cut(cache.self_k), self_v=cut(cache.self_v),
                      cross_k=_t(cache.cross_k), cross_v=_t(cache.cross_v),
                      cross_k_s=_t(cache.cross_k_s), cross_v_s=_t(cache.cross_v_s),
                      self_s=_t(cache.self_s)[:, :, :MAX_LEN, :2 * nh].contiguous())


def test_init_cache_matches_jax():
    dims, wq, tq, rng = _quantized(jnp.float32, 1)
    enc = rng.standard_normal((2, 32, dims.d_model)).astype(np.float32)
    jc = jw.init_cache(wq, dims, jnp.asarray(enc), MAX_LEN)
    tc = tw.init_cache(tq, tconfig.WhisperDims(**dataclasses.asdict(dims)),
                       torch.from_numpy(enc), MAX_LEN)
    nh = dims.decoder_attention_heads
    assert tc.self_k.dtype == torch.int8 and tc.self_k.shape == (2, 2, MAX_LEN, 128)
    assert tc.self_s.dtype == torch.bfloat16 and tc.self_s.shape == (2, 2, MAX_LEN, 2 * nh)
    assert bool((tc.self_s == 1).all())
    for q, s, jq, js, deq in (
            (tc.cross_k, tc.cross_k_s, jc.cross_k, jc.cross_k_s,
             lambda q, s: q.float() * s[:, :, :, None, :]),
            (tc.cross_v, tc.cross_v_s, jc.cross_v, jc.cross_v_s,
             lambda q, s: (q.float().reshape(*q.shape[:3], nh, -1)
                           * s.permute(0, 1, 3, 2)[..., None]).reshape(q.shape))):
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        js, jq = _t(js), _t(jq)
        np.testing.assert_allclose(s.numpy(), js.numpy(), rtol=1e-6, atol=0)
        step = torch.maximum(s, js).max()
        assert float((deq(q, s) - deq(jq, js)).abs().max()) <= 1.0001 * float(step)


def _run_both(t, offs, seed=0):
    b = len(offs)
    dims, wq, tq, rng = _quantized(jnp.bfloat16, seed)
    enc = jnp.asarray(rng.standard_normal((b, 32, dims.d_model)), jnp.bfloat16)
    cache = jw.init_cache(wq, dims, enc, MAX_LEN)
    off = max(offs)
    if off:
        # History through the JAX scan path, so that its int8 rows and scales
        # are read back by the step under test.
        pre = jnp.asarray(rng.integers(0, 255, (b, off)), jnp.int32)
        enabled, jmegastep._ENABLED = jmegastep._ENABLED, False
        try:
            _, cache = jw.decode_step(wq, dims, pre, cache, jnp.zeros((b,), jnp.int32))
        finally:
            jmegastep._ENABLED = enabled
    nh = dims.decoder_attention_heads
    tcache = _port_cache(cache, nh)
    tokens = rng.integers(0, 255, (b, t)).astype(np.int32)
    offsets = np.asarray(offs, np.int32)
    assert jmegastep.available(wq["decoder"]["layers"], 128, nh, b, t, False, 1)
    out_j, cache_j = jw.decode_step(wq, dims, jnp.asarray(tokens), cache,
                                    jnp.asarray(offsets))
    out_t = tw.decode_step(tq, tconfig.WhisperDims(**dataclasses.asdict(dims)),
                           torch.from_numpy(tokens), tcache, torch.from_numpy(offsets))
    assert tmegastep.q_launches == 0
    return nh, out_j, cache_j, out_t, tcache


def _dequant(slab, scales, nh):
    """(L, S, D) int8 x (L, S, H) scales -> f32 rows."""
    l, s, d = slab.shape
    return (slab.float().reshape(l, s, nh, d // nh) * scales.float()[..., None]).reshape(l, s, d)


@pytest.mark.parametrize("t,offs", [(11, [7]), (1, [5, 0, 9])], ids=["B1-T11", "B3-T1"])
def test_decode_step_matches_jax_megastep_int8(t, offs):
    nh, out_j, cache_j, out_t, tc = _run_both(t, offs)
    for name in ("hidden", "pre_norm"):
        np.testing.assert_allclose(_np(getattr(out_t, name)),
                                   np.asarray(getattr(out_j, name), np.float32),
                                   rtol=3e-2, atol=3e-2, err_msg=name)
    js = _t(cache_j.self_s)[..., :2 * nh]
    for e, off in enumerate(offs):
        rows = slice(off, off + t)
        for lanes, jslab, tslab in ((slice(0, nh), cache_j.self_k, tc.self_k),
                                    (slice(nh, 2 * nh), cache_j.self_v, tc.self_v)):
            a = _dequant(_t(jslab)[:, e, rows], js[:, e, rows, lanes], nh)
            b = _dequant(tslab[:, e, rows], tc.self_s[:, e, rows, lanes], nh)
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=3e-2, atol=3e-2)
        np.testing.assert_allclose(_np(tc.self_s[:, e, rows]), _np(js[:, e, rows]),
                                   rtol=2.0 ** -7, atol=0)
        # Rows past the history and the chunk keep their initial scale of one.
        assert bool((tc.self_s[:, e, max(offs) + t:] == 1).all())
