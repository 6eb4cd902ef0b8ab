"""K2's W8A32 mode (the int8 copy of an f32 model): the port's plain
version (ops/megastep.py ``w8a32_layer_step``) vs the JAX whole-stack
megastep kernel in interpret mode, its route on a TPU.

The dims of test_torch_megastep.py (d=128, 2 layers, 2 heads of 64), an f32
tree quantized by the JAX ``quantize_decoder`` (int8 streamed weights beside
f32 norms and biases), f32 activations, int8 self slabs with bf16 scales
and int8 cross K/V.  K2 takes d_model % 256 == 0 on the card, so the port's
``decode_step`` is sent to the K2 route by patching ``megastep.fits``; on
the CPU that route is the plain version.  Cases: B=1 T=11 at offset 7, B=3
T=4 at offsets that differ; the block mode is in test_torch_w8a32_block.py.

Tolerances: hidden and pre_norm within 1e-5 (rtol and atol;
both sides compute in f32 and differ in the order of their sums and in the
JAX kernel's A&S erf).  The self rows each step wrote: int8 values within
one step (a row's value may round to the neighbouring step) and their bf16
scales within one bf16 ulp (2**-7 relative).  Measured: 8.3e-7 in hidden
(max |hidden| 2.9); the plain version before this mode (bf16 activations
into ``qmm``, the JAX scan's arithmetic) misses it by 5.6e-3 and 6.2e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_int8_decode import _port_cache, _quantized
from tests.test_torch_megastep import MAX_LEN, _np, _t
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu.ops import megastep as jmegastep
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.ops import megastep as tmegastep

TOL = 1e-5


@pytest.fixture(autouse=True)
def k2_route(monkeypatch):
    monkeypatch.setattr(jmegastep, "_INTERPRET", True)
    monkeypatch.setattr(jmegastep, "_ENABLED", True)
    for var in ("WM_MEGASTEP_PREFETCH", "WM_MEGASTEP_PREFETCH_CROSS", "WM_MEGASTEP_MAX_B",
                "WM_MEGASTEP_W8A8", "WM_INT8_SELF_KV"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tmegastep, "fits", lambda *a, **k: True)


def _scan_history(wp, dims, cache, b, off, rng, **kw):
    """``off`` committed rows per example through the JAX scan path."""
    pre = jnp.asarray(rng.integers(0, 255, (b, off)), jnp.int32)
    enabled, jmegastep._ENABLED = jmegastep._ENABLED, False
    try:
        _, cache = jw.decode_step(wp, dims, pre, cache, jnp.zeros((b,), jnp.int32), **kw)
    finally:
        jmegastep._ENABLED = enabled
    return cache


def _check_rows(cache_j, tc, nh, offs, t, slots):
    """The int8 rows and bf16 scales each example's step wrote, in every
    slot: values within one int8 step, scales within one bf16 ulp."""
    js = _t(cache_j.self_s)[..., :2 * nh]
    for e, off in enumerate(offs):
        rows = slice(off, off + t)
        for jslab, tslab in ((cache_j.self_k, tc.self_k), (cache_j.self_v, tc.self_v)):
            a = _t(jslab)[slots, e, rows].int()
            b = tslab[slots, e, rows].int()
            assert int((a - b).abs().max()) <= 1
        np.testing.assert_allclose(_np(tc.self_s[slots, e, rows]), _np(js[slots, e, rows]),
                                   rtol=2.0 ** -7, atol=0)


def _port_step(tq, dims, tokens, tcache, offsets, **kw):
    n = tmegastep.w8a32_launches
    out = tw.decode_step(tq, tconfig.WhisperDims(**dataclasses.asdict(dims)),
                         torch.from_numpy(tokens), tcache, torch.from_numpy(offsets), **kw)
    assert tmegastep.w8a32_launches == n            # the CPU runs the plain version
    return out


@pytest.mark.parametrize("t,offs", [(11, [7]), (4, [5, 0, 9])], ids=["B1-T11", "B3-T4"])
def test_w8a32_step_matches_jax_megastep(t, offs):
    b = len(offs)
    dims, wq, tq, rng = _quantized(jnp.float32, 3)
    nh = dims.decoder_attention_heads
    enc = jnp.asarray(rng.standard_normal((b, 32, dims.d_model)), jnp.float32)
    cache = jw.init_cache(wq, dims, enc, MAX_LEN)
    cache = _scan_history(wq, dims, cache, b, max(offs), rng)
    tcache = _port_cache(cache, nh)
    tokens = rng.integers(0, 255, (b, t)).astype(np.int32)
    offsets = np.asarray(offs, np.int32)
    assert jmegastep.available(wq["decoder"]["layers"], dims.d_model, nh, b, t, False, 1)
    out_j, cache_j = jw.decode_step(wq, dims, jnp.asarray(tokens), cache, jnp.asarray(offsets))
    out_t = _port_step(tq, dims, tokens, tcache, offsets)
    for name in ("hidden", "pre_norm"):
        assert getattr(out_t, name).dtype == torch.float32
        np.testing.assert_allclose(_np(getattr(out_t, name)),
                                   np.asarray(getattr(out_j, name), np.float32),
                                   rtol=TOL, atol=TOL, err_msg=name)
    _check_rows(cache_j, tcache, nh, offs, t, slice(None))
