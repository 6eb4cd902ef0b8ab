"""K2's scope at the JAX gate's widths: d_model a multiple of 128 and ffn_dim
a multiple of d_model (whisper_medusa_tpu/ops/megastep.py:172-176).

The port's ``decode_step`` on CPU tensors routes a bf16 call that
``megastep.fits`` to K2's plain version (``fused_decoder_layers`` ->
``megastep_plain``), never to the per-op step, and gives the JAX
``decode_step``'s hidden, pre_norm and written K/V rows, the JAX side
through its whole-stack megastep kernel in interpret mode: d_model 128 (2
heads, ffn 512) at B = 2 with offsets that differ and whisper tiny's 384
(6 heads, ffn 1536) at B = 1, T = 11, 2 layers.  Tolerance 3e-2, as
tests/test_torch_megastep.py (bf16 rounding at other places in the two
frameworks).  d_model 320 (5 heads) is off both gates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.config import WhisperDims
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu.ops import megastep as jmegastep
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.ops import megastep as tmegastep

MAX_LEN = 48


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jmegastep, "_INTERPRET", True)
    monkeypatch.setattr(jmegastep, "_ENABLED", True)
    for var in ("WM_MEGASTEP_PREFETCH", "WM_MEGASTEP_PREFETCH_CROSS"):
        monkeypatch.delenv(var, raising=False)


def _dims(d, heads, ffn):
    return WhisperDims(
        vocab_size=256, num_mel_bins=16, d_model=d,
        encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=heads, decoder_attention_heads=heads,
        encoder_ffn_dim=ffn, decoder_ffn_dim=ffn,
        max_source_positions=32, max_target_positions=64)


def _t(a):
    return bridge.params_from_numpy({"x": np.asarray(a)}, device="cpu")["x"]


def _np(t):
    return t.float().numpy()


def _run_both(dims, t, offs, monkeypatch, seed=0):
    b = len(offs)
    rng = np.random.default_rng(seed)
    wp = jw.init_whisper_params(jax.random.PRNGKey(seed), dims, jnp.bfloat16)
    wp["decoder"]["layers"] = jax.tree.map(
        lambda a: a if a.ndim >= 3 else (a + 0.05 * rng.standard_normal(a.shape)).astype(
            jnp.bfloat16), wp["decoder"]["layers"])
    enc = jnp.asarray(rng.standard_normal((b, 32, dims.d_model)), jnp.bfloat16)
    cache = jw.init_cache(wp, dims, enc, MAX_LEN)
    off = max(offs)
    if off:
        pre = jnp.asarray(rng.integers(0, 255, (b, off)), jnp.int32)
        monkeypatch.setattr(jmegastep, "_ENABLED", False)    # history through the scan
        _, cache = jw.decode_step(wp, dims, pre, cache, jnp.zeros((b,), jnp.int32))
        monkeypatch.setattr(jmegastep, "_ENABLED", True)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, wp), device="cpu")
    tcache = tw.KVCache(self_k=_t(cache.self_k)[:, :, :MAX_LEN].contiguous(),
                        self_v=_t(cache.self_v)[:, :, :MAX_LEN].contiguous(),
                        cross_k=_t(cache.cross_k), cross_v=_t(cache.cross_v))
    assert jmegastep.available(wp["decoder"]["layers"], dims.d_model,
                               dims.decoder_attention_heads, b, t, False, 1)
    tokens = rng.integers(0, 255, (b, t)).astype(np.int32)
    offsets = np.asarray(offs, np.int32)
    out_j, cache_j = jw.decode_step(wp, dims, jnp.asarray(tokens), cache, jnp.asarray(offsets))
    routes = {"fused": 0, "ops": 0}
    fused, ops = tmegastep.megastep_plain, tw.decoder_layers_ops

    def count(name, fn):
        def run(*a, **kw):
            routes[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(tmegastep, "megastep_plain", count("fused", fused))
    monkeypatch.setattr(tw, "decoder_layers_ops", count("ops", ops))
    tdims = tconfig.WhisperDims(**dataclasses.asdict(dims))
    out_t = tw.decode_step(tp, tdims, torch.from_numpy(tokens), tcache,
                           torch.from_numpy(offsets))
    assert routes == {"fused": 1, "ops": 0}
    res = dict(hidden=(np.asarray(out_j.hidden, np.float32), _np(out_t.hidden)),
               pre_norm=(np.asarray(out_j.pre_norm, np.float32), _np(out_t.pre_norm)))
    for e, o in enumerate(offs):
        rows = slice(o, o + t)
        res[f"self_k[{e}]"] = (np.asarray(cache_j.self_k[:, e, rows], np.float32),
                               _np(tcache.self_k[:, e, rows]))
        res[f"self_v[{e}]"] = (np.asarray(cache_j.self_v[:, e, rows], np.float32),
                               _np(tcache.self_v[:, e, rows]))
    return res


@pytest.mark.parametrize("d,heads,ffn,t,offs", [(128, 2, 512, 4, [0, 9]),
                                                (384, 6, 1536, 11, [7])])
def test_k2_plain_matches_jax_megastep_at_width(monkeypatch, d, heads, ffn, t, offs):
    for name, (a, b) in _run_both(_dims(d, heads, ffn), t, offs, monkeypatch).items():
        np.testing.assert_allclose(b, a, rtol=3e-2, atol=3e-2, err_msg=name)


@pytest.mark.parametrize("d,heads,ffn,want", [(128, 2, 512, True), (384, 6, 1536, True),
                                              (1280, 20, 5120, True), (320, 5, 1280, False),
                                              (384, 6, 1280, False)])
def test_fits_takes_the_jax_widths(d, heads, ffn, want):
    """``fits`` (the port) and ``available`` (JAX) agree on a width, at bf16,
    B = 8, T = 16."""
    def streamed(zeros, dt):
        w = lambda: zeros((1,), dtype=dt)
        return {"fc1_b": zeros((2, ffn), dtype=dt), "fc1_w": w(), "fc2_w": w(),
                "self": {n: w() for n in ("q_w", "k_w", "v_w", "o_w")},
                "cross": {n: w() for n in ("q_w", "o_w")}}

    x = torch.zeros((8, 16, d), dtype=torch.bfloat16)
    sk = torch.zeros((2, 8, 448, d), dtype=torch.bfloat16)
    ck = torch.zeros((2, 8, heads, 64, 1500), dtype=torch.bfloat16)
    assert tmegastep.fits(streamed(torch.zeros, torch.bfloat16), x, sk, ck, heads) is want
    assert jmegastep.available(streamed(jnp.zeros, jnp.bfloat16), d, heads, 8, 16, False,
                               1) is want
