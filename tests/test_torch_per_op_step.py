"""The per-op decoder step (``models/whisper.py::decoder_layers_ops``) and
the dispatch between it and K2.

``decode_step`` sends a call to ``megastep.fused_decoder_layers`` (K2, its
plain layer loop on CPU tensors) where ``megastep.fits`` it and to the per-op
step elsewhere; the predicate reads only shapes, so the CPU takes the same
route as the card.  At d_model 256 (4 heads of 64, ffn 256, so K2's widths)
the port's ``decode_step`` is held against the JAX scan path at B = 9 (T =
11 and 1) and B = 1, T = 17 (per-op) and at B = 8 (K2's loop), float32 at
1e-4, with a counter on each route.  B = 16 against B = 1 is in
test_torch_b16_invariance.py.
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
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.ops import megastep as tmegastep

MAX_LEN = 48


def _dims():
    return WhisperDims(
        vocab_size=256, num_mel_bins=16, d_model=256,
        encoder_layers=1, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=32, max_target_positions=64)


def _t(a):
    return bridge.params_from_numpy({"x": np.asarray(a)}, device="cpu")["x"]


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


def _run_both(b, t, off, seed=0):
    """One decode step of T tokens at offsets ``off + e`` through both
    packages, each cache holding its committed history; (JAX, port) pairs
    of hidden, pre_norm and the rows the step wrote."""
    dims = _dims()
    rng = np.random.default_rng(seed)
    wp = jw.init_whisper_params(jax.random.PRNGKey(seed), dims, jnp.float32)
    wp["decoder"]["layers"] = jax.tree.map(
        lambda a: a if a.ndim >= 3 else a + 0.05 * rng.standard_normal(a.shape),
        wp["decoder"]["layers"])
    enc = jnp.asarray(rng.standard_normal((b, 32, dims.d_model)), jnp.float32)
    cache = jw.init_cache(wp, dims, enc, MAX_LEN)
    offs = np.asarray([off + e % 3 for e in range(b)], np.int32)
    hist = jnp.asarray(rng.integers(0, 255, (b, int(offs.max()))), jnp.int32)
    _, cache = jw.decode_step(wp, dims, hist, cache, jnp.zeros((b,), jnp.int32))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, wp), device="cpu")
    tcache = tw.KVCache(self_k=_t(cache.self_k)[:, :, :MAX_LEN].contiguous(),
                        self_v=_t(cache.self_v)[:, :, :MAX_LEN].contiguous(),
                        cross_k=_t(cache.cross_k), cross_v=_t(cache.cross_v))
    tokens = rng.integers(0, 255, (b, t)).astype(np.int32)
    out_j, cache_j = jw.decode_step(wp, dims, jnp.asarray(tokens), cache, jnp.asarray(offs))
    out_t = tw.decode_step(tp, tconfig.WhisperDims(**dataclasses.asdict(dims)),
                           torch.from_numpy(tokens), tcache, torch.from_numpy(offs))
    pairs = {"hidden": (out_j.hidden, out_t.hidden),
             "pre_norm": (out_j.pre_norm, out_t.pre_norm)}
    for e, o in enumerate(offs):
        rows = slice(int(o), int(o) + t)
        pairs[f"self_k[{e}]"] = (cache_j.self_k[:, e, rows], tcache.self_k[:, e, rows])
        pairs[f"self_v[{e}]"] = (cache_j.self_v[:, e, rows], tcache.self_v[:, e, rows])
    return {k: (np.asarray(a, np.float32), c.numpy()) for k, (a, c) in pairs.items()}


# f32 weights (the JAX package's default) take the per-op step at every B, as
# JAX's gate sends them to its scan: B = 8 included.
@pytest.mark.parametrize("b,t,route", [(9, 11, "ops"), (9, 1, "ops"), (1, 17, "ops"),
                                       (8, 11, "ops")])
def test_decode_step_routes_and_matches_jax_scan(routes, b, t, route):
    for name, (a, c) in _run_both(b, t, off=5).items():
        # f32, the JAX lax.scan path on both sides of the dispatch: 1e-4.
        np.testing.assert_allclose(c, a, rtol=1e-4, atol=1e-4, err_msg=name)
    assert routes == {"fused": int(route == "fused"), "ops": int(route == "ops")}


def _streamed(layers, dtype=torch.bfloat16):
    """``layers`` with K2's streamed weights added in ``dtype`` (``fits``
    reads their dtype; one element each stands for the weight)."""
    w = lambda: torch.zeros(1, dtype=dtype)
    return {**layers, "self": {k: w() for k in ("q_w", "k_w", "v_w", "o_w")},
            "cross": {k: w() for k in ("q_w", "o_w")}, "fc1_w": w(), "fc2_w": w()}


def test_fits_is_k2_scope():
    layers = _streamed({"fc1_b": torch.zeros((2, 5120))})
    ck = torch.zeros((2, 1, 20, 64, 1500))
    sk = torch.zeros((2, 1, 460, 1280))
    x = lambda b, t, d=1280: torch.zeros((b, t, d))
    assert tmegastep.fits(layers, x(8, 11), sk, ck, 20)
    assert tmegastep.fits(layers, x(1, 16), sk, ck, 20)
    assert not tmegastep.fits(layers, x(9, 11), sk, ck, 20)         # B > 8
    assert not tmegastep.fits(layers, x(1, 17), sk, ck, 20)         # T > 16
    tiny = _streamed({"fc1_b": torch.zeros((4, 1536))})
    assert tmegastep.fits(tiny, x(8, 11, 384), sk, ck, 6)           # tiny: D % 128
    assert not tmegastep.fits(_streamed({"fc1_b": torch.zeros((2, 1280))}),
                              x(1, 1, 320), sk, ck, 5)              # D % 128
    assert not tmegastep.fits(layers, x(1, 1), sk, ck, 10)          # heads of 128
    # A self slab past the attention's cluster split (8 CTAs of 384 keys).
    assert not tmegastep.fits(layers, x(1, 1), torch.zeros((2, 1, 3088, 1280)), ck, 20)
