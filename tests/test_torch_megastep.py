"""Port decode_step (ops/megastep.py plain path) vs the JAX decode_step.

bf16: the JAX whole-stack megastep kernel in interpret mode, at the dims of
tests/test_megastep.py (d=128, 2 layers, 2 heads of 64), tolerance 3e-2 as
there.  f32: the JAX lax.scan path, tolerance 1e-4.  B = 1 here; B in {2, 8}
with per-example offsets that differ in test_torch_megastep_batch.py.  The
JAX cache carries +16 rows of TPU slack; the port's slabs are cut to the
requested length and only the rows written by the step (and each example's
history) are compared.
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


def _dims():
    return WhisperDims(
        vocab_size=256, num_mel_bins=16, d_model=128,
        encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=256, decoder_ffn_dim=512,
        max_source_positions=32, max_target_positions=64)


def _setup(dtype, off, seed=0, b=1):
    """JAX params + a JAX cache holding ``off`` committed rows per example,
    and the same state bridged into the port."""
    dims = _dims()
    rng = np.random.default_rng(seed)
    wp = jw.init_whisper_params(jax.random.PRNGKey(seed), dims, dtype)
    # Nonzero biases / layernorms, distinct per layer.
    wp["decoder"]["layers"] = jax.tree.map(
        lambda a: a if a.ndim >= 3 else (a + 0.05 * rng.standard_normal(a.shape)).astype(dtype),
        wp["decoder"]["layers"])
    enc = jnp.asarray(rng.standard_normal((b, 32, dims.d_model)), dtype)
    cache = jw.init_cache(wp, dims, enc, MAX_LEN)
    if off:
        # History rows through the scan path: only the step under test needs
        # the (slow to interpret) megastep kernel.
        pre = jnp.asarray(rng.integers(0, 255, (b, off)), jnp.int32)
        enabled, jmegastep._ENABLED = jmegastep._ENABLED, False
        try:
            _, cache = jw.decode_step(wp, dims, pre, cache, jnp.zeros((b,), jnp.int32))
        finally:
            jmegastep._ENABLED = enabled
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, wp), device="cpu")
    tcache = tw.KVCache(
        self_k=_t(cache.self_k)[:, :, :MAX_LEN].contiguous(),
        self_v=_t(cache.self_v)[:, :, :MAX_LEN].contiguous(),
        cross_k=_t(cache.cross_k), cross_v=_t(cache.cross_v))
    return dims, wp, cache, tp, tcache, rng


def _t(a):
    return bridge.params_from_numpy({"x": np.asarray(a)}, device="cpu")["x"]


def _np(t):
    return t.float().numpy()


def _run_both(dtype, t, offs):
    """One decode step of T tokens at per-example offsets ``offs`` (the cache
    holds max(offs) committed rows) through both packages."""
    b = len(offs)
    dims, wp, cache, tp, tcache, rng = _setup(dtype, max(offs), b=b)
    tokens = rng.integers(0, 255, (b, t)).astype(np.int32)
    offsets = np.asarray(offs, np.int32)
    out_j, cache_j = jw.decode_step(wp, dims, jnp.asarray(tokens), cache,
                                    jnp.asarray(offsets))
    tdims = tconfig.WhisperDims(**dataclasses.asdict(dims))
    out_t = tw.decode_step(tp, tdims, torch.from_numpy(tokens), tcache,
                           torch.from_numpy(offsets))
    res = dict(
        hidden=(np.asarray(out_j.hidden, np.float32), _np(out_t.hidden)),
        pre_norm=(np.asarray(out_j.pre_norm, np.float32), _np(out_t.pre_norm)))
    for e, off in enumerate(offs):
        rows = slice(off, off + t)
        res.update({
            f"self_k[{e}]": (np.asarray(cache_j.self_k[:, e, rows], np.float32),
                             _np(tcache.self_k[:, e, rows])),
            f"self_v[{e}]": (np.asarray(cache_j.self_v[:, e, rows], np.float32),
                             _np(tcache.self_v[:, e, rows])),
            f"history[{e}]": (np.asarray(cache_j.self_k[:, e, :off], np.float32),
                              _np(tcache.self_k[:, e, :off]))})
    return res


@pytest.mark.parametrize("t", [4, 11])
@pytest.mark.parametrize("off", [0, 7])
def test_decode_step_matches_jax_megastep_bf16(t, off):
    assert jmegastep.available(
        jw.init_whisper_params(jax.random.PRNGKey(0), _dims(), jnp.bfloat16)
        ["decoder"]["layers"], 128, 2, 1, t, False, 1)
    for name, (a, b) in _run_both(jnp.bfloat16, t, [off]).items():
        np.testing.assert_allclose(b, a, rtol=3e-2, atol=3e-2, err_msg=name)


@pytest.mark.parametrize("t,off", [(4, 0), (11, 7)])
def test_decode_step_matches_jax_scan_f32(t, off):
    for name, (a, b) in _run_both(jnp.float32, t, [off]).items():
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4, err_msg=name)


def test_plain_layer_loop_is_the_cpu_route():
    """On CPU tensors fused_decoder_layers is the decoder_layer_step loop and
    writes exactly rows [off, off + T) of every layer's slabs."""
    dims, _, _, tp, tcache, rng = _setup(jnp.float32, 5)
    before = tcache.self_k.clone()
    x = torch.from_numpy(rng.standard_normal((1, 3, 128)).astype(np.float32))
    off = torch.tensor([5], dtype=torch.int32)
    args = (tp["decoder"]["layers"], tp["decoder"]["ln_post"], x, tcache.self_k,
            tcache.self_v, tcache.cross_k, tcache.cross_v, off, None, 32, 2)
    got = tmegastep.fused_decoder_layers(*args)
    changed = (tcache.self_k != before).any(dim=-1)[:, 0]      # (L, S)
    assert changed[:, 5:8].all() and not changed[:, :5].any() and not changed[:, 8:].any()
    tcache.self_k.copy_(before)
    ref = tmegastep.megastep_plain(*args)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert tmegastep.launches == 0
