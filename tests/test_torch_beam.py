"""Beam search of the port (decoding/beam.py) vs the JAX package's, and the
beam-folded decoder step.

tiny_test_config() (vocab 256, d_model 32), float32 on the CPU, the JAX
weights bridged into the port and both searches fed the same encoder rows.
K = 2 and 3, B = 1 and 2, length_penalty 0, 1 and 2, with and without an
EOS-raising ``custom`` hook (written once in jnp and once in torch) that
makes hypotheses finish at several lengths: tokens, lengths, steps and the
n-best tokens and lengths are equal, scores within 1e-4.  On constant logits
(every finished and alive score tied) the n-best set equals JAX's, and the
port's top-k helper orders ties as ``lax.top_k`` does.  Beam width 1 with
length_penalty 0 is greedy decoding; the cache holds B cross rows and B * K
self rows, and the folded step equals the step on cross K/V repeated K times
(at tiny width, and at the per-op step's widths in f32 and int8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.config import GenerationConfig, WhisperDims, tiny_test_config
from whisper_medusa_tpu.decoding.beam import beam_search as jbeam
from whisper_medusa_tpu.decoding.processors import ProcessorConfig as JProc
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu_torch import config as tconfig
from whisper_medusa_tpu_torch.decoding import beam as tbeam
from whisper_medusa_tpu_torch.decoding.buffers import generate_medusa_buffers
from whisper_medusa_tpu_torch.decoding.processors import ProcessorConfig as TProc
from whisper_medusa_tpu_torch.decoding.speculative import speculative_generate
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.ops import megastep as tmegastep
from whisper_medusa_tpu_torch.ops import qmm as tqmm

EOS = PAD = 5
MAX_LEN = 32


def _tdims(dims):
    return tconfig.WhisperDims(**{f: getattr(dims, f) for f in dims.__dataclass_fields__})


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    params = jw.init_whisper_params(jax.random.PRNGKey(0), cfg.dims)
    rng = np.random.default_rng(0)
    mel = jnp.asarray(rng.normal(size=(2, cfg.dims.num_mel_bins, cfg.dims.num_frames)),
                      jnp.float32)
    enc = jw.encode(params, cfg.dims, mel)
    prompt = np.tile(rng.integers(6, 250, (1, 3)), (2, 1)).astype(np.int32)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, tparams, enc, prompt


def _eos_hook_jax(logits, pred_pos):
    return logits.at[..., EOS].add(0.2 * (pred_pos - 8).astype(jnp.float32))


def _eos_hook_torch(logits, pred_pos):
    out = logits.clone()
    out[..., EOS] += 0.2 * (pred_pos - 8).float()
    return out


def _configs(hook):
    kw = dict(vocab_size=256, begin_index=3, eos_token_id=EOS)
    gkw = dict(max_length=MAX_LEN, eos_token_id=EOS, pad_token_id=PAD, suppress_tokens=None,
               begin_suppress_tokens=None)
    return (JProc(**kw, custom=_eos_hook_jax if hook else None), GenerationConfig(**gkw),
            TProc(**kw, custom=_eos_hook_torch if hook else None),
            tconfig.GenerationConfig(**gkw))


def _both(setup, k, b, lp, hook):
    cfg, params, tparams, enc, prompt = setup
    jp, jg, tp, tg = _configs(hook)
    a = jbeam(params, cfg.dims, jp, jg, enc[:b], jnp.asarray(prompt[:b]), num_beams=k,
              length_penalty=lp)
    c = tbeam.beam_search(tparams, _tdims(cfg.dims), tp, tg, _t(enc[:b]), _t(prompt[:b]),
                          num_beams=k, length_penalty=lp)
    return a, c


def _assert_beams_equal(a, c):
    np.testing.assert_array_equal(c.tokens.numpy(), np.asarray(a.tokens))
    np.testing.assert_array_equal(c.lengths.numpy(), np.asarray(a.lengths))
    assert c.steps == int(a.steps)
    np.testing.assert_allclose(c.scores.numpy(), np.asarray(a.scores), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(c.nbest_tokens.numpy(), np.asarray(a.nbest_tokens))
    np.testing.assert_array_equal(c.nbest_lengths.numpy(), np.asarray(a.nbest_lengths))
    np.testing.assert_allclose(c.nbest_scores.numpy(), np.asarray(a.nbest_scores), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("k,b,lp,hook", [
    (2, 1, 0.0, True), (3, 2, 1.0, True), (2, 2, 2.0, True), (3, 1, 1.0, False),
    (3, 2, 2.0, False)], ids=["K2-B1-lp0-hook", "K3-B2-lp1-hook", "K2-B2-lp2-hook",
                              "K3-B1-lp1", "K3-B2-lp2"])
def test_beam_search_matches_jax(setup, k, b, lp, hook):
    a, c = _both(setup, k, b, lp, hook)
    _assert_beams_equal(a, c)
    if hook:       # the hook makes hypotheses finish: the n-best set is real
        assert (c.nbest_scores > tbeam.NEG / 2).all()


@pytest.mark.parametrize("lp", [0.0, 10.0])
def test_nbest_on_tied_scores_matches_jax(setup, monkeypatch, lp):
    """Constant logits with p(EOS) == p(A): every alive continuation and
    every finished hypothesis of one length ties, so the n-best set is
    decided by tie order alone (and by the penalty across lengths)."""
    cfg, params, tparams, enc, prompt = setup
    v = cfg.dims.vocab_size
    row = np.zeros((v,), np.float32)
    row[[EOS, 10]] = 2.0
    monkeypatch.setattr(jw, "project_logits", lambda p, h: jnp.broadcast_to(
        jnp.asarray(row), (h.shape[0], v)))
    monkeypatch.setattr(tw, "project_logits", lambda p, h: torch.from_numpy(row).expand(
        h.shape[0], v).clone())
    a, c = _both(setup, 4, 2, lp, False)
    _assert_beams_equal(a, c)
    s = c.nbest_scores.numpy()
    assert (np.diff(s, axis=1) <= 1e-6).all()


def test_top_k_ties_match_lax_top_k():
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 3, size=(4, 300)).astype(np.float32)
    x[:, ::7] = -1e9
    x[1, :50] = -np.inf
    for k in (1, 4, 10, 64):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tbeam.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_beam1_penalty0_equals_greedy(setup):
    cfg, _, tparams, enc, prompt = setup
    _, _, tp, tg = _configs(False)
    dims = _tdims(cfg.dims)
    beam = tbeam.beam_search(tparams, dims, tp, tg, _t(enc), _t(prompt), num_beams=1,
                             length_penalty=0.0)
    greedy = speculative_generate(tparams, None, dims, generate_medusa_buffers([1]), tp, tg,
                                  _t(enc), _t(prompt), variant="vanilla")
    for i in range(2):
        n = int(min(beam.lengths[i], greedy.lengths[i]))
        torch.testing.assert_close(beam.tokens[i, :n], greedy.tokens[i, :n], rtol=0, atol=0)


def test_cross_kv_deduped_across_beams(setup):
    """Cross K/V live once per example (B rows), the self slabs per beam
    (B * K rows); the folded step equals the step on cross K/V repeated K
    times and the JAX package's folded step."""
    cfg, params, tparams, enc, _ = setup
    dims = _tdims(cfg.dims)
    b, k = 2, 4
    rng = np.random.default_rng(0)
    toks = rng.integers(6, 60, size=(b * k, 3)).astype(np.int32)
    cache = tw.init_cache(tparams, dims, _t(enc), 16, self_batch=b * k)
    assert cache.cross_k.shape[1] == b and cache.cross_v.shape[1] == b
    assert cache.self_k.shape[1] == b * k and cache.self_v.shape[1] == b * k
    off = torch.zeros((b * k,), dtype=torch.int32)
    fold = tw.decode_step(tparams, dims, _t(toks), cache, off, cross_beam=k)
    rep_cache = tw.init_cache(tparams, dims, _t(enc).repeat_interleave(k, 0), 16)
    rep = tw.decode_step(tparams, dims, _t(toks), rep_cache, off)
    torch.testing.assert_close(fold.hidden, rep.hidden, rtol=0, atol=1e-5)
    torch.testing.assert_close(cache.self_k, rep_cache.self_k, rtol=0, atol=1e-5)
    jcache = jw.init_cache(params, cfg.dims, enc, 16, self_batch=b * k)
    jout, _ = jw.decode_step(params, cfg.dims, jnp.asarray(toks), jcache,
                             jnp.zeros((b * k,), jnp.int32), cross_beam=k)
    np.testing.assert_allclose(fold.hidden.numpy(), np.asarray(jout.hidden), rtol=0, atol=1e-4)


def _wide_dims():
    """The per-op step's widths (heads of 64, d_model and ffn multiples of
    256, the widths K2 would take without beams)."""
    return tconfig.WhisperDims(vocab_size=256, num_mel_bins=16, d_model=256, encoder_layers=1,
                               decoder_layers=2, encoder_attention_heads=4,
                               decoder_attention_heads=4, encoder_ffn_dim=256,
                               decoder_ffn_dim=256, max_source_positions=32,
                               max_target_positions=64)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("t", [1, 6])
def test_folded_per_op_step_equals_repeated_plain_step(monkeypatch, int8, t):
    """At K2's widths a beam call still takes the per-op step (megastep.fits
    refuses cross_beam != 1); its folded step equals the per-op step on
    cross K/V repeated K times (B * K = 9 rows, past K2's batch) on the same
    rows, per-example int8 scales included, over a prefill of T tokens and
    then one token."""
    dims = _wide_dims()
    jdims = WhisperDims(**{f: getattr(dims, f) for f in dims.__dataclass_fields__})
    params = bridge.params_from_numpy(jax.tree.map(
        np.asarray, jw.init_whisper_params(jax.random.PRNGKey(1), jdims)), device="cpu")
    if int8:
        params, _ = tqmm.quantize_decoder(params)
    b, k = 3, 3
    rng = np.random.default_rng(4)
    enc = torch.from_numpy(rng.standard_normal((b, 32, 256)).astype(np.float32))
    calls = {"fused": 0}
    real = tmegastep.fused_decoder_layers

    def fused(*a, **kw):
        calls["fused"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tmegastep, "fused_decoder_layers", fused)
    cache = tw.init_cache(params, dims, enc, 24, self_batch=b * k)
    rep_cache = tw.init_cache(params, dims, enc.repeat_interleave(k, 0), 24)
    if int8:
        assert cache.cross_k_s.shape[1] == b and cache.self_s.shape[1] == b * k
    toks = torch.from_numpy(rng.integers(6, 200, size=(b * k, t)).astype(np.int32))
    nxt = torch.from_numpy(rng.integers(6, 200, size=(b * k, 1)).astype(np.int32))
    zero, at_t = (torch.full((b * k,), o, dtype=torch.int32) for o in (0, t))
    for chunk, off in ((toks, zero), (nxt, at_t)):
        fold = tw.decode_step(params, dims, chunk, cache, off, cross_beam=k)
        rep = tw.decode_step(params, dims, chunk, rep_cache, off)
        torch.testing.assert_close(fold.hidden, rep.hidden, rtol=0, atol=1e-5)
    assert calls["fused"] == 0
    torch.testing.assert_close(cache.self_k.float(), rep_cache.self_k.float(), rtol=0,
                               atol=1e-5)
