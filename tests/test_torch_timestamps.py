"""The timestamp rules of the port: decoding/processors.py's
``apply_timestamp_rules`` and the timestamp mode (``ts_cfg``) of the plain
versions of kernels K4 (``verify_hidden``) and K5 (``verify_rows``).

``apply_timestamp_rules`` against the JAX function on rows that hit every
branch (fresh start, after text, after one timestamp, after two, a running
max, the initial cap, forced and unforced sum rule), f32 within 1e-6.  The
plain ts modes against the JAX kernels in interpret mode at V = 8192 + 665
with ``ts_begin`` = 8556 (not a multiple of 64: one vocab tile straddles
it), ``n_verif`` < R (the draft rows untouched), bf16 and int8 embeddings,
int8 heads and identity0 rows for ``verify_hidden``: argmax exact, max /
lse / gathered within the tolerances of test_torch_verify.py (1e-4 for
rows given in f32, 3e-2 for rows built in bf16).  The same rows against
the unfused JAX pipeline (apply_processors + apply_timestamp_rules), as the
JAX package's tests/test_verify_kernel.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.decoding import processors as jproc
from whisper_medusa_tpu.ops import qmm as jqmm
from whisper_medusa_tpu.ops import verify as jverify
from whisper_medusa_tpu_torch.decoding import processors as tproc
from whisper_medusa_tpu_torch.ops import verify as tverify

V = 8192 + 665
TS_BEGIN = 8556          # 8556 % 64 = 44: tile 133 holds both sides
NO_TS = TS_BEGIN - 1
EOS = 5
BEGIN = 4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jverify, "_INTERPRET", True)
    monkeypatch.setattr(jverify, "_ENABLED", True)


def _pcfg(cls, cap=20):
    return cls.ProcessorConfig(
        vocab_size=V, suppress_tokens=(3, 10, V - 2), begin_suppress_tokens=(1, 2),
        begin_index=BEGIN, exponential_decay_length_penalty=(6, 1.2), eos_token_id=EOS,
        timestamp_rules=True, timestamp_begin=TS_BEGIN, no_timestamps_id=NO_TS,
        max_initial_timestamp_index=cap)


def _history(r):
    """Per-row (pos, last, penult, maxts) cycling through every rule branch:
    fresh start (the cap), after text, after one timestamp, after two, a
    running max with text last, a running max after a lone timestamp."""
    base = [(BEGIN, 50, 40, 0), (BEGIN + 3, 42, 17, 0),
            (BEGIN + 4, TS_BEGIN + 3, 55, TS_BEGIN + 3),
            (BEGIN + 5, TS_BEGIN + 9, TS_BEGIN + 7, TS_BEGIN + 9),
            (BEGIN + 6, 99, TS_BEGIN + 60, TS_BEGIN + 60),
            (BEGIN + 7, TS_BEGIN + 200, 31, TS_BEGIN + 200),
            (BEGIN + 1, TS_BEGIN + 2, 7, TS_BEGIN + 2)]
    rows = [base[i % len(base)] for i in range(r)]
    return [np.asarray(c, np.int32) for c in zip(*rows)]


def _rows(r, seed, scale_lo=0.2, scale_hi=3.0):
    """Hidden rows whose norms spread from scale_lo to scale_hi, so some rows'
    timestamp mass beats their best text logit (forced) and some not."""
    rng = np.random.default_rng(seed)
    hs = rng.standard_normal((r, 128)).astype(np.float32)
    return hs * np.linspace(scale_lo, scale_hi, r, dtype=np.float32)[:, None]


def _q(w, axis):
    """The JAX-quantized weight as the JAX dict and the port's."""
    q, sc = jqmm.quantize_array(jnp.asarray(w), axis=axis)
    return ({"q": q, "s": sc},
            {"q": torch.from_numpy(np.array(q)), "s": torch.from_numpy(np.array(sc))})


def _forced(logits, pos, last, penult, maxts, pcfg):
    """Rows the sum rule forces, from the unfused JAX pipeline."""
    proc = jproc.apply_processors(jnp.asarray(logits), jnp.asarray(pos), pcfg)
    out = jproc.apply_timestamp_rules(proc, jnp.asarray(pos), jnp.asarray(last),
                                      jnp.asarray(penult), jnp.asarray(maxts), pcfg)
    return np.asarray(jnp.isinf(out[:, :TS_BEGIN]).all(-1))


def test_apply_timestamp_rules_matches_jax():
    r = 28
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((r, V)) * np.linspace(0.2, 3.0, r)[:, None]).astype(
        np.float32)
    pos, last, penult, maxts = _history(r)
    jcfg, tcfg = _pcfg(jproc), _pcfg(tproc)
    jp = jproc.apply_processors(jnp.asarray(logits), jnp.asarray(pos), jcfg)
    ref = np.asarray(jproc.apply_timestamp_rules(jp, jnp.asarray(pos), jnp.asarray(last),
                                                 jnp.asarray(penult), jnp.asarray(maxts),
                                                 jcfg))
    tp = tproc.apply_processors(torch.from_numpy(logits), torch.from_numpy(pos), tcfg)
    got = tproc.apply_timestamp_rules(tp, torch.from_numpy(pos), torch.from_numpy(last),
                                      torch.from_numpy(penult), torch.from_numpy(maxts),
                                      tcfg).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-6)
    forced = np.isinf(ref[:, :TS_BEGIN]).all(-1)
    assert forced.any() and not forced.all()
    # Every branch barred something: the cap, pairing both ways, the floor.
    assert np.isinf(ref[0, TS_BEGIN + 21:]).all() and np.isfinite(ref[0, TS_BEGIN + 20])
    assert np.isinf(ref[3, TS_BEGIN:]).all()
    assert np.isinf(ref[2, :EOS]).all()
    assert np.isinf(ref[4, TS_BEGIN:TS_BEGIN + 61]).all()


def _check(got, ref, tol):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for name, a, b in zip(("max", "lse", "gathered"), got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r,n_verif", [(14, 14), (40, 28)])
def test_verify_rows_ts_matches_jax_kernel(quant, r, n_verif):
    rng = np.random.default_rng(r + 7 * quant)
    hs = _rows(r, r)
    emb = (rng.standard_normal((V, 128)) * 0.2).astype(np.float32)
    pos, last, penult, maxts = _history(r)
    gcol = rng.integers(0, V, (r,)).astype(np.int32)
    gcol[:6] = (EOS, 3, TS_BEGIN + 4, 17, NO_TS, V - 1)
    jcfg = _pcfg(jproc)
    kw = dict(begin_index=BEGIN, eos_id=EOS, decay=(6, 1.2), n_verif=n_verif)
    if quant:
        jemb, temb = _q(emb, 1)
        jhs, ths = jnp.asarray(hs, jnp.bfloat16), torch.from_numpy(hs).bfloat16()
    else:
        jemb, temb = jnp.asarray(emb), torch.from_numpy(emb)
        jhs, ths = jnp.asarray(hs), torch.from_numpy(hs)
    j = lambda a: jnp.asarray(a)
    ref = jverify.verify_rows(jhs, jemb, j(pos), j(gcol), jverify.masks_for(jcfg),
                              ts_cfg=jverify.ts_cfg_for(jcfg), last=j(last),
                              penult=j(penult), maxts=j(maxts), **kw)
    t = torch.from_numpy
    tcfg = _pcfg(tproc)
    got = tverify.verify_rows(ths, temb, t(pos), t(gcol), tverify.masks_for(tcfg),
                              ts_cfg=tverify.ts_cfg_for(tcfg), last=t(last), penult=t(penult),
                              maxts=t(maxts), **kw)
    assert tverify.ts_rows_launches == tverify.q_ts_rows_launches == 0
    _check(got, ref, 3e-2 if quant else 1e-4)
    # Rows past n_verif are the non-ts statistics, untouched by the rules.
    plain = tverify.verify_rows(ths, temb, t(pos), t(gcol), tverify.masks_for(tcfg),
                                begin_index=BEGIN, eos_id=EOS, decay=(6, 1.2))
    for a, b in zip(got, plain):
        torch.testing.assert_close(a[n_verif:], b[n_verif:], rtol=0, atol=0)
    logits = tverify.row_logits(ths, temb).numpy()
    forced = _forced(logits[:n_verif], pos[:n_verif], last[:n_verif], penult[:n_verif],
                     maxts[:n_verif], jcfg)
    assert forced.any() and not forced.all()


def _heads(rng, nh, d, quant):
    hw = (rng.standard_normal((nh, d, d)) * 0.05).astype(np.float32)
    hb = (rng.standard_normal((nh, d)) * 0.1).astype(np.float32)
    if not quant:
        return (jnp.asarray(hw, jnp.bfloat16), torch.from_numpy(hw).bfloat16(),
                jnp.asarray(hb), torch.from_numpy(hb))
    jq, tq = _q(hw, 1)
    return jq, tq, jnp.asarray(hb), torch.from_numpy(hb)


@pytest.mark.parametrize("identity0", [False, True], ids=["base_head", "identity0"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_verify_hidden_ts_matches_jax_kernel(quant, identity0):
    d, n, nh = 128, 4, 3
    rng = np.random.default_rng(11 + quant + 2 * identity0)
    hid = _rows(n, 5, 0.5, 2.5)[None]
    src = _rows(n, 6, 0.5, 2.5)[None] if identity0 else hid
    emb = (rng.standard_normal((V, d)) * 0.2).astype(np.float32)
    jhw, thw, jhb, thb = _heads(rng, nh, d, quant)
    kp1 = nh + int(identity0)
    r = kp1 * n
    pos = (BEGIN + np.arange(n)[None, :] + np.arange(kp1)[:, None]).reshape(-1).astype(np.int32)
    _, last, penult, maxts = _history(r)
    gcol = rng.integers(0, V, (r,)).astype(np.int32)
    gcol[:4] = (EOS, TS_BEGIN + 9, 17, NO_TS)
    jcfg = _pcfg(jproc)
    kw = dict(identity0=identity0, begin_index=BEGIN, eos_id=EOS, decay=(6, 1.2), n_verif=n)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    if quant:
        jemb, temb = _q(emb, 1)
    else:
        jemb, temb = bf(emb), torch.from_numpy(emb).bfloat16()
    j = lambda a: jnp.asarray(a)
    ref = jverify.verify_hidden(bf(hid), bf(src), jhw, jhb, jemb, j(pos), j(gcol),
                                jverify.masks_for(jcfg), ts_cfg=jverify.ts_cfg_for(jcfg),
                                last=j(last), penult=j(penult), maxts=j(maxts), **kw)
    t = torch.from_numpy
    tcfg = _pcfg(tproc)
    tb = lambda a: t(a).bfloat16()
    got = tverify.verify_hidden(tb(hid), tb(src), thw, thb, temb, t(pos), t(gcol),
                                tverify.masks_for(tcfg), ts_cfg=tverify.ts_cfg_for(tcfg),
                                last=t(last), penult=t(penult), maxts=t(maxts), **kw)
    assert tverify.ts_launches == tverify.q_ts_launches == 0
    _check(got, ref, 3e-2)


@pytest.mark.parametrize("cap", [20, None])
def test_ts_rows_match_unfused_pipeline(cap):
    """The plain ts mode == apply_processors + apply_timestamp_rules on the
    materialized logits (then argmax / max / logsumexp / gather), rows past
    n_verif with the base processors only."""
    r, n_verif = 21, 14
    rng = np.random.default_rng(3)
    hs = _rows(r, 8)
    emb = (rng.standard_normal((V, 128)) * 0.2).astype(np.float32)
    pos, last, penult, maxts = _history(r)
    gcol = rng.integers(0, V, (r,)).astype(np.int32)
    gcol[:5] = (EOS, 3, TS_BEGIN + 4, NO_TS, 12)
    jcfg, tcfg = _pcfg(jproc, cap), _pcfg(tproc, cap)
    t = torch.from_numpy
    got = tverify.verify_rows(t(hs), t(emb), t(pos), t(gcol), tverify.masks_for(tcfg),
                              begin_index=BEGIN, eos_id=EOS, decay=(6, 1.2),
                              ts_cfg=tverify.ts_cfg_for(tcfg), n_verif=n_verif,
                              last=t(last), penult=t(penult), maxts=t(maxts))
    logits = jnp.asarray(hs) @ jnp.asarray(emb).T
    proc = jproc.apply_processors(logits, jnp.asarray(pos), jcfg)
    head = jproc.apply_timestamp_rules(proc[:n_verif], jnp.asarray(pos[:n_verif]),
                                       jnp.asarray(last[:n_verif]),
                                       jnp.asarray(penult[:n_verif]),
                                       jnp.asarray(maxts[:n_verif]), jcfg)
    proc = jnp.concatenate([head, proc[n_verif:]])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jnp.argmax(proc, -1)))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(proc.max(-1)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jax.nn.logsumexp(proc, -1)),
                               rtol=1e-4, atol=1e-4)
    ref_g = np.asarray(jnp.take_along_axis(proc, jnp.asarray(gcol)[:, None], -1)[:, 0])
    fin = np.isfinite(ref_g)
    np.testing.assert_allclose(got[3].numpy()[fin], ref_g[fin], rtol=1e-5, atol=1e-5)
    assert (got[3].numpy()[~fin] <= tverify.NEG).all()
    forced = np.asarray(jnp.isinf(head[:, :TS_BEGIN]).all(-1))
    assert forced.any() and not forced.all()
