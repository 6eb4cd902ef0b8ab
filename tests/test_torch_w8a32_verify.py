"""The verification kernels in W8A32 (the int8 copy of an f32 model): the
port's plain versions of K4 (verify_hidden: int8 heads and embedding on f32
rows, base_head and identity0 rows), K5 (verify_rows: int8 embedding on f32
rows) and head_rows vs the JAX ``_kernel_hidden`` / ``_kernel`` in
interpret mode, which score the f32 rows they are given against the int8
embedding cast to f32 (verify.py:208, :365) and cast int8 heads to the
source's dtype (:345-354).

The rows are f32 values that are not bf16 values (a plain version that
rounds them to bf16, as ``qmm_nt`` does, misses these by ~1e-2).  Each
case with suppress / begin-suppress / EOS decay on, and with the fused
timestamp rules (``ts_cfg``: forced and unforced verification rows, draft
rows past ``n_verif``).  Argmax exact; max, lse and gathered within 1e-4
(rtol and atol).  head_rows on f32 rows and int8 heads equals K4's row
block 0 bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_int8_verify import _check, _int8
from tests.test_torch_verify import _pcfg
from whisper_medusa_tpu.decoding import processors as jproc
from whisper_medusa_tpu.ops import verify as jverify
from whisper_medusa_tpu_torch.decoding import processors as tproc
from whisper_medusa_tpu_torch.ops import verify as tverify

TOL = 1e-4
D, EOS, BEGIN = 128, 5, 4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jverify, "_INTERPRET", True)
    monkeypatch.setattr(jverify, "_ENABLED", True)


def _ts_pcfg(cls, v, ts_begin):
    return cls.ProcessorConfig(
        vocab_size=v, suppress_tokens=(3, 10), begin_suppress_tokens=(1, 2),
        begin_index=BEGIN, exponential_decay_length_penalty=(6, 1.2), eos_token_id=EOS,
        timestamp_rules=True, timestamp_begin=ts_begin, no_timestamps_id=ts_begin - 1,
        max_initial_timestamp_index=30)


def _ts_history(rng, r, ts_begin):
    """(last, penult, maxts) int32 rows of every rule's kind."""
    kinds = rng.integers(0, 4, (r,))
    ts = lambda: ts_begin + rng.integers(0, 40, (r,))
    last = np.where(kinds >= 2, ts(), rng.integers(0, 400, (r,))).astype(np.int32)
    penult = np.where(kinds == 3, ts(), rng.integers(0, 400, (r,))).astype(np.int32)
    maxts = np.where(kinds >= 1, np.maximum(last, ts()) * (last >= ts_begin), 0)
    return last, penult, maxts.astype(np.int32)


def _f32_rows(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    assert not np.array_equal(x, np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32))
    return x


def _case(rng, r, v, ts):
    """pos, gcol, the processor configs and the keyword arguments of both
    sides: (kw_j, kw_t)."""
    pos = (BEGIN + rng.integers(0, 6, (r,))).astype(np.int32)
    gcol = rng.integers(0, v, (r,)).astype(np.int32)
    gcol[: min(r, 3)] = (EOS, 3, 2)[: min(r, 3)]
    if ts is None:
        jcfg, tcfg = _pcfg(v, jproc), _pcfg(v, tproc)
        kw_j = kw_t = dict(begin_index=4, eos_id=5, decay=(3, 1.2))
        return pos, gcol, jcfg, tcfg, kw_j, kw_t
    jcfg, tcfg = _ts_pcfg(jproc, v, ts), _ts_pcfg(tproc, v, ts)
    last, penult, maxts = _ts_history(rng, r, ts)
    base = dict(begin_index=BEGIN, eos_id=EOS, decay=(6, 1.2), n_verif=(2 * r) // 3)
    kw_j = dict(base, ts_cfg=jverify.ts_cfg_for(jcfg), last=jnp.asarray(last),
                penult=jnp.asarray(penult), maxts=jnp.asarray(maxts))
    kw_t = dict(base, ts_cfg=tverify.ts_cfg_for(tcfg), last=torch.from_numpy(last),
                penult=torch.from_numpy(penult), maxts=torch.from_numpy(maxts))
    return pos, gcol, jcfg, tcfg, kw_j, kw_t


@pytest.mark.parametrize("v,ts", [(8192 + 665, None), (64 * 9 + 23, 64 * 9 - 77)],
                         ids=["plain", "ts"])
@pytest.mark.parametrize("r", [8, 40])
def test_verify_rows_w8a32_matches_jax_kernel(r, v, ts):
    rng = np.random.default_rng(r + v)
    hs = _f32_rows(rng, (r, D), np.linspace(0.5, 3.0, r)[:, None])
    je, te = _int8((rng.standard_normal((v, D)) * 0.2).astype(np.float32), -1)
    pos, gcol, jcfg, tcfg, kw_j, kw_t = _case(rng, r, v, ts)
    ref = jverify.verify_rows(jnp.asarray(hs), je, jnp.asarray(pos), jnp.asarray(gcol),
                              jverify.masks_for(jcfg), **kw_j)
    got = tverify.verify_rows(torch.from_numpy(hs), te, torch.from_numpy(pos),
                              torch.from_numpy(gcol), tverify.masks_for(tcfg), **kw_t)
    assert tverify.q_rows_launches == tverify.w8a32_rows_launches == 0
    if ts is not None:
        forced = got[0][:kw_t["n_verif"]].numpy() >= ts
        assert forced.any() and not forced.all()
    _check(got, ref, TOL)


@pytest.mark.parametrize("identity0", [False, True], ids=["base_head", "identity0"])
@pytest.mark.parametrize("v,ts", [(8192 + 665, None), (64 * 9 + 23, 64 * 9 - 77)],
                         ids=["plain", "ts"])
def test_verify_hidden_w8a32_matches_jax_kernel(v, ts, identity0):
    b, n, nh = 1, 4, 3
    rng = np.random.default_rng(v + identity0)
    hver = _f32_rows(rng, (b, n, D))
    hsrc = _f32_rows(rng, (b, n, D)) if identity0 else hver
    jh, th = _int8((rng.standard_normal((nh, D, D)) * 0.05).astype(np.float32), -2)
    hb = (rng.standard_normal((nh, D)) * 0.1).astype(np.float32)
    je, te = _int8((rng.standard_normal((v, D)) * 0.2).astype(np.float32), -1)
    r = (nh + identity0) * b * n
    pos, gcol, jcfg, tcfg, kw_j, kw_t = _case(rng, r, v, ts)
    ref = jverify.verify_hidden(jnp.asarray(hver), jnp.asarray(hsrc), jh, jnp.asarray(hb), je,
                                jnp.asarray(pos), jnp.asarray(gcol), jverify.masks_for(jcfg),
                                identity0=identity0, **kw_j)
    t = torch.from_numpy
    got = tverify.verify_hidden(t(hver), t(hsrc), th, t(hb), te, t(pos), t(gcol),
                                tverify.masks_for(tcfg), identity0=identity0, **kw_t)
    assert tverify.w8a32_launches == tverify.w8a32_head_launches == 0
    _check(got, ref, TOL)


def test_head_rows_w8a32_is_k4_row_construction():
    """head_rows on f32 rows and int8 heads (the two-pass loop's head-0
    rows) equals K4's row block 0 on the same heads, bit for bit, and is
    f32: the heads are cast to the rows' dtype (verify.py:345-354)."""
    rng = np.random.default_rng(5)
    hid = torch.from_numpy(_f32_rows(rng, (2, 4, 64)))
    _, th = _int8((rng.standard_normal((3, 64, 64)) * 0.05).astype(np.float32), -2)
    hb = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32) * 0.1)
    rows = tverify.build_rows(hid, hid, th, hb, identity0=False)
    got = tverify.head_rows(hid.reshape(8, 64), {"q": th["q"][:1], "s": th["s"][:1]},
                            hb[:1])[0]
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, rows[:8], rtol=0, atol=0)
