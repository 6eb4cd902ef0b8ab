"""K4 / K5's timestamp mode, emulated: the vocab stream's per-(tile, row)
partials of the rule-masked logits, the straddling tile's split and
``verify_combine_ts_kernel``'s fold and force rule.

``csrc/verify.cu`` in its TS instantiations masks the columns the timestamp
rules bar for rows < n_verif, writes the usual per-(tile, row) partials, and
in the one tile that holds both text and timestamp columns (ts_begin % 64
!= 0) also the timestamp side's max / argmax / sum of exp and the text
side's max.  The combine folds, in lane order, every tile into the row's
statistics, the timestamp tiles into the timestamp side and the text tiles
into the text max; after the butterfly lane 0 merges the split and forces
the rows whose timestamp log-sum-exp beats their best text logit.  Here the
same partials and order run in PyTorch on the plain version's logits and
are held to ``verify_rows_plain``'s ts mode (argmax, max and gathered equal,
log-sum-exp within 1e-5) and to the JAX kernel in interpret mode (argmax
equal, the rest within 1e-5), at R = 7, 88 and 300, with ts_begin inside a
tile and on a tile's edge.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_vocab_stream import INT_MAX, _merge, tile_partials
from whisper_medusa_tpu.decoding import processors as jproc
from whisper_medusa_tpu.ops import verify as jverify
from whisper_medusa_tpu_torch.decoding import processors as tproc
from whisper_medusa_tpu_torch.ops import verify as tverify

V, D, EOS, BEGIN = 64 * 9 + 23, 64, 5, 4
TILE = tverify.TILE


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jverify, "_INTERPRET", True)
    monkeypatch.setattr(jverify, "_ENABLED", True)


def _pcfg(cls, ts_begin):
    return cls.ProcessorConfig(
        vocab_size=V, suppress_tokens=(3, 10), begin_suppress_tokens=(1, 2),
        begin_index=BEGIN, exponential_decay_length_penalty=(6, 1.2), eos_token_id=EOS,
        timestamp_rules=True, timestamp_begin=ts_begin, no_timestamps_id=ts_begin - 1,
        max_initial_timestamp_index=30)


def split_partials(x, ts_begin):
    """The straddling tile's split (m_ts, s_ts, a_ts, m_tx), or None."""
    if ts_begin % TILE == 0:
        return None
    t0 = ts_begin // TILE * TILE
    cols = torch.arange(t0, t0 + TILE)
    xt = torch.full((x.shape[0], TILE), tverify.NEG)
    n = min(TILE, x.shape[1] - t0)
    xt[:, :n] = x[:, t0:t0 + n]
    is_ts = cols >= ts_begin
    y = torch.where(is_ts[None], xt, torch.tensor(-np.inf))
    m_ts = y.amax(-1)
    a_ts = torch.where(y == m_ts[:, None], cols[None], INT_MAX).amin(-1)
    s_ts = torch.where(is_ts[None], torch.exp(xt - m_ts[:, None]), torch.tensor(0.0)).sum(-1)
    m_tx = torch.where(is_ts[None], torch.tensor(-np.inf), xt).amax(-1)
    return m_ts, s_ts, a_ts, m_tx


def combine_ts(parts, split, ts_begin, n_verif, gcol):
    """``verify_combine_ts_kernel``: lane l folds tiles l, l + 32, ...; the
    butterfly; then lane 0 merges the split and resolves the force rule."""
    m_t, s_t, g_t, a_t = parts
    r, tiles = m_t.shape
    straddle = ts_begin // TILE if ts_begin % TILE else -1
    ninf = lambda: torch.full((r, 32), -np.inf)
    m, s, a, g = ninf(), torch.zeros((r, 32)), torch.full((r, 32), INT_MAX), \
        torch.full((r, 32), tverify.NEG)
    mts, sts, ats, mtx = ninf(), torch.zeros((r, 32)), torch.full((r, 32), INT_MAX), ninf()
    for t in range(tiles):
        ln = t % 32
        m[:, ln], a[:, ln], s[:, ln] = _merge(m[:, ln], a[:, ln], s[:, ln],
                                              m_t[:, t], a_t[:, t], s_t[:, t])
        g[:, ln] = torch.maximum(g[:, ln], g_t[:, t])
        if t * TILE >= ts_begin:
            mts[:, ln], ats[:, ln], sts[:, ln] = _merge(mts[:, ln], ats[:, ln], sts[:, ln],
                                                        m_t[:, t], a_t[:, t], s_t[:, t])
        elif t != straddle:
            mtx[:, ln] = torch.maximum(mtx[:, ln], m_t[:, t])
    for o in (16, 8, 4, 2, 1):
        p = torch.arange(32) ^ o
        m, a, s = _merge(m, a, s, m[:, p], a[:, p], s[:, p])
        mts, ats, sts = _merge(mts, ats, sts, mts[:, p], ats[:, p], sts[:, p])
        g, mtx = torch.maximum(g, g[:, p]), torch.maximum(mtx, mtx[:, p])
    m, s, a, g, mts, sts, ats, mtx = (z[:, 0] for z in (m, s, a, g, mts, sts, ats, mtx))
    if split is not None:
        sm, ss, sa, sx = split
        mts, ats, sts = _merge(mts, ats, sts, sm, sa, ss)
        mtx = torch.maximum(mtx, sx)
    lse_ts = mts + torch.log(sts)
    force = (torch.arange(r) < n_verif) & (lse_ts > mtx)
    return (torch.where(force, ats, a).to(torch.int32), torch.where(force, mts, m),
            torch.where(force, lse_ts, m + torch.log(s)),
            torch.where(force & (gcol < ts_begin), torch.tensor(tverify.NEG), g))


@pytest.mark.parametrize("ts_begin", [V - 100, 8 * TILE], ids=["straddle", "edge"])
@pytest.mark.parametrize("r", [7, 88, 300])
def test_emulated_ts_partials_match_plain_and_jax(r, ts_begin):
    rng = np.random.default_rng(r + ts_begin)
    hs = (rng.standard_normal((r, D)) * np.linspace(0.2, 4.0, r)[:, None]).astype(np.float32)
    emb = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    pos = (BEGIN + rng.integers(0, 6, (r,))).astype(np.int32)
    kinds = rng.integers(0, 4, (r,))
    ts = lambda k: ts_begin + rng.integers(0, 40, (r,))
    last = np.where(kinds >= 2, ts(0), rng.integers(0, 400, (r,))).astype(np.int32)
    penult = np.where(kinds == 3, ts(0), rng.integers(0, 400, (r,))).astype(np.int32)
    maxts = np.where(kinds >= 1, np.maximum(last, ts(0)) * (last >= ts_begin), 0).astype(
        np.int32)
    gcol = rng.integers(0, V, (r,)).astype(np.int32)
    n_verif = (2 * r) // 3
    t = torch.from_numpy
    hs_t = t(hs).bfloat16()
    emb_t = t(emb).bfloat16()
    tcfg = _pcfg(tproc, ts_begin)
    masks = tverify.masks_for(tcfg)
    kw = dict(begin_index=BEGIN, eos_id=EOS, decay=(6, 1.2))
    ts_args = dict(cfg=tverify.ts_cfg_for(tcfg), n_verif=n_verif, last=t(last),
                   penult=t(penult), maxts=t(maxts))
    x = tverify.process_rows(tverify.row_logits(hs_t, emb_t), t(pos), masks, ts=ts_args, **kw)
    got = combine_ts(tile_partials(x, t(gcol)), split_partials(x, ts_begin), ts_begin,
                     n_verif, t(gcol))
    plain = tverify.verify_rows(hs_t, emb_t, t(pos), t(gcol), masks,
                                ts_cfg=tverify.ts_cfg_for(tcfg), n_verif=n_verif,
                                last=t(last), penult=t(penult), maxts=t(maxts), **kw)
    for i in (0, 1, 3):
        torch.testing.assert_close(got[i], plain[i], rtol=0, atol=0)
    torch.testing.assert_close(got[2], plain[2], rtol=1e-5, atol=1e-5)
    forced = (got[0][:n_verif] >= ts_begin).numpy()
    assert forced.any() and not forced.all()

    jcfg = _pcfg(jproc, ts_begin)
    j = jnp.asarray
    ref = jverify.verify_rows(j(hs, jnp.bfloat16), j(emb, jnp.bfloat16), j(pos), j(gcol),
                              jverify.masks_for(jcfg), ts_cfg=jverify.ts_cfg_for(jcfg),
                              n_verif=n_verif, last=j(last), penult=j(penult),
                              maxts=j(maxts), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for name, a, b in zip(("max", "lse", "gathered"), got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
