"""K5's vocab stream, emulated: per-(64-entry tile, row) partials merged in
the combine kernel's order.

``csrc/verify.cu`` scores the rows against each 64-entry vocab tile and
writes, per (tile, row), the processed tile's max, its argmax (ties to the
lowest column), the sum of exp(x - max) and the value at ``gcol``;
``verify_combine_kernel`` then merges a row's tiles: lane l of a warp takes
tiles l, l + 32, ... in order, and the 32 lane results meet in a butterfly
(xor 16, 8, 4, 2, 1).  Here the same partials and the same merge order are
computed in PyTorch from the plain version's logits, and the result is held
to ``verify_rows_plain`` (max, argmax and gathered equal, log-sum-exp within
1e-5) and to the JAX ``verify_rows`` kernel in interpret mode (argmax equal,
max / lse / gathered within 1e-5), at R = 1, 88, 121 and 300 (past one
192-row pass), bf16 and int8 embeddings, with suppressed columns (one of
them the largest logit), begin-suppress and the EOS decay on, and an exact
tie across two tiles, which the lowest column must win.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_verify import _pcfg
from whisper_medusa_tpu.decoding import processors as jproc
from whisper_medusa_tpu.ops import verify as jverify
from whisper_medusa_tpu_torch.decoding import processors as tproc
from whisper_medusa_tpu_torch.ops import verify as tverify

V, D = 64 * 9 + 23, 64        # ten vocab tiles, the last ragged
TIE = (70, 200)               # equal embedding rows in tiles 1 and 3
HOT = 10                      # a suppressed column (_pcfg) made the largest logit
KW = dict(begin_index=4, eos_id=5, decay=(3, 1.2))
INT_MAX = 2 ** 31 - 1


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jverify, "_INTERPRET", True)
    monkeypatch.setattr(jverify, "_ENABLED", True)


def _merge(m, a, s, m2, a2, s2):
    """verify.cu ``merge``, elementwise over rows."""
    skip, take = m2 == -np.inf, m == -np.inf
    mn = torch.maximum(m, m2)
    new_a = torch.where((m2 > m) | ((m2 == m) & (a2 < a)), a2, a)
    new_s = s * torch.exp(m - mn) + s2 * torch.exp(m2 - mn)
    m_out = torch.where(skip, m, torch.where(take, m2, mn))
    a_out = torch.where(skip, a, torch.where(take, a2, new_a))
    s_out = torch.where(skip, s, torch.where(take, s2, new_s))
    return m_out, a_out, s_out


def tile_partials(x, gcol):
    """The stream's partials of processed logits x (R, V): (m, s, g) and the
    argmax, each (R, tiles); columns past V take NEG, as the kernel's."""
    r, v = x.shape
    tiles = -(-v // tverify.TILE)
    xp = torch.full((r, tiles * tverify.TILE), tverify.NEG, dtype=torch.float32)
    xp[:, :v] = x
    xt = xp.reshape(r, tiles, tverify.TILE)
    m = xt.amax(-1)
    cols = torch.arange(tiles * tverify.TILE).reshape(tiles, tverify.TILE)
    arg = torch.where(xt == m[..., None], cols[None], INT_MAX).amin(-1)
    s = torch.exp(xt - m[..., None]).sum(-1)
    g = torch.where(cols[None] == gcol.long()[:, None, None], xt,
                    torch.tensor(tverify.NEG)).amax(-1)
    return m, s, g, arg


def combine(m_t, s_t, g_t, a_t):
    """``verify_combine_kernel``'s order: lane l merges tiles l, l + 32, ...,
    then the 32 lanes meet in a butterfly; lse = m + log(s)."""
    r, tiles = m_t.shape
    m = torch.full((r, 32), -np.inf)
    s = torch.zeros((r, 32))
    a = torch.full((r, 32), INT_MAX, dtype=torch.int64)
    g = torch.full((r, 32), tverify.NEG)
    for t in range(tiles):
        lane = t % 32
        m[:, lane], a[:, lane], s[:, lane] = _merge(m[:, lane], a[:, lane], s[:, lane],
                                                    m_t[:, t], a_t[:, t], s_t[:, t])
        g[:, lane] = torch.maximum(g[:, lane], g_t[:, t])
    for o in (16, 8, 4, 2, 1):
        partner = torch.arange(32) ^ o
        m, a, s = _merge(m, a, s, m[:, partner], a[:, partner], s[:, partner])
        g = torch.maximum(g, g[:, partner])
    return a[:, 0].to(torch.int32), m[:, 0], m[:, 0] + torch.log(s[:, 0]), g[:, 0]


def _inputs(r, quant, seed):
    rng = np.random.default_rng(seed)
    hs = rng.standard_normal((r, D)).astype(np.float32)
    emb = (rng.standard_normal((V, D)) * 0.2).astype(np.float32)
    emb[TIE[0]] = emb[TIE[1]] = hs[0] * 0.5           # row 0: an exact tie, the max
    emb[HOT] = hs[0] * 0.9                            # larger still, but suppressed
    pos = (3 + rng.integers(0, 4, (r,))).astype(np.int32)
    pos[0] = 3                                        # row 0: no begin-suppress, no decay
    gcol = rng.integers(0, V, (r,)).astype(np.int32)
    gcol[: min(r, 4)] = (TIE[1], 5, 3, HOT)[: min(r, 4)]
    hs = torch.from_numpy(hs).bfloat16().float().numpy()      # bf16 values in f32
    if quant:
        amax = np.abs(emb).max(1)
        sc = np.where(amax == 0, 1.0, amax / 127.0).astype(np.float32)
        q = np.clip(np.round(emb / sc[:, None]), -127, 127).astype(np.int8)
        return hs, {"q": q, "s": sc}, pos, gcol
    emb = torch.from_numpy(emb).bfloat16().float().numpy()
    return hs, emb, pos, gcol


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r", [1, 88, 121, 300])
def test_emulated_partials_match_plain_and_jax(r, quant):
    hs, emb, pos, gcol = _inputs(r, quant, 7 * r + quant)
    t_emb = ({k: torch.from_numpy(a) for k, a in emb.items()} if quant
             else torch.from_numpy(emb).bfloat16())
    t_hs = torch.from_numpy(hs).bfloat16()
    t_pos, t_gcol = torch.from_numpy(pos), torch.from_numpy(gcol)
    tm = tverify.masks_for(_pcfg(V, tproc))
    logits = tverify.process_rows(tverify.row_logits(t_hs, t_emb), t_pos, tm, **KW)
    got = combine(*tile_partials(logits, t_gcol))
    plain = tverify.verify_rows_plain(t_hs, t_emb, t_pos, t_gcol, tm, **KW)

    torch.testing.assert_close(got[0], plain[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], plain[1], rtol=0, atol=0)
    torch.testing.assert_close(got[2], plain[2], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[3], plain[3], rtol=0, atol=0)
    # Row 0: the tie across tiles 1 and 3 goes to the lower column; the
    # larger suppressed column is not taken.
    assert int(got[0][0]) == TIE[0]
    assert logits[0, TIE[0]] == logits[0, TIE[1]] == logits[0].max()
    assert float(got[3][0]) == float(got[1][0])          # gcol = the tie's other column
    if r >= 4:
        assert float(got[3][3]) == tverify.NEG            # gcol = the suppressed column

    j_emb = ({"q": jnp.asarray(emb["q"]), "s": jnp.asarray(emb["s"])} if quant
             else jnp.asarray(emb, jnp.bfloat16))
    j_hs = jnp.asarray(hs) if quant else jnp.asarray(hs, jnp.bfloat16)
    ref = jverify.verify_rows(j_hs, j_emb, jnp.asarray(pos), jnp.asarray(gcol),
                              jverify.masks_for(_pcfg(V, jproc)), **KW)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for name, a, b in zip(("max", "lse", "gathered"), got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
