"""int8 serving verification: the port's plain versions of the int8 modes of
K4 (verify_hidden, int8 embedding and int8 heads), K5 (verify_rows, int8
embedding) and the int8 heads of apply_heads, vs the JAX package.

verify_hidden: the JAX ``_kernel_hidden`` in interpret mode with its
``quant`` and ``hquant`` modes, bf16 at d=128, B=1, 3 heads, suppress /
begin-suppress / EOS decay on: argmax exact, max / lse / gathered within
3e-2 (bf16 row construction).  verify_rows: the JAX ``_kernel`` in its
``quant`` mode, f32 at R in {1, 8, 40}: argmax exact, max / lse / gathered
within 1e-4.  The rows are bf16 values held in f32: the port's plain version
scores bf16(rows) against an int8 embedding (the JAX ``qmm_nt`` rounding),
the JAX kernel scores the f32 rows it is given, and on these rows the two
agree.  apply_heads: the JAX function on int8 heads, f32, 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_verify import _pcfg
from whisper_medusa_tpu.decoding import processors as jproc
from whisper_medusa_tpu.models import medusa as jmedusa
from whisper_medusa_tpu.ops import qmm as jqmm
from whisper_medusa_tpu.ops import verify as jverify
from whisper_medusa_tpu_torch.decoding import processors as tproc
from whisper_medusa_tpu_torch.models import medusa as tmedusa
from whisper_medusa_tpu_torch.ops import verify as tverify


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jverify, "_INTERPRET", True)
    monkeypatch.setattr(jverify, "_ENABLED", True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _int8(w, axis):
    """The JAX-quantized weight and the same int8 dict for the port."""
    q, s = jqmm.quantize_array(jnp.asarray(w), axis=axis)
    return {"q": q, "s": s}, {"q": _t(q), "s": _t(s)}


def _check(got, ref, tol):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for name, a, b in zip(("max", "lse", "gathered"), got[1:], ref[1:]):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("hquant", [False, True], ids=["bf16-heads", "int8-heads"])
@pytest.mark.parametrize("v", [8192, 8192 + 665])
def test_verify_hidden_int8_matches_jax_kernel(v, hquant):
    d, n, nh = 128, 4, 3
    rng = np.random.default_rng(v + hquant)
    hid = rng.standard_normal((1, n, d)).astype(np.float32)
    hw = (rng.standard_normal((nh, d, d)) * 0.05).astype(np.float32)
    hb = (rng.standard_normal((nh, d)) * 0.1).astype(np.float32)
    emb = (rng.standard_normal((v, d)) * 0.2).astype(np.float32)
    pos = (3 + np.arange(n)[None, :] + np.arange(nh)[:, None]).reshape(-1).astype(np.int32)
    gcol = rng.integers(0, v, (nh * n,)).astype(np.int32)
    gcol[:3] = (5, 3, 2)                    # the EOS column, and suppressed ones
    kw = dict(identity0=False, begin_index=4, eos_id=5, decay=(3, 1.2))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).bfloat16()
    je, te = _int8(emb, -1)
    if hquant:
        jh, th = _int8(hw, -2)
    else:
        jh, th = bf(hw), tb(hw)
    ref = jverify.verify_hidden(bf(hid), bf(hid), jh, jnp.asarray(hb), je,
                                jnp.asarray(pos), jnp.asarray(gcol),
                                jverify.masks_for(_pcfg(v, jproc)), **kw)
    got = tverify.verify_hidden(tb(hid), tb(hid), th, torch.from_numpy(hb), te,
                                torch.from_numpy(pos), torch.from_numpy(gcol),
                                tverify.masks_for(_pcfg(v, tproc)), **kw)
    assert tverify.q_launches == 0
    _check(got, ref, 3e-2)


@pytest.mark.parametrize("r", [1, 8, 40])
@pytest.mark.parametrize("v", [8192, 8192 + 665])
def test_verify_rows_int8_matches_jax_kernel(v, r):
    d = 128
    rng = np.random.default_rng(v + r)
    hs = rng.standard_normal((r, d)).astype(np.float32)
    hs = np.array(jnp.asarray(hs, jnp.bfloat16).astype(jnp.float32))    # bf16 values
    emb = (rng.standard_normal((v, d)) * 0.2).astype(np.float32)
    pos = (3 + rng.integers(0, 4, (r,))).astype(np.int32)
    gcol = rng.integers(0, v, (r,)).astype(np.int32)
    gcol[: min(r, 3)] = (5, 3, 2)[: min(r, 3)]
    kw = dict(begin_index=4, eos_id=5, decay=(3, 1.2))
    je, te = _int8(emb, -1)
    ref = jverify.verify_rows(jnp.asarray(hs), je, jnp.asarray(pos), jnp.asarray(gcol),
                              jverify.masks_for(_pcfg(v, jproc)), **kw)
    got = tverify.verify_rows(torch.from_numpy(hs), te, torch.from_numpy(pos),
                              torch.from_numpy(gcol), tverify.masks_for(_pcfg(v, tproc)),
                              **kw)
    assert tverify.q_rows_launches == 0
    _check(got, ref, 1e-4)


def test_apply_heads_int8_matches_jax():
    rng = np.random.default_rng(7)
    hw = (rng.standard_normal((4, 2, 64, 64)) * 0.1).astype(np.float32)
    hb = (rng.standard_normal((4, 2, 64)) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jh, th = _int8(hw, -2)
    ref = jmedusa.apply_heads({"heads": {"w": jh, "b": jnp.asarray(hb)}}, jnp.asarray(x))
    got = tmedusa.apply_heads({"heads": {"w": th, "b": torch.from_numpy(hb)}},
                              torch.from_numpy(x))
    assert got.shape == (4, 2, 5, 64) and tverify.q_head_launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_head_rows_int8_is_k4_row_construction():
    """head_rows on int8 heads (the two-pass loop's head-0 rows) equals K4's
    row block 0 on the same heads."""
    rng = np.random.default_rng(3)
    hid = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32)).bfloat16()
    _, th = _int8((rng.standard_normal((3, 64, 64)) * 0.05).astype(np.float32), -2)
    hb = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32) * 0.1)
    rows = tverify.build_rows(hid, hid, th, hb, identity0=False)
    got = tverify.head_rows(hid.reshape(8, 64), {"q": th["q"][:1], "s": th["s"][:1]},
                            hb[:1])[0]
    torch.testing.assert_close(got, rows[:8], rtol=0, atol=0)
