"""Port ops/verify.py (plain versions of kernels K4 and K5) and
decoding/processors.py vs the JAX fused verification kernels and processors.

verify_hidden: the JAX ``_kernel_hidden`` in interpret mode at d=128 with 3
heads, suppress / begin-suppress / EOS decay on.  Argmax is exact; max, lse
and the gathered value within 3e-2 (bf16 row construction).  verify_rows: the
JAX ``_kernel`` in interpret mode at d=128, R in {1, 8, 40}, in f32, the same
processors on; argmax exact, max / lse / gathered within 1e-4.  Processors:
f32, 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.decoding import processors as jproc
from whisper_medusa_tpu.ops import verify as jverify
from whisper_medusa_tpu_torch.decoding import processors as tproc
from whisper_medusa_tpu_torch.ops import verify as tverify


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jverify, "_INTERPRET", True)
    monkeypatch.setattr(jverify, "_ENABLED", True)


def _pcfg(v, cls, decay=(3, 1.2)):
    return cls.ProcessorConfig(
        vocab_size=v, suppress_tokens=(3, 10, v - 2, v // 2),
        begin_suppress_tokens=(1, 2, 5), begin_index=4,
        exponential_decay_length_penalty=decay, eos_token_id=5)


@pytest.mark.parametrize("v", [8192, 8192 + 665])
def test_plain_matches_kernel_hidden(v):
    d, n, nh = 128, 4, 3
    rng = np.random.default_rng(v)
    hid = rng.standard_normal((1, n, d)).astype(np.float32)
    hw = (rng.standard_normal((nh, d, d)) * 0.05).astype(np.float32)
    hb = (rng.standard_normal((nh, d)) * 0.1).astype(np.float32)
    emb = (rng.standard_normal((v, d)) * 0.2).astype(np.float32)
    r = nh * n
    pos = (3 + np.arange(n)[None, :] + np.arange(nh)[:, None]).reshape(-1).astype(np.int32)
    gcol = rng.integers(0, v, (r,)).astype(np.int32)
    gcol[:3] = (5, 3, 2)                    # the EOS column, and suppressed ones
    kw = dict(identity0=False, begin_index=4, eos_id=5, decay=(3, 1.2))

    jm = jverify.masks_for(_pcfg(v, jproc))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = jverify.verify_hidden(bf(hid), bf(hid), bf(hw), jnp.asarray(hb), bf(emb),
                                jnp.asarray(pos), jnp.asarray(gcol), jm, **kw)
    tm = tverify.masks_for(_pcfg(v, tproc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    tb = lambda a: torch.from_numpy(a).bfloat16()
    got = tverify.verify_hidden(tb(hid), tb(hid), tb(hw), torch.from_numpy(hb), tb(emb),
                                torch.from_numpy(pos), torch.from_numpy(gcol), tm, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for name, a, b in zip(("max", "lse", "gathered"), got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-2, atol=3e-2,
                                   err_msg=name)


@pytest.mark.parametrize("r", [1, 8, 40])
@pytest.mark.parametrize("v", [8192, 8192 + 665])
def test_verify_rows_plain_matches_jax_kernel(v, r):
    d = 128
    rng = np.random.default_rng(v + r)
    hs = rng.standard_normal((r, d)).astype(np.float32)
    emb = (rng.standard_normal((v, d)) * 0.2).astype(np.float32)
    pos = (3 + rng.integers(0, 4, (r,))).astype(np.int32)   # begin_index 4 and decay start 3 hit
    gcol = rng.integers(0, v, (r,)).astype(np.int32)
    gcol[: min(r, 3)] = (5, 3, 2)[: min(r, 3)]   # the EOS column, and suppressed ones
    kw = dict(begin_index=4, eos_id=5, decay=(3, 1.2))
    jm = jverify.masks_for(_pcfg(v, jproc))
    ref = jverify.verify_rows(jnp.asarray(hs), jnp.asarray(emb), jnp.asarray(pos),
                              jnp.asarray(gcol), jm, **kw)
    tm = tverify.masks_for(_pcfg(v, tproc))
    got = tverify.verify_rows(torch.from_numpy(hs), torch.from_numpy(emb),
                              torch.from_numpy(pos), torch.from_numpy(gcol), tm, **kw)
    assert tverify.rows_launches == 0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for name, a, b in zip(("max", "lse", "gathered"), got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_head_rows_plain_is_k4_row_construction():
    """head_rows (the two-pass loop's head-0 rows) equals K4's row block 0."""
    rng = np.random.default_rng(3)
    hid = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32)).bfloat16()
    hw = torch.from_numpy(rng.standard_normal((3, 64, 64)).astype(np.float32) * 0.05)
    hb = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32) * 0.1)
    rows = tverify.build_rows(hid, hid, hw, hb, identity0=False)
    got = tverify.head_rows(hid.reshape(8, 64), hw[:1], hb[:1])[0]
    torch.testing.assert_close(got, rows[:8], rtol=0, atol=0)


@pytest.mark.parametrize("what,match", [("quant_ts_cfg", "item 12"), ("ts_cfg", "item 12")])
def test_verify_rows_unported_modes_raise(what, match):
    """The fused timestamp rules (ROADMAP item 12, ported) refuse verification
    rows without their history, with a bf16 or an int8 embedding."""
    hs = torch.zeros((2, 64))
    emb = torch.zeros((10, 64))
    if what == "quant_ts_cfg":
        emb = {"q": emb.to(torch.int8), "s": torch.ones(10)}
    kw = dict(ts_cfg=(8, 7, None), n_verif=2)
    with pytest.raises(ValueError, match=match):
        tverify.verify_rows(hs, emb, torch.zeros(2, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32),
                            torch.zeros(2, 10, dtype=torch.int8), begin_index=0,
                            eos_id=0, decay=None, **kw)


@pytest.mark.parametrize("decay", [None, (3, 1.2)])
def test_apply_processors_matches_jax(decay):
    v = 512
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 6, v)).astype(np.float32)
    pos = (2 + np.arange(6)[None, :] + np.arange(3)[:, None]).astype(np.int32)
    ref = np.asarray(jproc.apply_processors(jnp.asarray(logits), jnp.asarray(pos),
                                            _pcfg(v, jproc, decay)))
    got = tproc.apply_processors(torch.from_numpy(logits), torch.from_numpy(pos),
                                 _pcfg(v, tproc, decay)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5)


def test_kernel_processors_follow_apply_processors():
    """process_rows (the kernel's processors: NEG for suppressed columns, the
    exp form of the decay) agrees with apply_processors (-inf, power)."""
    v = 300
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((8, v)).astype(np.float32))
    pos = torch.arange(8, dtype=torch.int32)
    cfg = _pcfg(v, tproc)
    got = tverify.process_rows(x, pos, tverify.masks_for(cfg), begin_index=4,
                               eos_id=5, decay=(3, 1.2))
    ref = tproc.apply_processors(x, pos, cfg)
    # (-inf + inf*0.2 at a begin-suppressed EOS is NaN in apply_processors,
    # in JAX too; the kernel form stays finite.)
    assert (got[torch.isinf(ref)] == tverify.NEG).all()
    fin = torch.isfinite(ref)
    torch.testing.assert_close(got[fin], ref[fin], rtol=1e-6, atol=1e-6)


def test_timestamp_rules_are_not_ported():
    """verify_hidden's timestamp mode (ported since the rules' slice) takes
    n_verif rows' history; without it, it raises naming the rules."""
    x = torch.zeros((1, 1, 256))
    with pytest.raises(ValueError, match="timestamp"):
        tverify.verify_hidden(x, x, torch.zeros(1, 256, 256), torch.zeros(1, 256),
                              torch.zeros(10, 256), torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32),
                              torch.zeros(2, 10, dtype=torch.int8), identity0=False,
                              begin_index=0, eos_id=0, decay=None,
                              ts_cfg=(8, 7, None), n_verif=1)
