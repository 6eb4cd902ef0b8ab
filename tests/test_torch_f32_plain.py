"""The plain versions of K1 and K4 in f32 (the JAX package's default dtype)
against the JAX Pallas kernels in interpret mode, as the JAX tests run them.

The other f32 modes' plain versions already have f32 cases against JAX:
K3 (test_torch_logits.py), K5 (test_torch_verify.py), K10 and its mask
mode (test_torch_decode_ops.py, test_torch_cross_split.py), K11
(test_torch_decode_ops.py).  K1: ``_attention_pallas`` on f32 q, k, v
(P not rounded), output and log-sum-exp within 1e-4.  K4: ``_kernel_hidden``
at f32 rows, heads and embedding, base_head and identity0 rows, and its
timestamp mode: argmax exact, max / lse / gathered within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
import whisper_medusa_tpu.ops.attention as jattn
from whisper_medusa_tpu.decoding import processors as jproc
from whisper_medusa_tpu.ops import verify as jverify
from whisper_medusa_tpu_torch.decoding import processors as tproc
from whisper_medusa_tpu_torch.ops import attention as tattn
from whisper_medusa_tpu_torch.ops import verify as tverify

TOL = 1e-4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jattn, "_INTERPRET", True)
    monkeypatch.setattr(jattn, "_ENABLED", True)
    monkeypatch.setattr(jverify, "_INTERPRET", True)
    monkeypatch.setattr(jverify, "_ENABLED", True)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_len", [384, 301])
def test_k1_plain_matches_pallas_kernel_f32(causal, kv_len):
    rng = np.random.default_rng(kv_len + causal)
    q, k, v = (rng.standard_normal((1, 2, 384, 64)).astype(np.float32) for _ in range(3))
    q *= 0.25
    ref = np.asarray(jattn._attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             kv_len, causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn.full_attention_bhsd(tq, tk, tv, kv_len=kv_len, causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    # The log-sum-exp K1's f32 mode writes: that of the scores the output used.
    s = np.einsum("bhqd,bhkd->bhqk", q, k).astype(np.float64)
    mask = np.arange(384)[None, :] < kv_len
    if causal:
        mask = mask & (np.arange(384)[None, :] <= np.arange(384)[:, None])
    s = np.where(mask, s, -np.inf)
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(tattn.attention_lse_plain(tq, tk, kv_len, causal).numpy(),
                               lse, rtol=TOL, atol=TOL)


def _pcfg(v, cls):
    return cls.ProcessorConfig(
        vocab_size=v, suppress_tokens=(3, 10, v - 2, v // 2),
        begin_suppress_tokens=(1, 2, 5), begin_index=4,
        exponential_decay_length_penalty=(3, 1.2), eos_token_id=5)


@pytest.mark.parametrize("identity0,ts", [(False, False), (True, False), (False, True)],
                         ids=["base_head", "identity0", "timestamps"])
def test_k4_plain_matches_kernel_hidden_f32(identity0, ts):
    d, n, nh, v = 128, 4, 3, 8192 + 665
    rng = np.random.default_rng(7 + 2 * identity0 + ts)
    hid = rng.standard_normal((1, n, d)).astype(np.float32)
    src = rng.standard_normal((1, n, d)).astype(np.float32) if identity0 else hid
    hw = (rng.standard_normal((nh, d, d)) * 0.05).astype(np.float32)
    hb = (rng.standard_normal((nh, d)) * 0.1).astype(np.float32)
    emb = (rng.standard_normal((v, d)) * 0.2).astype(np.float32)
    r = (nh + identity0) * n
    pos = (3 + np.arange(n)[None, :]
           + np.arange(nh + identity0)[:, None]).reshape(-1).astype(np.int32)
    gcol = rng.integers(0, v, (r,)).astype(np.int32)
    gcol[:3] = (5, 3, 2)
    kw = dict(identity0=identity0, begin_index=4, eos_id=5, decay=(3, 1.2))
    if ts:
        tb = v - 1501                       # 1501 timestamp columns, a straddling tile
        hist = [rng.integers(0, v, (r,)).astype(np.int32) for _ in range(3)]
        hist[2] = np.where(hist[2] >= tb, hist[2], 0).astype(np.int32)
        kw.update(ts_cfg=(tb, tb - 1, 50), n_verif=n, last=hist[0], penult=hist[1],
                  maxts=hist[2])
    jm = jverify.masks_for(_pcfg(v, jproc))
    jkw = {k: (jnp.asarray(a) if isinstance(a, np.ndarray) else a) for k, a in kw.items()}
    ref = jverify.verify_hidden(*(jnp.asarray(a) for a in (hid, src, hw, hb, emb, pos, gcol)),
                                jm, **jkw)
    tkw = {k: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a) for k, a in kw.items()}
    got = tverify.verify_hidden(*(torch.from_numpy(a) for a in (hid, src, hw, hb, emb, pos,
                                                                 gcol)),
                                tverify.masks_for(_pcfg(v, tproc)), **tkw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for name, a, b in zip(("max", "lse", "gathered"), got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL, err_msg=name)
