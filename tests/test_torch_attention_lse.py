"""The one-pass K9's plain versions against the JAX package: K1's log-sum-exp
output (ops/attention.py::attention_lse_plain) against jax.nn.logsumexp of
the masked scores as ``_attention_xla`` builds them, and the backward from
the forward's statistics (attention_bwd_lse_plain, fed attention_plain's
output and that log-sum-exp) against the Pallas backward in interpret mode
at bf16 and the XLA vjp at f32; the new K1 and K9 wrapper signatures refuse
CPU tensors.  The kernels are held against these on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import whisper_medusa_tpu.ops.attention as JA
from whisper_medusa_tpu_torch.ops import attention as A

# The cases of test_torch_attention_bwd.py::test_plain_matches_xla_vjp_f32.
XLA_CASES = [
    (224, 1500, 1500, False),      # teacher-forced cross-attention
    (224, 224, 224, True),         # decoder causal self-attention
    (150, 150, 150, False),
    (77, 300, 257, False),         # ragged, kv_len < Skv
    (100, 100, 90, True),
]


def _inputs(q_shape, kv_shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=q_shape) * 0.3).astype(dtype)
    k, v = (rng.normal(size=kv_shape).astype(dtype) for _ in range(2))
    g = rng.normal(size=q_shape).astype(dtype)
    return q, k, v, g


def _jax_masked_scores(q, k, kv_len, causal):
    """The f32 scores of ``_attention_xla``, masked to NEG_BIG as it masks."""
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
    col = jax.lax.broadcasted_iota(jnp.int32, s.shape, 3)
    mask = col < kv_len
    if causal:
        mask = mask & (col <= jax.lax.broadcasted_iota(jnp.int32, s.shape, 2))
    if kv_len < k.shape[2] or causal:
        s = jnp.where(mask, s, JA.NEG_BIG)
    return s


@pytest.mark.parametrize("sq,skv,kv_len,causal", XLA_CASES)
def test_lse_plain_matches_jax_logsumexp(sq, skv, kv_len, causal):
    """f32, within 1e-5: the same scores, two logsumexp implementations."""
    q, k, _, _ = _inputs((1, 2, sq, 64), (1, 2, skv, 64), seed=sq + skv + 1)
    ref = jax.nn.logsumexp(_jax_masked_scores(jnp.asarray(q), jnp.asarray(k), kv_len,
                                              causal), axis=-1)
    got = A.attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k), kv_len, causal)
    assert got.dtype == torch.float32 and got.shape == (1, 2, sq)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_len", [1024, 999])
def test_lse_bwd_plain_matches_pallas_bwd_bf16(monkeypatch, causal, kv_len):
    """bf16 operands, O from attention_plain (P rounded to bf16 before PV, as
    the TPU forward does, and O itself rounded to bf16) and its f32
    log-sum-exp; both sides round dS and P to bf16 where the TPU kernel does.
    dV does not go through Dsum and is held elementwise to 3e-2, the bound
    of test_plain_matches_pallas_bwd_bf16.  dQ and dK take dS through Dsum =
    dO . O from the bf16-rounded O, which moves Dsum by about one bf16 ulp of
    O against the TPU kernel's sum P dP; that flips dS's bf16 rounding here
    and there, and the flips add up over 1024 keys to a few bf16 ulps on a
    few elements of dQ.  They are held, as chip_smoke.py holds the kernel,
    to 1e-2 relative (Frobenius)."""
    monkeypatch.setattr(JA, "_INTERPRET", True)
    q, k, v, g = _inputs((2, 2, 1024, 64), (2, 2, 1024, 64), seed=kv_len + causal + 7)
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g))
    ref = JA._attention_bwd_pallas(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                     for t in (tq, tk, tv, tg)), kv_len, causal)
    o = A.attention_plain(tq, tk, tv, kv_len, causal)
    lse = A.attention_lse_plain(tq, tk, kv_len, causal)
    got = A.attention_bwd_lse_plain(tq, tk, tv, o, lse, tg, kv_len, causal)
    ref = [np.asarray(b, np.float32) for b in ref]
    assert all(a.dtype == torch.bfloat16 for a in got)
    np.testing.assert_allclose(got[2].float().numpy(), ref[2], atol=3e-2, rtol=3e-2)
    for a, b in zip(got[:2], ref[:2]):
        rel = np.linalg.norm(a.float().numpy() - b) / np.linalg.norm(b)
        assert rel <= 1e-2, rel
    assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()


@pytest.mark.parametrize("sq,skv,kv_len,causal", XLA_CASES)
def test_lse_bwd_plain_matches_xla_vjp_f32(sq, skv, kv_len, causal):
    """f32, within 1e-4 (the bound of test_plain_matches_xla_vjp_f32): in f32
    the identity sum_k P dP = dO . O holds to rounding."""
    q, k, v, g = _inputs((1, 2, sq, 64), (1, 2, skv, 64), seed=sq + skv)
    _, vjp = jax.vjp(lambda q_, k_, v_: JA._attention_xla(q_, k_, v_, kv_len, causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o = A.attention_plain(tq, tk, tv, kv_len, causal)
    lse = A.attention_lse_plain(tq, tk, kv_len, causal)
    got = A.attention_bwd_lse_plain(tq, tk, tv, o, lse, tg, kv_len, causal)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("given", [False, True])
def test_bwd_kernel_with_forward_stats_rejects_cpu_tensors(given):
    """With O and the log-sum-exp given or not, the K9 wrapper raises on CPU
    tensors before any launch, K1's or K9's."""
    q = torch.zeros((1, 1, 64, 64), dtype=torch.bfloat16)
    stats = dict(o=q, lse=torch.zeros((1, 1, 64))) if given else {}
    before = (A.launches, sum(A.launches_bwd.values()))
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_bwd_kernel(q, q, q, q, 64, False, **stats)
    assert (A.launches, sum(A.launches_bwd.values())) == before


def test_attention_kernel_lse_rejects_cpu_tensors():
    q = torch.zeros((1, 1, 64, 64), dtype=torch.bfloat16)
    before = A.launches
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_kernel(q, q, q, 64, True, return_lse=True)
    assert A.launches == before
