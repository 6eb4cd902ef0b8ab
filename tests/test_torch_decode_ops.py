"""Plain versions of K10 (decode cross-attention) and K11 (decode FFN) vs the
TPU kernels they replace and the JAX scan path's functions.

The TPU kernels are ``tools/decode_kernels_experiment.py``'s ``_cross_pallas``
and ``_ffn_pallas``, imported by path and run in Pallas interpret mode
(``_INTERPRET`` True, ``_FFN_BLOCK`` 256, as the module's own self-test runs
them); the JAX functions are ``whisper_medusa_tpu/ops/decode_ops.py``.  Inputs
are numpy draws from fixed seeds.  Tolerances, each stated where it is used:
f32 cross-attention 1e-5 (the self-test's bar); bf16 one bf16 step (1e-2);
the FFN against the TPU kernel 5e-4 (its A&S 7.1.26 erf against the exact
erf, ROADMAP R3, the self-test's bar) and against the JAX function 1e-5.
On CPU tensors the dispatching wrappers run the plain versions; the kernel
entry points refuse them.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.ops import decode_ops as jdo
from whisper_medusa_tpu_torch.ops import decode_ops as tdo
from whisper_medusa_tpu_torch.ops import qmm as tqmm

_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools", "decode_kernels_experiment.py")


@pytest.fixture(scope="module")
def experiment():
    spec = importlib.util.spec_from_file_location("decode_kernels_experiment", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(experiment, monkeypatch):
    monkeypatch.setattr(experiment, "_INTERPRET", True)
    monkeypatch.setattr(experiment, "_FFN_BLOCK", 256)
    return experiment


def _cross_inputs(seed, dtype=np.float32):
    """The self-test's shapes: q (2, 4, 11, 64), 640 keys, kv_len 600."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, 4, 11, 64)).astype(dtype)
    k = rng.normal(size=(2, 4, 64, 640)).astype(dtype)
    v = rng.normal(size=(2, 640, 4 * 64)).astype(dtype)
    return q, k, v


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def test_cross_plain_matches_tpu_kernel_f32(interpret):
    q, k, v = _cross_inputs(0)
    got = tdo.cross_attention_decode_plain(_torch(q), _torch(k), _torch(v), 600)
    ref = interpret._cross_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 600)
    # f32: the self-test's 1e-5.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_len", [640, 600])
def test_cross_plain_matches_tpu_kernel_bf16(interpret, kv_len):
    q, k, v = _cross_inputs(1)
    q = 0.25 * q
    bf = jnp.bfloat16
    ref = interpret._cross_pallas(jnp.asarray(q, bf), jnp.asarray(k, bf),
                                  jnp.asarray(v, bf), kv_len)
    ref = np.asarray(ref.astype(jnp.float32))
    args = [_torch(np.asarray(jnp.asarray(a, bf).astype(jnp.float32)), torch.bfloat16)
            for a in (q, k, v)]
    got = tdo.cross_attention_decode_plain(*args, kv_len)
    assert got.dtype == torch.bfloat16
    # Both round P to bf16 before the PV product and the output once; the
    # score sums run in another order, so a value may land one bf16 step
    # (2^-7 relative) away.
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_plain_int8_matches_jax(dtype):
    """int8 K/V with f32 (B, H, S) scales: scores times k_s before the
    softmax, probabilities times v_s before the PV product."""
    rng = np.random.default_rng(2)
    q = 0.05 * rng.normal(size=(2, 4, 11, 64))
    k = rng.integers(-127, 128, size=(2, 4, 64, 640)).astype(np.int8)
    v = rng.integers(-127, 128, size=(2, 640, 256)).astype(np.int8)
    ks = (0.004 + 0.012 * rng.random((2, 4, 640))).astype(np.float32)
    vs = (0.004 + 0.012 * rng.random((2, 4, 640))).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    qj = jnp.asarray(q, jdt)
    ref = jdo.cross_attention_decode(qj, jnp.asarray(k), jnp.asarray(v), 600,
                                     jnp.asarray(ks), jnp.asarray(vs))
    ref = np.asarray(ref.astype(jnp.float32))
    qt = _torch(np.asarray(qj.astype(jnp.float32)), tdt)
    got = tdo.cross_attention_decode_plain(qt, torch.from_numpy(k), torch.from_numpy(v),
                                           600, torch.from_numpy(ks), torch.from_numpy(vs))
    # f32 1e-5; bf16 one bf16 step.
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=tol)


def _ffn_inputs(seed):
    """The self-test's shapes: x (11, 128), F = 1024."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(11, 128)).astype(np.float32)
    w1 = (rng.normal(size=(128, 1024)) * 0.05).astype(np.float32)
    b1 = rng.normal(size=(1024,)).astype(np.float32)
    w2 = (rng.normal(size=(1024, 128)) * 0.05).astype(np.float32)
    b2 = rng.normal(size=(128,)).astype(np.float32)
    return x, w1, b1, w2, b2


def test_ffn_plain_matches_tpu_kernel(interpret):
    args = _ffn_inputs(3)
    ref = interpret._ffn_pallas(*[jnp.asarray(a) for a in args])
    got = tdo.ffn_decode_plain(*[torch.from_numpy(a) for a in args])
    # The TPU kernel's A&S 7.1.26 erf is 1.5e-7 off the exact erf, up to
    # ~3e-4 after the 1024-wide fc2 sum: the self-test's 5e-4.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4, rtol=5e-4)


def test_ffn_plain_matches_jax_f32():
    x, w1, b1, w2, b2 = _ffn_inputs(4)
    ref = jdo.ffn_decode(jnp.asarray(x)[None], *[jnp.asarray(a) for a in (w1, b1, w2, b2)])
    got = tdo.ffn_decode_plain(torch.from_numpy(x)[None],
                               *[torch.from_numpy(a) for a in (w1, b1, w2, b2)])
    # f32: exact products and f32 sums on both sides; 1e-5.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_ffn_plain_int8_weights_dequantize():
    """int8 weights ({"q", "s"}) run as x @ (q * s): the plain version that K2
    is held against on the card."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _ffn_inputs(5))
    q1, s1 = tqmm.quantize_array(w1)
    q2, s2 = tqmm.quantize_array(w2)
    got = tdo.ffn_decode_plain(x, {"q": q1, "s": s1}, b1, {"q": q2, "s": s2}, b2)
    xb = x.to(torch.bfloat16).float()
    h = torch.nn.functional.gelu((xb @ q1.float()) * s1 + b1)
    ref = (h.to(torch.bfloat16).float() @ q2.float()) * s2 + b2
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_wrappers_take_plain_versions_on_cpu_and_kernels_refuse_cpu():
    q, k, v = (_torch(a) for a in _cross_inputs(6))
    before = (tdo.cross_launches, tdo.q_cross_launches, tdo.ffn_launches)
    torch.testing.assert_close(tdo.cross_attention_decode(q, k, v, 600),
                               tdo.cross_attention_decode_plain(q, k, v, 600),
                               rtol=0, atol=0)
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _ffn_inputs(7))
    torch.testing.assert_close(tdo.ffn_decode(x[None], w1, b1, w2, b2),
                               tdo.ffn_decode_plain(x[None], w1, b1, w2, b2),
                               rtol=0, atol=0)
    assert (tdo.cross_launches, tdo.q_cross_launches, tdo.ffn_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tdo.cross_attention_decode_kernel(q.bfloat16(), k.bfloat16(), v.bfloat16(), 600)
    with pytest.raises(ValueError, match="CUDA"):
        tdo.ffn_decode_kernel(x.bfloat16(), w1.bfloat16(), b1.bfloat16(), w2.bfloat16(),
                              b2.bfloat16())
    assert (tdo.cross_launches, tdo.q_cross_launches, tdo.ffn_launches) == before
