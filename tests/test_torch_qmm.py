"""Port ops/qmm.py (plain versions of kernels K6 and K7, and the int8
quantization) vs whisper_medusa_tpu/ops/qmm.py.

quantize_array and quantize_decoder (with heads) are bit-equal to the JAX
functions.  qmm_plain / qmm_nt_plain match the JAX ``qmm`` / ``qmm_nt``
Pallas kernels in interpret mode and their XLA references at the shapes of
tests/test_quantized.py and at a ragged N, within 1e-3 of max |y|: both take
bf16 operands and f32 sums, in another order.  The bridge keeps int8 and f32
leaves when it casts a tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.models import medusa as jmedusa
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu.ops import qmm as jqmm
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.ops import qmm as tqmm


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_array_is_bit_equal(axis):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 64, 96)) * 0.05).astype(np.float32)
    w[1, :, 5] = 0.0                      # an all-zero column: scale 1.0
    w[2, 7, :] = 0.0
    jq, js = jqmm.quantize_array(jnp.asarray(w), axis=axis)
    tq, ts = tqmm.quantize_array(_t(w), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _jax_model(dtype):
    cfg = tiny_test_config(medusa_num_heads=3)
    r1, r2 = jax.random.split(jax.random.PRNGKey(3))
    wp = jw.init_whisper_params(r1, cfg.dims, dtype)
    mp = jmedusa.init_medusa_params(r2, cfg.dims, cfg.medusa, wp, dtype)
    mp["heads"]["w"] = (jax.random.normal(r2, mp["heads"]["w"].shape) * 0.05).astype(dtype)
    return wp, mp


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quantize_decoder_routes_are_bit_equal(dtype):
    """The JAX-quantized tree bridged into the port, and the port's own
    quantize_decoder of the bridged tree, hold the same tensors."""
    wp, mp = _jax_model(dtype)
    jwq, jmq = jqmm.quantize_decoder(wp, mp)
    tree = jax.tree.map(np.asarray, {"whisper": jwq, "medusa": jmq})
    via_jax = bridge.params_from_numpy(tree, device="cpu")
    plain = bridge.params_from_numpy(jax.tree.map(np.asarray, {"whisper": wp, "medusa": mp}),
                                     device="cpu")
    twq, tmq = tqmm.quantize_decoder(plain["whisper"], plain["medusa"])
    ours = {"whisper": twq, "medusa": tmq}
    a, b = dict(_leaves(via_jax)), dict(_leaves(ours))
    assert a.keys() == b.keys()
    assert b["whisper/decoder/embed_tokens/s"].shape == (wp["decoder"]["embed_tokens"].shape[0],)
    assert b["medusa/heads/w/s"].shape == mp["heads"]["w"].shape[:3]
    assert b["whisper/decoder/layers/fc1_w/q"].dtype == torch.int8
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)


def test_quantize_decoder_leaves_block_to_item_9():
    """Item 9 (Medusa-Block) is done: the block layer is quantized like a
    decoder layer, bit-equal to the JAX quantize_decoder, and once only."""
    cfg = tiny_test_config(medusa_num_heads=3, medusa_heads_type="medusa_block")
    r1, r2 = jax.random.split(jax.random.PRNGKey(4))
    wp = jw.init_whisper_params(r1, cfg.dims, jnp.float32)
    mp = jmedusa.init_medusa_params(r2, cfg.dims, cfg.medusa, wp, jnp.float32)
    _, jmq = jqmm.quantize_decoder(wp, mp)
    plain = bridge.params_from_numpy(jax.tree.map(np.asarray, {"whisper": wp, "medusa": mp}),
                                     device="cpu")
    _, tmq = tqmm.quantize_decoder(plain["whisper"], plain["medusa"])
    a = dict(_leaves(bridge.params_from_numpy(jax.tree.map(np.asarray, jmq), device="cpu")))
    b = dict(_leaves(tmq))
    assert a.keys() == b.keys() and b["block/fc1_w/q"].dtype == torch.int8
    assert b["block/fc1_w/s"].shape == (cfg.dims.decoder_ffn_dim,)
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)
    _, again = tqmm.quantize_decoder(plain["whisper"], tmq)
    assert all(x is y for (_, x), (_, y) in zip(_leaves(again), _leaves(tmq)))


@pytest.mark.parametrize("n", [640, 1000 + 25])
@pytest.mark.parametrize("nt", [False, True], ids=["qmm", "qmm_nt"])
def test_qmm_plain_matches_jax(nt, n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    if nt:
        w = (rng.standard_normal((n, 128)) * 0.1).astype(np.float32)
        wq, s = jqmm.quantize_array(jnp.asarray(w), axis=-1)
        refs = [jqmm.qmm_nt(xb, wq, s, block_n=256, interpret=True),
                jqmm.qmm_nt_ref(xb, wq, s)]
        got = tqmm.qmm_nt(_t(np.asarray(xb.astype(jnp.float32))), _t(wq), _t(s))
    else:
        w = (rng.standard_normal((128, n)) * 0.1).astype(np.float32)
        wq, s = jqmm.quantize_array(jnp.asarray(w), axis=-2)
        refs = [jqmm.qmm(xb, wq, s, block_n=256, interpret=True),
                jqmm.qmm_ref(xb, wq, s)]
        got = tqmm.qmm(_t(np.asarray(xb.astype(jnp.float32))), _t(wq), _t(s))
    assert got.dtype == torch.float32 and got.shape == (16, n)
    assert tqmm.launches == 0 and tqmm.nt_launches == 0
    for ref in refs:
        ref = np.asarray(ref)
        tol = 1e-3 * float(np.abs(ref).max())
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


def test_qmm_rounds_its_input_to_bf16():
    """Both wrappers take bf16(x), as the JAX functions do."""
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((4, 64)).astype(np.float32))
    wq = _t(rng.integers(-127, 128, (64, 32)).astype(np.int8))
    s = _t(rng.random(32).astype(np.float32))
    xb = x.bfloat16().float()
    torch.testing.assert_close(tqmm.qmm(x, wq, s), tqmm.qmm(xb, wq, s), rtol=0, atol=0)
    torch.testing.assert_close(tqmm.qmm_nt(x, wq.T.contiguous(), s),
                               tqmm.qmm_nt(xb, wq.T.contiguous(), s), rtol=0, atol=0)


def test_bridge_keeps_int8_and_scale_dtypes():
    tree = {"a": np.ones((2, 3), np.float32),
            "w": {"q": np.ones((3, 4), np.int8), "s": np.full((4,), 0.5, np.float32)},
            "n": np.arange(3, dtype=np.int32)}
    out = bridge.params_from_numpy(tree, device="cpu", dtype="bfloat16")
    assert out["a"].dtype == torch.bfloat16
    assert out["w"]["q"].dtype == torch.int8 and out["w"]["s"].dtype == torch.float32
    assert out["n"].dtype == torch.int32
    torch.testing.assert_close(out["w"]["s"], torch.full((4,), 0.5))
