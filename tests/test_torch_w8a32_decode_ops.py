"""K10's W8A32 case (the per-op step of the int8 copy of an f32 model): f32
queries against int8 cross K/V with f32 (B, H, S) scales.

The port's plain version (``decode_ops.cross_attention_decode_plain``: the
scores times the key's scale before the mask, the probabilities times the
value's scale before the PV product, all in f32) vs the JAX package's
``decode_ops.cross_attention_decode`` on the same numpy draws, within 1e-5
(rtol and atol), at T=11 and at T=20 (past one launch's 16 rows), with
keys past kv_len masked.  On CPU tensors the dispatching wrapper runs the
plain version and counts no launch; the kernel entry points refuse CPU
tensors, as do K2's W8A32 mode and the W8A32 verification entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_int8_decode import _quantized
from whisper_medusa_tpu.ops import decode_ops as jdo
from whisper_medusa_tpu_torch.ops import decode_ops as tdo
from whisper_medusa_tpu_torch.ops import megastep as tmegastep
from whisper_medusa_tpu_torch.ops import qmm as tqmm
from whisper_medusa_tpu_torch.ops import verify as tverify

B, H, S, KV_LEN = 2, 3, 600, 571


def _inputs(seed, t):
    """f32 q (B, H, T, 64) pre-scaled; int8 K (B, H, 64, S) and V (B, S,
    H * 64) quantized per (head, position) with their f32 (B, H, S) scales,
    as init_cache quantizes them."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, t, 64)) * 0.125).astype(np.float32)
    k = rng.standard_normal((B, H, 64, S)).astype(np.float32)
    v = rng.standard_normal((B, S, H, 64)).astype(np.float32)
    kq, ks = tqmm.quantize_array(torch.from_numpy(k), axis=2)
    vq, vs = tqmm.quantize_array(torch.from_numpy(v), axis=-1)
    return torch.from_numpy(q), kq, vq.reshape(B, S, H * 64), ks, vs.permute(0, 2, 1).contiguous()


@pytest.mark.parametrize("t", [11, 20])
def test_cross_decode_w8a32_matches_jax(t):
    q, k, v, ks, vs = _inputs(t, t)
    assert q.dtype == ks.dtype == vs.dtype == torch.float32 and k.dtype == torch.int8
    j = lambda a: jnp.asarray(a.numpy())
    ref = jdo.cross_attention_decode(j(q), j(k), j(v), KV_LEN, j(ks), j(vs))
    before = tdo.w8a32_cross_launches
    got = tdo.cross_attention_decode(q, k, v, KV_LEN, ks, vs)
    assert got.dtype == torch.float32 and tdo.w8a32_cross_launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_w8a32_kernels_refuse_cpu_tensors():
    q, k, v, ks, vs = _inputs(3, 11)
    with pytest.raises(ValueError, match="CUDA"):
        tdo.cross_attention_decode_kernel(q, k, v, KV_LEN, ks, vs)
    rows = q.reshape(-1, 64)[:8].contiguous()
    emb = {"q": torch.zeros((128, 64), dtype=torch.int8), "s": torch.ones(128)}
    with pytest.raises(ValueError, match="CUDA"):
        tverify.head_rows_kernel(rows, {"q": emb["q"][:64].reshape(1, 64, 64),
                                        "s": torch.ones((1, 64))}, torch.zeros((1, 64)))
    meta = (torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
            torch.zeros((2, 128), dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA"):
        tverify.verify_rows_kernel(rows, emb, *meta, begin_index=0, eos_id=1, decay=None)


def test_k2_w8a32_refuses_cpu_tensors():
    """K2's W8A32 mode (f32 rows, int8 streamed weights) raises on CPU
    tensors instead of running its plain version; the dispatching
    ``fused_decoder_layers`` takes the plain version and counts nothing."""
    dims, _, tq, rng = _quantized(jnp.float32, 5)
    dec = tq["decoder"]
    nl, d, nh, s_len, s_enc = 2, dims.d_model, dims.decoder_attention_heads, 48, 32
    x = torch.from_numpy(rng.standard_normal((1, 3, d)).astype(np.float32))
    i8 = lambda *shape: torch.zeros(shape, dtype=torch.int8)
    caches = (i8(nl, 1, s_len, d), i8(nl, 1, s_len, d), i8(nl, 1, nh, 64, s_enc),
              i8(nl, 1, s_enc, d))
    kw = dict(cross_k_s=torch.ones((nl, 1, nh, s_enc)), cross_v_s=torch.ones((nl, 1, nh, s_enc)),
              self_s=torch.ones((nl, 1, s_len, 2 * nh), dtype=torch.bfloat16))
    offsets = torch.zeros((1,), dtype=torch.int32)
    assert tmegastep.is_w8a32(dec["layers"], x)
    before = tmegastep.w8a32_launches
    with pytest.raises(ValueError, match="CUDA"):
        tmegastep.megastep_kernel(dec["layers"], dec["ln_post"], x, *caches, offsets, None,
                                  s_enc, nh, **kw)
    out = tmegastep.fused_decoder_layers(dec["layers"], dec["ln_post"], x, *caches, offsets,
                                         None, s_enc, nh, **kw)
    assert out[1].dtype == torch.float32 and tmegastep.w8a32_launches == before

