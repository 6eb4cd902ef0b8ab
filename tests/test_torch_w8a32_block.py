"""K2's W8A32 block mode: the Medusa-Block layer as layer L of the int8
copy of an f32 model, the port's plain version vs the JAX megastep kernel
in interpret mode (its block grid layer, ``extend_layers_with_block``).

The setup of test_torch_w8a32_megastep.py, with a block layer perturbed
from a fresh init and quantized by the JAX ``quantize_decoder``: a 5-token
prefill through the JAX scan, then a 4-token chunk at offset 5 through both
kernels' routes.  hidden, pre_norm and block_hidden within 1e-5 (rtol and
atol); the rows written in every slot, the block's slot L included, within
one int8 step and their scales within one bf16 ulp.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from tests.test_torch_int8_decode import _port_cache, _quantized
from tests.test_torch_megastep import MAX_LEN, _np
from tests.test_torch_w8a32_megastep import (TOL, _check_rows, _port_step, _scan_history,
                                             k2_route)  # noqa: F401
from whisper_medusa_tpu.config import MedusaConfig
from whisper_medusa_tpu.models import medusa as jmedusa
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu.ops import megastep as jmegastep
from whisper_medusa_tpu.ops import qmm as jqmm
from whisper_medusa_tpu_torch.models import bridge


@functools.lru_cache(maxsize=None)
def _block_setup():
    dims, wq, _, rng = _quantized(jnp.float32, 4)
    wp = jw.init_whisper_params(jax.random.PRNGKey(4), dims, jnp.float32)
    mc = MedusaConfig(medusa_num_heads=2, medusa_hidden_size=dims.d_model,
                      medusa_heads_type="medusa_block", medusa_choices=(1, 1, 1))
    mp = jmedusa.init_medusa_params(jax.random.PRNGKey(7), dims, mc, wp, jnp.float32)
    block = jax.tree.map(
        lambda a: (a + (0.05 if a.ndim < 2 else 0.02) * rng.standard_normal(a.shape)
                   ).astype(np.float32), mp["block"])
    _, mq = jqmm.quantize_decoder(wp, {"block": block})
    block = mq["block"]
    tb = bridge.params_from_numpy(jax.tree.map(np.asarray, block), device="cpu")
    return dims, wq, block, tb, rng


def test_w8a32_block_step_matches_jax_megastep():
    dims, wq, block, tb, rng = _block_setup()
    _, _, tq, _ = _quantized(jnp.float32, 4)
    nh, nl = dims.decoder_attention_heads, dims.decoder_layers
    enc = jnp.asarray(rng.standard_normal((1, 32, dims.d_model)), jnp.float32)
    cache = jw.set_block_cross_kv(jw.init_cache(wq, dims, enc, MAX_LEN, extra_layers=1),
                                  block, enc, nh)
    ext = jw.extend_layers_with_block(wq["decoder"]["layers"], block)
    kw = dict(block_params=block, fused_block_layers=ext)
    assert jmegastep.available(ext, dims.d_model, nh, 1, 4, True, 1)
    cache = _scan_history(wq, dims, cache, 1, 5, rng, **kw)
    tcache = _port_cache(cache, nh)
    tokens = rng.integers(0, 255, (1, 4)).astype(np.int32)
    offsets = np.full((1,), 5, np.int32)
    out_j, cache_j = jw.decode_step(wq, dims, jnp.asarray(tokens), cache,
                                    jnp.asarray(offsets), **kw)
    out_t = _port_step(tq, dims, tokens, tcache, offsets, block=tb)
    for name in ("hidden", "pre_norm", "block_hidden"):
        np.testing.assert_allclose(_np(getattr(out_t, name)),
                                   np.asarray(getattr(out_j, name), np.float32),
                                   rtol=TOL, atol=TOL, err_msg=name)
    _check_rows(cache_j, tcache, nh, [5], 4, slice(0, nl + 1))
