"""The pieced prefill (decoding/speculative.py::prefill): a prompt longer than
16 tokens runs through ``whisper.decode_step`` in pieces of at most 16, each
causal over itself and seeing the earlier pieces through the cache, so that
every piece is a call K2 (T <= 16) or the per-op step's mask mode (T <= 32)
takes on the card.

A 40- and a 70-token prompt at B = 2, with and without the Medusa-Block
layer: the last piece's hidden (and block) rows and every self-cache row
written equal a one-pass plain prefill of the whole prompt within 1e-5 in
f32 on the CPU, and the last hidden row equals the JAX package's one-pass
``decode_step``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.models import whisper as jwhisper
from whisper_medusa_tpu.models.api import WhisperMedusaModel as JModel
from whisper_medusa_tpu_torch.decoding import speculative as tspec
from whisper_medusa_tpu_torch.models import bridge, whisper


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(vocab_size=256, medusa_heads_type="medusa_block",
                           max_target_positions=96)
    jm = JModel.from_random(cfg, seed=4)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu")
    return jm, tp


def _cache(wp, dims, enc, block):
    cache = whisper.init_cache(wp, dims, enc, 90, extra_layers=int(block is not None))
    if block is not None:
        whisper.set_block_cross_kv(cache, block, enc, dims.decoder_attention_heads)
    return cache


@pytest.mark.parametrize("with_block", [False, True], ids=["base", "block"])
@pytest.mark.parametrize("t0", [40, 70])
def test_pieced_prefill_matches_one_pass(model, t0, with_block):
    jm, tp = model
    dims = jm.config.dims
    wp = tp["whisper"]
    block = tp["medusa"]["block"] if with_block else None
    rng = np.random.default_rng(t0)
    enc = torch.from_numpy(rng.standard_normal((2, 32, dims.d_model)).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, dims.vocab_size, (2, t0)).astype(np.int32))

    pieced = _cache(wp, dims, enc, block)
    out = tspec.prefill(wp, dims, prompt, pieced, block)
    one = _cache(wp, dims, enc, block)
    ref = whisper.decode_step(wp, dims, prompt, one, torch.zeros(2, dtype=torch.int32),
                              block=block)
    last = t0 - (t0 - 1) // tspec.PREFILL_PIECE * tspec.PREFILL_PIECE
    assert out.hidden.shape[1] == last
    torch.testing.assert_close(out.hidden, ref.hidden[:, -last:], rtol=1e-5, atol=1e-5)
    if with_block:
        torch.testing.assert_close(out.block_hidden, ref.block_hidden[:, -last:],
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pieced.self_k[:, :, :t0], one.self_k[:, :, :t0],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pieced.self_v[:, :, :t0], one.self_v[:, :, :t0],
                               rtol=1e-5, atol=1e-5)
    assert not pieced.self_k[:, :, t0:].any() and not pieced.self_v[:, :, t0:].any()

    jcache = jwhisper.init_cache(jm.params["whisper"], dims, jnp.asarray(enc.numpy()), 90)
    jout, _ = jwhisper.decode_step(jm.params["whisper"], dims, jnp.asarray(prompt.numpy()),
                                   jcache, jnp.zeros((2,), jnp.int32))
    if not with_block:
        np.testing.assert_allclose(out.hidden[:, -1].numpy(),
                                   np.asarray(jout.hidden[:, -1]), rtol=1e-5, atol=1e-5)
