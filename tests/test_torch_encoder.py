"""Port encoder and log-mel frontend vs the JAX package.

encode: tiny dims, f32 against the JAX XLA path (1e-4) and bf16 (3e-2).
Frontend: the matmul-DFT log-mel vs log_mel_spectrogram_np (1e-4 after the
log) and the JAX processor.  Blocks (GELU, conv stem, positions, layernorm)
at f32, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.config import tiny_test_config
from whisper_medusa_tpu.models import whisper as jw
from whisper_medusa_tpu.ops import gelu as jgelu
from whisper_medusa_tpu.ops import mel as jmel
from whisper_medusa_tpu.processor import WhisperMedusaProcessor as JProcessor
from whisper_medusa_tpu_torch.models import bridge
from whisper_medusa_tpu_torch.models import whisper as tw
from whisper_medusa_tpu_torch.ops import gelu as tgelu
from whisper_medusa_tpu_torch.ops import mel as tmel
from whisper_medusa_tpu_torch.processor import WhisperMedusaProcessor as TProcessor


def _params(dtype, seed=0):
    dims = tiny_test_config().dims
    wp = jw.init_whisper_params(jax.random.PRNGKey(seed), dims, dtype)
    rng = np.random.default_rng(seed)
    # Nonzero biases and layernorms (they initialize to 0 / 1).
    wp["encoder"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(dtype)
        if a.ndim <= 2 else a, wp["encoder"])
    return dims, wp, bridge.params_from_numpy(jax.tree.map(np.asarray, wp), device="cpu")


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-4), (jnp.bfloat16, 3e-2)])
def test_encode_matches_jax(dtype, tol):
    dims, wp, tp = _params(dtype)
    mel = np.random.default_rng(1).standard_normal(
        (2, dims.num_mel_bins, dims.num_frames)).astype(np.float32)
    ref = np.asarray(jw.encode(wp, dims, jnp.asarray(mel)), np.float32)
    got = tw.encode(tp, dims, torch.from_numpy(mel))
    assert got.shape == (2, dims.max_source_positions, dims.d_model)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_stem_matches_jax(stride):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5, 7)).astype(np.float32)
    b = rng.standard_normal((7,)).astype(np.float32)
    ref = np.asarray(jw.conv1d_stem(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride))
    got = tw.conv1d_stem(*(torch.from_numpy(a) for a in (x, w, b)), stride)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_blocks_match_jax():
    x = np.random.default_rng(3).standard_normal((4, 64)).astype(np.float32) * 3
    np.testing.assert_allclose(tgelu.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jgelu.gelu(jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(tw.sinusoidal_positions(50, 64).numpy(),
                               np.asarray(jw.sinusoidal_positions(50, 64)), atol=1e-5)
    s, b = np.linspace(0.5, 1.5, 64, dtype=np.float32), np.linspace(-1, 1, 64, dtype=np.float32)
    np.testing.assert_allclose(
        tw.layer_norm(*(torch.from_numpy(a) for a in (x, s, b))).numpy(),
        np.asarray(jw.layer_norm(*(jnp.asarray(a) for a in (x, s, b)))), atol=1e-5)


def test_log_mel_matches_numpy_reference():
    rng = np.random.default_rng(4)
    audio = (0.1 * rng.standard_normal((2, 16000 * 3))).astype(np.float32)
    ref = jmel.log_mel_spectrogram_np(audio)
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio))
    assert got.shape == ref.shape == (2, 80, 300)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tmel.mel_filter_bank(), jmel.mel_filter_bank(), atol=0)


def test_processor_matches_jax_processor():
    wave = (0.2 * np.sin(np.arange(16000 * 2) / 7.0)).astype(np.float32)
    ref = np.asarray(JProcessor()(wave))
    got = TProcessor(device="cpu")(wave)
    assert got.shape == (1, 80, 3000) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tmel.pad_or_trim(wave), jmel.pad_or_trim(wave))
    # Audio at another rate is resampled on the host, as the JAX processor does.
    np.testing.assert_allclose(TProcessor(device="cpu")(wave, sampling_rate=8000).numpy(),
                               np.asarray(JProcessor()(wave, sampling_rate=8000)),
                               rtol=1e-4, atol=1e-4)


def test_processor_batches_waveforms_like_jax():
    """A list of up to 8 waveforms of different lengths (one over 30 s) gives
    one (B, 80, 3000) batch, row for row the JAX processor's."""
    rng = np.random.default_rng(8)
    waves = [(0.1 * rng.standard_normal(int(16000 * s))).astype(np.float32)
             for s in (1.5, 4.0, 12.25, 29.9, 31.0, 0.5, 7.0, 20.0)]
    ref = np.asarray(JProcessor()(waves))
    got = TProcessor(device="cpu")(waves)
    assert got.shape == (8, 80, 3000) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[2:3].numpy(), TProcessor(device="cpu")(waves[2]).numpy())
