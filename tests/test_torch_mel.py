"""The log-mel frontend: K8's plain version (ops/mel.py::log_mel_plain +
normalize_log_mel, what ops/mel_fused.py runs on CPU tensors) and the
processor with ``use_kernel=True`` against the JAX Pallas kernel
``log_mel_spectrogram_pallas`` in interpret mode, at B=2 and n_mels 80 and
128, within 1e-3 (the JAX package's own bar for its kernel against the jnp
path, tests/test_mel.py); the default path against the JAX
``log_mel_spectrogram`` within 1e-3; resampling against the JAX function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.data.dataset import resample as jresample
from whisper_medusa_tpu.ops import mel as jmel
from whisper_medusa_tpu.ops.mel_pallas import log_mel_spectrogram_pallas
from whisper_medusa_tpu_torch.data.audio import resample as tresample
from whisper_medusa_tpu_torch.ops import mel as tmel
from whisper_medusa_tpu_torch.ops import mel_fused
from whisper_medusa_tpu_torch.processor import WhisperMedusaProcessor as TProcessor


def _audio(seed=2):
    """Two 30 s examples: noise, and a tone that stops at 11 s (a zero tail,
    as pad_or_trim gives a short utterance)."""
    rng = np.random.default_rng(seed)
    wav = (0.1 * rng.standard_normal((2, tmel.N_SAMPLES))).astype(np.float32)
    t = np.arange(16000 * 11) / 16000.0
    wav[1] = 0.0
    wav[1, :t.size] = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    return wav


@pytest.mark.parametrize("n_mels", [80, 128])
def test_fused_plain_matches_jax_pallas_interpret(n_mels):
    wav = _audio()
    ref = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(wav), n_mels=n_mels,
                                                interpret=True))
    got = mel_fused.log_mel_spectrogram_fused(torch.from_numpy(wav), n_mels=n_mels)
    assert got.shape == ref.shape == (2, n_mels, 3000) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() < 1e-3
    assert mel_fused.launches == 0
    # The processor's kernel path on a CPU processor is the same plain version.
    proc = TProcessor(device="cpu", n_mels=n_mels, use_kernel=True)
    np.testing.assert_array_equal(proc([w for w in wav]).numpy(), got.numpy())


def test_default_path_matches_jax():
    """The split of ops/mel.py moved nothing: the default frontend is
    normalize_log_mel(log_mel_plain(...)) and still matches the JAX one."""
    wav = _audio(3)
    x = torch.from_numpy(wav)
    got = tmel.log_mel_spectrogram(x)
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wav)))
    assert np.abs(got.numpy() - ref).max() < 1e-3
    torch.testing.assert_close(got, tmel.normalize_log_mel(tmel.log_mel_plain(x)),
                               rtol=0, atol=0)
    assert not TProcessor(device="cpu").use_kernel
    np.testing.assert_array_equal(TProcessor(device="cpu")(wav[0]).numpy(), got[:1].numpy())


@pytest.mark.parametrize("sr", [8000, 44100])
def test_resample_matches_jax(sr):
    rng = np.random.default_rng(sr)
    wav = (0.2 * rng.standard_normal(int(2.5 * sr))).astype(np.float32)
    got = tresample(wav, sr)
    np.testing.assert_array_equal(got, jresample(wav, sr))
    assert got.dtype == np.float32 and abs(got.size - 40000) <= 1
    np.testing.assert_array_equal(tresample(wav, 16000), wav)
