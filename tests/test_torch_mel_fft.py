"""K8's factored DFT and sparse filter bank, emulated on the CPU from the
very tables the wrapper hands the kernel (``ops/mel.py::fft_mel_tables`` /
``device_fft_tables``).

The emulation runs the kernel's two stages in float32 torch: for each n2 a
20-point DFT over n1 of the windowed samples x[20 n1 + n2] (the 11
non-redundant outputs, the other 9 their conjugates), then each of bins
0..200 as sum_n2 Y_n2[k % 20] * twiddle[(n2 k) % 400], the power, each mel
over its nonzero bins, log10(max(mel, 1e-10)).  It is held against the plain
version ``log_mel_plain`` (raw log10 within 1e-4 wherever the mel energy is
above 1e-8 and above 1e-6 of its frame's largest, the float32 DFT's rounding
floor; beneath it both approach the clamp through cancellation) and a
float64 DFT at the same bar, and, normalized, against the JAX
``log_mel_spectrogram`` and the Pallas kernel in interpret mode within 1e-3
(the JAX package's bar for its kernel, tests/test_mel.py), at 80 and 128
mels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.ops import mel as jmel
from whisper_medusa_tpu.ops.mel_pallas import log_mel_spectrogram_pallas
from whisper_medusa_tpu_torch.ops import mel as tmel


def _audio(seed):
    """Two 30 s examples: noise, and a chirp that stops at 9 s (a zero
    tail, as pad_or_trim gives a short utterance)."""
    rng = np.random.default_rng(seed)
    wav = (0.1 * rng.standard_normal((2, tmel.N_SAMPLES))).astype(np.float32)
    t = np.arange(16000 * 9) / 16000.0
    wav[1] = 0.0
    wav[1, :t.size] = 0.4 * np.sin(2 * np.pi * (200 + 300 * t) * t)
    return wav


def emulate_k8(audio: torch.Tensor, tab) -> torch.Tensor:
    """(B, N) f32 -> (B, N // 160, n_mels) log10 mel, K8's stages in f32."""
    r = tmel.FFT_R
    frames = tmel.frame_audio(audio.float()) * tab["window"]       # (B, F, 400)
    x = frames.reshape(*frames.shape[:2], r, r)                     # [n1][n2]
    c20, s20 = tab["dft20"]
    idx = (torch.arange(r)[:, None] * torch.arange(r // 2 + 1)[None]) % r   # (n1, k1)
    yr = torch.einsum("bfnm,nk->bfmk", x, c20[idx])                # (B, F, n2, k1)
    yi = torch.einsum("bfnm,nk->bfmk", x, s20[idx])
    k1 = torch.arange(r)
    half = k1 <= r // 2
    kk = torch.where(half, k1, r - k1)
    yr, yi = yr[..., kk], yi[..., kk] * torch.where(half, 1.0, -1.0)  # all 20 k1
    k = torch.arange(tmel.N_FFT // 2 + 1)
    tw = (torch.arange(r)[:, None] * k[None]) % tmel.N_FFT          # (n2, k)
    twr, twi = tab["twiddle"][0][tw], tab["twiddle"][1][tw]
    ar, ai = yr[..., k % r], yi[..., k % r]                          # (B, F, n2, k)
    re = (ar * twr - ai * twi).sum(2)
    im = (ar * twi + ai * twr).sum(2)
    power = re * re + im * im
    mels = []
    for first, count, off in tab["mel_span"].tolist():
        w = tab["mel_w"][off:off + count]
        mels.append((power[..., first:first + count] * w).sum(-1))
    return torch.log10(torch.clamp(torch.stack(mels, -1), min=1e-10))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_sparse_table_is_the_filter_bank(n_mels):
    tab = tmel.fft_mel_tables(n_mels)
    fb = tmel.mel_filter_bank(tmel.N_FFT // 2 + 1, n_mels)
    dense = np.zeros_like(fb)
    for m, (first, count, off) in enumerate(tab["mel_span"]):
        dense[m, first:first + count] = tab["mel_w"][off:off + count]
    np.testing.assert_array_equal(dense, fb)
    # Every nonzero is in the table and nothing else is.
    assert tab["mel_w"].size == int((fb != 0).sum()) and (tab["mel_w"] != 0).all()
    # Each bin feeds at most two mels.
    assert int((fb != 0).sum(0).max()) <= 2
    assert tab["mel_w"].size <= 512                  # csrc/mel.cu MEL_MAXNNZ


def test_dft_tables_are_roots_of_unity():
    tab = tmel.fft_mel_tables(80)
    m = np.arange(tmel.N_FFT)
    np.testing.assert_allclose(tab["twiddle"][0] + 1j * tab["twiddle"][1],
                               np.exp(-2j * np.pi * m / tmel.N_FFT), atol=1e-7)
    np.testing.assert_allclose(tab["dft20"][0] + 1j * tab["dft20"][1],
                               np.exp(-2j * np.pi * np.arange(20) / 20), atol=1e-7)
    np.testing.assert_allclose(tab["window"], 0.5 * (1 - np.cos(2 * np.pi * m / 400)),
                               atol=1e-7)
    dev = tmel.device_fft_tables("cpu", 80)
    for name, a in tab.items():
        np.testing.assert_array_equal(dev[name].numpy(), a)
    assert tmel.device_fft_tables("cpu", 80) is dev


def _f64_log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The same function with a float64 dense DFT: the yardstick of both."""
    m = np.arange(tmel.N_FFT)
    window = 0.5 * (1 - np.cos(2 * np.pi * m / tmel.N_FFT))
    ang = 2 * np.pi * m[:, None] * np.arange(tmel.N_FFT // 2 + 1)[None] / tmel.N_FFT
    frames = tmel.frame_audio(audio.double())
    re = frames @ torch.from_numpy(np.cos(ang) * window[:, None])
    im = frames @ torch.from_numpy(-np.sin(ang) * window[:, None])
    fb = torch.from_numpy(tmel.mel_filter_bank(tmel.N_FFT // 2 + 1, n_mels).T
                          .astype(np.float64))
    return torch.log10(torch.clamp((re * re + im * im) @ fb, min=1e-10)).float()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_emulation_matches_plain_raw(n_mels):
    """Raw log10 within 1e-4 of the plain version where the mel energy is
    above 1e-8 and above 1e-6 of its frame's largest: beneath that floor a
    float32 DFT's rounding dominates (the plain version itself is 1.2e-3
    from the float64 DFT at 1e-8 on the chirp's frames), and both sit near
    the clamp.  Against the float64 DFT the emulation keeps the same 1e-4."""
    x = torch.from_numpy(_audio(5))
    got = emulate_k8(x, tmel.device_fft_tables("cpu", n_mels))
    ref = tmel.log_mel_plain(x, n_mels)
    exact = _f64_log_mel(x, n_mels)
    assert got.shape == ref.shape == (2, 3000, n_mels)
    live = (exact > -8.0) & (exact > exact.amax(-1, keepdim=True) - 6.0)
    assert live.float().mean() > 0.5
    assert float((got - ref).abs()[live].max()) < 1e-4
    assert float((got - exact).abs()[live].max()) < 1e-4
    # Everywhere else both sit near the clamp: still close in log10.
    assert float((got - ref).abs().max()) < 0.5


@pytest.mark.parametrize("n_mels", [80, 128])
def test_emulation_matches_jax_and_pallas_interpret(n_mels):
    wav = _audio(6)
    got = tmel.normalize_log_mel(emulate_k8(torch.from_numpy(wav),
                                            tmel.device_fft_tables("cpu", n_mels))).numpy()
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wav), n_mels=n_mels))
    pallas = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(wav), n_mels=n_mels,
                                                   interpret=True))
    assert got.shape == ref.shape == pallas.shape == (2, n_mels, 3000)
    assert np.abs(got - ref).max() < 1e-3
    assert np.abs(got - pallas).max() < 1e-3
