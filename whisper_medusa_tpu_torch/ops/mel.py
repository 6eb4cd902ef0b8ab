"""Whisper log-mel frontend — counterpart of whisper_medusa_tpu/ops/mel.py.

Same math: reflect-padded 400-sample Hann frames at hop 160, the DFT as two
matmuls against windowed cos/sin bases, the Slaney mel filter bank, log10,
clamp to (max - 8) and (x + 4) / 4.  The JAX package's default frontend runs
no kernel, so this is plain PyTorch; :func:`log_mel_plain` (up to log10) is
also the plain version of the opt-in fused kernel K8 (``ops/mel_fused.py``),
and :func:`normalize_log_mel` the normalization both paths share.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_LENGTH       # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH           # 3000


def _hz_to_mel_slaney(freq) -> np.ndarray:
    freq = np.asarray(freq, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = freq / f_sp
    log_part = min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep
    return np.where(freq >= min_log_hz, log_part, mel)


def _mel_to_hz_slaney(mel) -> np.ndarray:
    mel = np.asarray(mel, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    hz = mel * f_sp
    return np.where(mel >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)), hz)


@lru_cache(maxsize=4)
def mel_filter_bank(n_freqs: int = N_FFT // 2 + 1, n_mels: int = 80,
                    f_min: float = 0.0, f_max: float = 8000.0,
                    sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """(n_mels, n_freqs) triangular Slaney-normalized filterbank."""
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]          # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up)).T           # (n_mels, n_freqs)
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return (fb * enorm[:, None]).astype(np.float32)


@lru_cache(maxsize=2)
def dft_mel_basis(n_mels: int = 80) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cos (N_FFT, n_freqs), sin (N_FFT, n_freqs), mel_fb (n_freqs, n_mels)),
    with the periodic Hann window folded into the DFT bases."""
    n_freqs = N_FFT // 2 + 1
    window = 0.5 * (1 - np.cos(2 * np.pi * np.arange(N_FFT) / N_FFT))
    ang = 2.0 * np.pi * np.arange(N_FFT)[:, None] * np.arange(n_freqs)[None, :] / N_FFT
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b, mel_filter_bank(n_freqs, n_mels).T.astype(np.float32)


_DEVICE_BASES: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, ...]] = {}


def device_bases(device, n_mels: int = 80) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`dft_mel_basis` as contiguous f32 tensors on ``device``, built
    once per (device, ``n_mels``)."""
    key = (torch.device(device), n_mels)
    if key not in _DEVICE_BASES:
        _DEVICE_BASES[key] = tuple(torch.from_numpy(a).to(key[0]).contiguous()
                                   for a in dft_mel_basis(n_mels))
    return _DEVICE_BASES[key]


# K8's factored DFT: n = FFT_R * n1 + n2 and k = k1 + FFT_R * k2, 400 = 20 x 20.
FFT_R = 20


@lru_cache(maxsize=2)
def fft_mel_tables(n_mels: int = 80) -> Dict[str, np.ndarray]:
    """The tables kernel K8 (``csrc/mel.cu``) computes log-mel from:

    * ``window`` (400,): the periodic Hann window;
    * ``dft20`` (2, 20): cos and -sin of 2 pi m / 20, the 20-point DFT of
      the first stage (over n1, for each n2);
    * ``twiddle`` (2, 400): cos and -sin of 2 pi m / 400; bin k is
      sum_n2 Y_n2[k % 20] * twiddle[(n2 * k) % 400] (the second stage with
      the twiddle folded in);
    * ``mel_span`` (n_mels, 3) int32: each mel's first bin, its number of
      nonzero weights (contiguous bins) and their offset in ``mel_w``;
    * ``mel_w`` (nnz,) float32: the filter bank's nonzeros, mel by mel.

    Built in float64 and rounded once to float32."""
    m = np.arange(N_FFT)
    window = 0.5 * (1 - np.cos(2 * np.pi * m / N_FFT))
    ang20 = 2 * np.pi * np.arange(FFT_R) / FFT_R
    ang = 2 * np.pi * m / N_FFT
    fb = mel_filter_bank(N_FFT // 2 + 1, n_mels)
    span, weights = [], []
    for row in fb:
        nz = np.flatnonzero(row)
        first, count = (int(nz[0]), int(nz[-1]) - int(nz[0]) + 1) if nz.size else (0, 0)
        span.append((first, count, sum(len(w) for w in weights)))
        weights.append(row[first:first + count])
    return {"window": window.astype(np.float32),
            "dft20": np.stack([np.cos(ang20), -np.sin(ang20)]).astype(np.float32),
            "twiddle": np.stack([np.cos(ang), -np.sin(ang)]).astype(np.float32),
            "mel_span": np.asarray(span, np.int32).reshape(n_mels, 3),
            "mel_w": np.concatenate(weights).astype(np.float32)}


_DEVICE_TABLES: Dict[Tuple[torch.device, int], Dict[str, torch.Tensor]] = {}


def device_fft_tables(device, n_mels: int = 80) -> Dict[str, torch.Tensor]:
    """:func:`fft_mel_tables` as contiguous tensors on ``device``, built once
    per (device, ``n_mels``): K8's operands."""
    key = (torch.device(device), n_mels)
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = {name: torch.from_numpy(a).to(key[0]).contiguous()
                               for name, a in fft_mel_tables(n_mels).items()}
    return _DEVICE_TABLES[key]


def frame_audio(audio: torch.Tensor) -> torch.Tensor:
    """(B, N) -> (B, N // HOP_LENGTH, N_FFT) reflect-padded centered frames."""
    pad = N_FFT // 2
    x = torch.nn.functional.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    n_frames = audio.shape[-1] // HOP_LENGTH
    return x.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]


def log_mel_plain(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(B, N) float32 -> (B, N // HOP_LENGTH, n_mels) float32 log10 mel: the
    function kernel K8 computes (``ops/mel_fused.py``), in plain PyTorch."""
    cos_b, sin_b, mel_fb = device_bases(audio.device, n_mels)
    frames = frame_audio(audio.float())                    # (B, F, N_FFT)
    re = frames @ cos_b
    im = frames @ sin_b
    mel = (re * re + im * im) @ mel_fb                     # (B, F, n_mels)
    return torch.log10(torch.clamp(mel, min=1e-10))


def normalize_log_mel(log_spec: torch.Tensor) -> torch.Tensor:
    """(B, F, n_mels) log10 mel -> (B, n_mels, F) Whisper features: clamp to
    each example's max - 8, then (x + 4) / 4."""
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2).contiguous()


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(B, N_SAMPLES) float32 -> (B, n_mels, N_FRAMES) float32 log-mel."""
    return normalize_log_mel(log_mel_plain(audio, n_mels))


def pad_or_trim(audio, length: int = N_SAMPLES) -> np.ndarray:
    """Host-side pad/trim to exactly 30 s."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    if audio.shape[-1] >= length:
        return audio[..., :length]
    out = np.zeros(audio.shape[:-1] + (length,), np.float32)
    out[..., :audio.shape[-1]] = audio
    return out
