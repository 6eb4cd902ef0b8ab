"""Host-side audio IO — counterpart of the loading and resampling in
whisper_medusa_tpu/data/dataset.py.  :func:`load_audio` reads WAV and FLAC
through the native C++ reader (``data/native.py``); a failed build or decode
raises.  :func:`load_audio_plain` is its plain version, the one the tests
hold it against: WAV through the stdlib ``wave`` module, FLAC through the
port's pure-Python decoder (``data/flac_py.py``), chosen by the file's magic
bytes."""

from __future__ import annotations

import wave
from math import gcd

import numpy as np


def load_audio(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV or FLAC file to float32 mono through the native reader;
    (samples, sample rate)."""
    from whisper_medusa_tpu_torch.data import native

    return native.load_audio(path)


def load_audio_plain(path: str) -> tuple[np.ndarray, int]:
    """:func:`load_audio` in pure Python."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"fLaC":
        from whisper_medusa_tpu_torch.data import flac_py

        return flac_py.decode_flac(data)
    return _load_wav(path)


def _load_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def resample(audio: np.ndarray, sr: int, target_sr: int = 16000) -> np.ndarray:
    """Polyphase resampling (scipy ``resample_poly``) on the host, float32."""
    if sr == target_sr:
        return audio.astype(np.float32)
    from scipy.signal import resample_poly

    g = gcd(target_sr, sr)
    return resample_poly(audio, target_sr // g, sr // g).astype(np.float32)
