"""ctypes bindings of the repository's native C++ audio reader
(``native/audio_io.cpp``) — counterpart of whisper_medusa_tpu/data/native.py.

The source is compiled with g++ at first use into the port's build
directory (``build/whisper_medusa_tpu_torch/``, next to the kernels), named
by a hash of the source and flags, never into ``native/``.  The build runs
behind a file lock, so data-parallel ranks that start together build it
once.  A failed build or decode raises: there is no silent fall back to the
pure-Python readers (``data/audio.py`` keeps those as the plain versions
that the tests hold this reader against).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC = os.path.join(_REPO, "native", "audio_io.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "whisper_medusa_tpu_torch")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_f32p = ctypes.POINTER(ctypes.c_float)


def _build() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libwm_audio_{digest}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libwm_audio.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.isfile(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            res = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed building {out} from {SRC}:\n{res.stderr}")
            os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded reader; builds it on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(_build())
            decode = [ctypes.c_char_p, ctypes.c_int64, _f32p, ctypes.c_int64,
                      ctypes.POINTER(ctypes.c_int32)]
            for name in ("wm_decode_wav", "wm_decode_flac", "wm_decode_audio"):
                getattr(handle, name).argtypes = decode
                getattr(handle, name).restype = ctypes.c_int64
            handle.wm_resample.argtypes = [_f32p, ctypes.c_int64, ctypes.c_int32,
                                           ctypes.c_int32, _f32p, ctypes.c_int64]
            handle.wm_resample.restype = ctypes.c_int64
            _LIB = handle
    return _LIB


_ERR_TOO_LARGE = -3  # audio_io.cpp kErrTooLarge


def _capacity(buf: bytes) -> int:
    """The samples to make room for: FLAC's STREAMINFO total (36 bits at
    byte 13 of the block, per channel, so the mono count) where it is
    known, else the file's length in bytes, which bounds a WAV's frames
    (each takes at least one byte)."""
    if buf[:4] == b"fLaC" and len(buf) >= 8 + 18 and (buf[4] & 0x7F) == 0:
        s = buf[8:8 + 18]
        total = ((s[13] & 0x0F) << 32) | int.from_bytes(s[14:18], "big")
        if total:
            return total
    return max(len(buf), 1)


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV or FLAC file (sniffed by its magic bytes) to float32
    mono; (samples, sample rate).  The buffer is sized from the file, so
    any length decodes; a FLAC whose STREAMINFO total is missing or short
    is decoded again into twice the room.  Raises on a file it cannot
    decode."""
    with open(path, "rb") as f:
        buf = f.read()
    cap = _capacity(buf)
    while True:
        out = np.empty((cap,), np.float32)
        sr = ctypes.c_int32(0)
        n = lib().wm_decode_audio(buf, len(buf), out.ctypes.data_as(_f32p), cap,
                                  ctypes.byref(sr))
        if n != _ERR_TOO_LARGE:
            break
        cap *= 2
    if n < 0:
        raise ValueError(f"native audio decode failed ({n}) for {path}")
    return out[:n].copy(), int(sr.value)


def resample(audio: np.ndarray, sr: int, target_sr: int = 16000) -> np.ndarray:
    """The C++ windowed-sinc resampler (the JAX package's ``native.resample``;
    the data path resamples with ``data/audio.py::resample``, as the JAX
    dataset does)."""
    audio = np.ascontiguousarray(audio, np.float32)
    cap = int(len(audio) * (target_sr / sr) + 16)
    out = np.empty((cap,), np.float32)
    n = lib().wm_resample(audio.ctypes.data_as(_f32p), len(audio), sr, target_sr,
                          out.ctypes.data_as(_f32p), cap)
    if n < 0:
        raise ValueError(f"native resample failed ({n})")
    return out[:n].copy()
