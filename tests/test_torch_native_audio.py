"""The port's native audio reader (``data/native.py``, ctypes onto the
repository's ``native/audio_io.cpp``) against the port's plain readers
(``data/audio.py::load_audio_plain``: stdlib WAV, pure-Python FLAC) and the
JAX package's ``data/native.py`` on the same WAV and FLAC bytes, as
tests/test_flac.py holds the JAX package's.

WAVs of 8-, 16- and 32-bit samples, mono and stereo; FLAC streams from
tests/flac_encoder.py over its subframe and stereo modes.  Samples equal
the plain readers' within 1e-7 (the JAX test's bound) and the JAX native
reader's bit for bit, as does the resampler.  The library is built into
the port's ignored build directory; a missing or broken source, or bytes
that are no audio, raise.
"""

import os
import sys
import wave

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from flac_encoder import encode_flac  # noqa: E402
import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.data import native as jnative  # noqa: E402
from whisper_medusa_tpu_torch.data import audio, native  # noqa: E402


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(np.cumsum(rng.integers(-300, 301, size=n)), -30000, 30000).astype(np.int64)


def _wav(path, x, sr, width, channels=1):
    kind = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    scale = {1: 1 / 256, 2: 1, 4: 65536}[width]
    data = (x * scale).astype(np.int64)
    if width == 1:
        data = data + 128
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.astype(kind).tobytes())


def _files(tmp_path):
    x = _signal(5000, 1)
    out = []
    for width in (1, 2, 4):
        p = tmp_path / f"w{width}.wav"
        _wav(p, x, 16000, width)
        out.append(p)
    p = tmp_path / "stereo.wav"
    _wav(p, np.stack([x, _signal(5000, 2)], axis=1).reshape(-1), 22050, 2, channels=2)
    out.append(p)
    for i, (mode, stereo) in enumerate((("verbatim", None), ("fixed2", None), ("lpc", None),
                                        ("lpc", "mid_side"), ("fixed1", "left_side"))):
        sig = x if stereo is None else np.stack([x, _signal(5000, 3)])
        kw = {} if stereo is None else {"chan_mode": stereo}
        p = tmp_path / f"f{i}.flac"
        p.write_bytes(encode_flac(sig, 16000, block_size=1024, mode=mode, **kw))
        out.append(p)
    return out


def test_native_reader_matches_plain_and_jax_readers(tmp_path):
    files = _files(tmp_path)
    for p in files:
        got, sr = native.load_audio(str(p))
        plain, sr_p = audio.load_audio_plain(str(p))
        ref, sr_j = jnative.load_audio(str(p))
        assert sr == sr_p == sr_j, p
        assert got.dtype == np.float32 and len(got) == len(plain), p
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-7, err_msg=str(p))
        np.testing.assert_array_equal(got, ref, err_msg=str(p))


def test_load_audio_goes_through_the_native_reader(tmp_path, monkeypatch):
    p = _files(tmp_path)[1]
    calls = []
    real = native.load_audio
    monkeypatch.setattr(native, "load_audio", lambda path: calls.append(path) or real(path))
    x, sr = audio.load_audio(str(p))
    assert calls == [str(p)] and sr == 16000 and len(x) == 5000


@pytest.mark.parametrize("sr_in,sr_out", [(8000, 16000), (44100, 16000), (16000, 16000)])
def test_resample_matches_jax_native(sr_in, sr_out):
    x = (_signal(4410, 4) / 32768.0).astype(np.float32)
    np.testing.assert_array_equal(native.resample(x, sr_in, sr_out),
                                  jnative.resample(x, sr_in, sr_out))


def test_library_is_built_into_the_ports_build_directory():
    native.lib()
    built = [n for n in os.listdir(native.BUILD_DIR) if n.startswith("libwm_audio_")]
    assert built and os.path.dirname(native.SRC).endswith("native")
    assert not native.BUILD_DIR.startswith(os.path.dirname(native.SRC))


def test_missing_or_broken_source_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SRC", str(tmp_path / "missing.cpp"))
    with pytest.raises(FileNotFoundError):
        native.lib()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.lib()
    assert native._LIB is None


@pytest.mark.parametrize("kind", ["wav", "flac", "flac_no_total"])
def test_audio_longer_than_the_old_fixed_buffer_decodes(tmp_path, kind):
    """The buffer is sized from the file: 12.5M samples (more than 120 s at
    96 kHz) decode whole, a FLAC whose STREAMINFO total is zeroed too."""
    n = 12_500_000
    if kind == "wav":
        x = np.repeat(np.arange(-100, 100, 8), n // 25)
        p = tmp_path / "long.wav"
        _wav(p, x * 256, 16000, 1)
    else:
        x = np.repeat(np.arange(-25, 25) * 512, n // 50)
        data = bytearray(encode_flac(x, 16000, block_size=62500, mode="constant"))
        if kind == "flac_no_total":
            data[8 + 13] &= 0xF0
            data[8 + 14:8 + 18] = bytes(4)
        p = tmp_path / "long.flac"
        p.write_bytes(bytes(data))
    assert len(x) == n
    got, sr = native.load_audio(str(p))
    plain, _ = audio.load_audio_plain(str(p))
    assert sr == 16000 and len(got) == len(plain) == n
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-7)


def test_undecodable_bytes_raise(tmp_path):
    p = tmp_path / "noise.wav"
    p.write_bytes(b"RIFF" + os.urandom(64))
    with pytest.raises(ValueError, match="native audio decode failed"):
        native.load_audio(str(p))
