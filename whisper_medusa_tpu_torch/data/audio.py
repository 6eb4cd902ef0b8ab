"""Host-side audio helpers — counterpart of the resampling in
whisper_medusa_tpu/data/dataset.py."""

from __future__ import annotations

from math import gcd

import numpy as np


def resample(audio: np.ndarray, sr: int, target_sr: int = 16000) -> np.ndarray:
    """Polyphase resampling (scipy ``resample_poly``) on the host, float32."""
    if sr == target_sr:
        return audio.astype(np.float32)
    from scipy.signal import resample_poly

    g = gcd(target_sr, sr)
    return resample_poly(audio, target_sr // g, sr // g).astype(np.float32)
