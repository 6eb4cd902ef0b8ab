"""WhisperProcessor equivalent — counterpart of whisper_medusa_tpu/processor.py.

Audio -> log-mel features on the card (or on the CPU when asked for); ids ->
text through the port's own tokenizers (``data/tokenizer.py``).  A list of up
to 8 waveforms gives one (B, n_mels, 3000) batch; audio at another sampling
rate is resampled to 16 kHz on the host first (``data/audio.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from whisper_medusa_tpu_torch.data.audio import resample
from whisper_medusa_tpu_torch.data.tokenizer import CharTokenizer, load_tokenizer
from whisper_medusa_tpu_torch.models.bridge import resolve_device
from whisper_medusa_tpu_torch.ops import mel as mel_mod
from whisper_medusa_tpu_torch.ops import mel_fused


class WhisperMedusaProcessor:
    """``use_kernel`` is the JAX processor's ``use_pallas``, with the same
    default (``False``): the fused log-mel kernel K8 (``ops/mel_fused.py``)
    on a CUDA processor, its plain version on a CPU one.  The default
    frontend is the plain PyTorch matmul-DFT."""

    def __init__(self, tokenizer=None, n_mels: int = 80, device="cuda",
                 use_kernel: bool = False):
        self.tokenizer = tokenizer
        self.n_mels = n_mels
        self.device = resolve_device(device)
        self.use_kernel = use_kernel

    @classmethod
    def from_pretrained(cls, name_or_path: str, language: Optional[str] = None,
                        n_mels: int = 80, device="cuda") -> "WhisperMedusaProcessor":
        try:
            tok = load_tokenizer(name_or_path, language=language)
        except Exception:
            tok = CharTokenizer()
        return cls(tokenizer=tok, n_mels=n_mels, device=device)

    def __call__(self, audio: Union[np.ndarray, Sequence[np.ndarray]],
                 sampling_rate: int = 16000) -> torch.Tensor:
        """Waveform(s) -> (B, n_mels, 3000) float32 log-mel."""
        if isinstance(audio, np.ndarray) and audio.ndim == 1:
            audio = [audio]
        if sampling_rate != 16000:
            audio = [resample(np.asarray(a), sampling_rate) for a in audio]
        batch = np.stack([mel_mod.pad_or_trim(np.asarray(a))[0] for a in audio])
        x = torch.from_numpy(batch).to(self.device)
        if self.use_kernel:
            return mel_fused.log_mel_spectrogram_fused(x, n_mels=self.n_mels)
        return mel_mod.log_mel_spectrogram(x, n_mels=self.n_mels)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.tokenizer.decode(np.asarray(ids).tolist(),
                                     skip_special_tokens=skip_special_tokens)

    def batch_decode(self, ids_batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in ids_batch]
