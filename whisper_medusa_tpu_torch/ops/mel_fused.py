"""The fused log-mel frontend — kernel K8.

Replaces the TPU kernel ``whisper_medusa_tpu/ops/mel_pallas.py::_mel_kernel``
(launched by ``log_mel_spectrogram_pallas``): reflect-padded framing, the
windowed DFT (cos and sin, 400 taps -> 201 frequencies), the power
spectrum, the mel projection (201 -> n_mels) and log10 in one kernel, so
neither the frames nor the spectrum reach device memory.  The per-example
max, the clamp to max - 8, ``(x + 4) / 4`` and the transpose stay outside the
kernel, as in the JAX function (``ops/mel.py::normalize_log_mel``).

On the TPU the kernel splits each frame into three 160-lane row buffers and
three zero-padded basis blocks aligned with ``pltpu.roll``; that exists only
for Mosaic's tiling.  ``csrc/mel.cu::wm_log_mel`` keeps what it computes:
one CTA of 4 warps per (example, 32 frames) stages the 5,360 samples its
frames span in shared memory, mirroring the reflect padding at both ends of
the signal itself (the padded copy of the audio never exists); the windowed
bases, zero-padded to 256 frequencies, stream from L2 in 16-tap slices
double-buffered with ``cp.async``; each thread accumulates 8 frames x 8
frequencies of ``re`` and ``im`` in full f32 on the CUDA cores (no TF32: a
frame's DFT cancels strongly in its low-power bins); the power goes to
shared memory, then each thread projects 8 frames x up to 4 mel bins and
stores ``log10(max(mel, 1e-10))``.  Bound on H100: bytes, 2.9 MB of audio
and features per 30 s example (0.86 us at 3.35 TB/s), since log-mel by a
real FFT and the sparse filter bank needs only about 10.5 kFLOP a frame
(32 MFLOP an example, 0.47 us at 67 TFLOP/s; ``chip_smoke.py::_log_mel_cost``).
The design limit is the dense O(N^2) DFT: K8 does 1.06 GFLOP an example,
34x the FFT's count, 16 us on the f32 CUDA cores alone.  At B=1 an
example's 94 CTAs fill 94 of the 132 SMs.

The bases come from ``ops/mel.py::device_bases`` (``dft_mel_basis``, built
once per device and ``n_mels``), as the plain version's do, with the DFT
bases zero-padded to 256 columns for the kernel.  CUDA
tensors launch the kernel; CPU tensors take the plain version
``ops/mel.py::log_mel_plain``.
"""

from __future__ import annotations

import torch

from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import mel as mel_mod

MAX_MELS = 128           # csrc/mel.cu: 4 mel bins per lane
PADDED_FREQS = 256       # csrc/mel.cu MEL_KP

launches = 0

def mel_kernel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Launch K8: audio (B, N) f32 on the card -> (B, N // 160, n_mels) f32
    log10 mel."""
    global launches
    cuda_lib.require_cuda("log_mel", audio, dtype=torch.float32)
    if audio.dim() != 2 or audio.shape[1] < mel_mod.N_FFT or not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f"log_mel kernel takes (B, N >= {mel_mod.N_FFT}) audio and "
                         f"n_mels <= {MAX_MELS}; got {tuple(audio.shape)}, n_mels {n_mels}")
    b, n = audio.shape
    cos_b, sin_b, mel_fb = mel_mod.device_bases(audio.device, n_mels, PADDED_FREQS)
    out = torch.empty((b, n // mel_mod.HOP_LENGTH, n_mels), dtype=torch.float32,
                      device=audio.device)
    cuda_lib.launch("wm_log_mel", audio.device, audio.data_ptr(), cos_b.data_ptr(),
                    sin_b.data_ptr(), mel_fb.data_ptr(), out.data_ptr(), b, n, n_mels)
    launches += 1
    return out


def log_mel_spectrogram_fused(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(B, N_SAMPLES) f32 -> (B, n_mels, N_FRAMES) Whisper features.  CUDA
    tensors launch K8; CPU tensors take its plain version."""
    audio = audio.float().contiguous()
    fn = mel_kernel if audio.is_cuda else mel_mod.log_mel_plain
    return mel_mod.normalize_log_mel(fn(audio, n_mels))
