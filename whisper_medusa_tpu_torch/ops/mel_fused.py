"""The fused log-mel frontend — kernel K8.

Replaces the TPU kernel ``whisper_medusa_tpu/ops/mel_pallas.py::_mel_kernel``
(launched by ``log_mel_spectrogram_pallas``): reflect-padded framing, the
windowed DFT (cos and sin, 400 taps -> 201 frequencies), the power
spectrum, the mel projection (201 -> n_mels) and log10 in one kernel, so
neither the frames nor the spectrum reach device memory.  The per-example
max, the clamp to max - 8, ``(x + 4) / 4`` and the transpose stay outside the
kernel, as in the JAX function (``ops/mel.py::normalize_log_mel``).

On the TPU the kernel multiplies each frame by dense windowed cos and sin
bases, split into three 160-lane blocks aligned with ``pltpu.roll`` for
Mosaic's tiling.  ``csrc/mel.cu::wm_log_mel`` keeps what it computes and
factors the DFT instead, 400 = 20 x 20: for each n2 a real 20-point DFT of
the windowed samples x[20 n1 + n2] (its 11 non-redundant outputs), then
each of bins 0..200 as one 20-term complex sum of those outputs times the
twiddles W^(n2 k).  That is about 26 k real MACs a frame against the dense
DFT's 161 k; the mel projection reads only the filter bank's nonzeros (391
at 80 mels: each bin feeds at most two mels).  One CTA of 5 warps takes 16
frames of one example, lane = frame, in full f32 on the CUDA cores (no
TF32: a frame's spectrum cancels strongly in its low-power bins); each
output is one thread's sum in a fixed order, so a frame's bits do not
depend on B.  188 CTAs at B=1, 1500 at B=8, four to an SM (49.6 KB of
shared memory each).  Bound on H100: bytes, 2.9 MB of audio and features
per 30 s example (0.86 us at 3.35 TB/s); the FFT and the sparse filter bank
are about 32 MFLOP an example (0.47 us at 67 TFLOP/s;
``chip_smoke.py::_log_mel_cost``).

The tables (window, the 20 roots, the 400 twiddles, each mel's first bin,
count and weights) come from ``ops/mel.py::device_fft_tables``
(``fft_mel_tables``, built once per device and ``n_mels``).  CUDA tensors
launch the kernel; CPU tensors take the plain version
``ops/mel.py::log_mel_plain``.
"""

from __future__ import annotations

import torch

from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import mel as mel_mod

MAX_MELS = 128           # csrc/mel.cu MEL_MAXMELS
MAX_NNZ = 512            # csrc/mel.cu MEL_MAXNNZ: the filter bank's nonzeros

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
    tab = mel_mod.device_fft_tables(audio.device, n_mels)
    nnz = tab["mel_w"].numel()
    if nnz > MAX_NNZ:
        raise ValueError(f"log_mel kernel takes <= {MAX_NNZ} filter-bank nonzeros; got {nnz}")
    out = torch.empty((b, n // mel_mod.HOP_LENGTH, n_mels), dtype=torch.float32,
                      device=audio.device)
    cuda_lib.launch("wm_log_mel", audio.device, audio.data_ptr(), tab["window"].data_ptr(),
                    tab["dft20"].data_ptr(), tab["twiddle"].data_ptr(),
                    tab["mel_span"].data_ptr(), tab["mel_w"].data_ptr(), out.data_ptr(), b,
                    n, n_mels, nnz)
    launches += 1
    return out


def log_mel_spectrogram_fused(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(B, N_SAMPLES) f32 -> (B, n_mels, N_FRAMES) Whisper features.  CUDA
    tensors launch K8; CPU tensors take its plain version."""
    audio = audio.float().contiguous()
    fn = mel_kernel if audio.is_cuda else mel_mod.log_mel_plain
    return mel_mod.normalize_log_mel(fn(audio, n_mels))
