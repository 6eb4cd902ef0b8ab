"""whisper_medusa_tpu_torch — the PyTorch / CUDA port of whisper_medusa_tpu.

The JAX package beside it is the reference; this package mirrors its module
paths (``models/whisper.py``, ``ops/megastep.py``, ...) so each counterpart is
found by name.  It imports ``torch`` and never ``jax``, and nothing of the
JAX package: it keeps its own copies of the jax-free modules it needs
(``config``, ``decoding.buffers``, ``data.tokenizer``, ``data.bpe``,
``data.flac_py``, the resampler in ``data.audio``, ``utils.metrics``).

Plain tensor code is PyTorch.  The eight kernels of the serving paths
(attention, the whole-decoder megastep with its int8 and Medusa-Block
modes, the vocab projection, fused verification of built and given rows,
the two int8 matmuls and the fused log-mel frontend) and the attention
backward that training adds are CUDA C++ for Hopper under ``csrc/``, built
with nvcc at first use; on CPU tensors each wrapper runs its plain PyTorch
version instead.  Training (``training/``, ``cli/train.py``) runs the
differentiable PyTorch around them.
"""

__version__ = "0.1.0"
