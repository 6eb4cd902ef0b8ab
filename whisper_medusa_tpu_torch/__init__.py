"""whisper_medusa_tpu_torch — the PyTorch / CUDA port of whisper_medusa_tpu.

The JAX package beside it is the reference; this package mirrors its module
paths (``models/whisper.py``, ``ops/megastep.py``, ...) so each counterpart is
found by name.  It imports ``torch`` and never ``jax``.  The jax-free modules
of the reference (``config``, ``decoding.buffers``, ``data.tokenizer``) are
imported as they are.

Plain tensor code is PyTorch.  The four kernels of the greedy ``base_head``
decode path (encoder attention, the whole-decoder megastep, the prefill vocab
projection and fused verification) are CUDA C++ for Hopper under ``csrc/``,
built with nvcc at first use; on CPU tensors each wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
