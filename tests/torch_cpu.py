"""One intra-op thread for the port's CPU tests.

The suite runs its files in parallel worker processes (pytest-xdist), each
on every core: PyTorch's OpenMP and MKL threads then spin-wait against one
another and against the JAX side's, and a file of small decode-loop ops ran
about ten times slower than on one thread (six concurrent runs of
test_torch_longform.py: 745 s each at the default thread count, 68 s at
one thread).  Every ``tests/test_torch_*.py`` imports this module, so the
setting holds whichever file runs first; a test that needs another count
sets it and restores it.
"""

import torch

torch.set_num_threads(1)
