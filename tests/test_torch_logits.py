"""Port ops/logits.py (plain version of kernel K3) vs the JAX streaming
projection kernel in interpret mode.

Both multiply bf16 values exactly and accumulate in f32, so only the
summation order differs: tolerance 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu.ops import logits as jlogits
from whisper_medusa_tpu_torch.ops import logits as tlogits


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jlogits, "_INTERPRET", True)
    monkeypatch.setattr(jlogits, "_ENABLED", True)


@pytest.mark.parametrize("m", [1, 10])
@pytest.mark.parametrize("v", [8192, 8192 + 665])   # aligned + ragged vocab edge
def test_plain_matches_stream_kernel(m, v):
    rng = np.random.default_rng(m * v)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    e = (rng.standard_normal((v, 256)) * 0.02).astype(np.float32)
    assert jlogits.kernel_available(m, v, 256)
    ref = np.asarray(jlogits.project_logits_stream(jnp.asarray(x, jnp.bfloat16),
                                                   jnp.asarray(e, jnp.bfloat16)))
    got = tlogits.project_logits_stream(torch.from_numpy(x).bfloat16(),
                                        torch.from_numpy(e).bfloat16())
    assert got.dtype == torch.float32 and got.shape == (m, v)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_leading_dims_and_cpu_route():
    x = torch.randn(3, 2, 64)
    e = torch.randn(100, 64)
    before = tlogits.launches
    got = tlogits.project_logits_stream(x, e)
    assert got.shape == (3, 2, 100) and tlogits.launches == before
    torch.testing.assert_close(got, x @ e.T, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        tlogits.project_kernel(x[0].bfloat16(), e.bfloat16())


class _Recorder:
    """Stands in for ``cuda_lib`` on CPU tensors: records each launch's
    (entry, rows, V, D) instead of calling C."""

    def __init__(self):
        self.calls = []

    def require_cuda(self, *args, **kwargs):
        pass

    def launch(self, entry, device, *args):
        self.calls.append((entry, *args[-3:]))


@pytest.mark.parametrize("m", [1, 10, 80, 192, 193, 400])
def test_k3_takes_the_plan_of_k7(monkeypatch, m):
    """K3 and K7 run one stream (csrc/ntstream.cuh) tiled by one plan
    (``qmm.nt_plan``): the same launches, each of at most 192 rows, at any M,
    and a plan that reads only V and D for everything but the rows."""
    from whisper_medusa_tpu_torch.ops import qmm as QM

    v, d = 51865, 1280
    rec = _Recorder()
    monkeypatch.setattr(tlogits, "cuda_lib", rec)
    monkeypatch.setattr(QM, "cuda_lib", rec)
    # The recorded launches count on the wrappers' counters: put them back
    # after the test (other tests in this process read them).
    monkeypatch.setattr(tlogits, "launches", tlogits.launches)
    monkeypatch.setattr(QM, "nt_launches", QM.nt_launches)
    x = torch.zeros((m, d), dtype=torch.bfloat16)
    tlogits.project_kernel(x, torch.zeros((v, d), dtype=torch.bfloat16))
    k3 = [c[1:] for c in rec.calls]
    rec.calls.clear()
    QM.qmm_nt_kernel(x, torch.zeros((v, d), dtype=torch.int8), torch.ones(v))
    k7 = [c[1:] for c in rec.calls]
    assert k3 == k7 == [(rows, v, d) for _, rows in QM.nt_blocks(m, v, d)]
    assert sum(r for r, _, _ in k3) == m and max(r for r, _, _ in k3) <= QM.MAX_NT_ROWS
    assert tlogits.MAX_M == QM.MAX_NT_ROWS
    with pytest.raises(ValueError):
        tlogits.project_kernel(torch.zeros((m, 1000), dtype=torch.bfloat16),
                               torch.zeros((v, 1000), dtype=torch.bfloat16))


def test_k3_is_on_the_shared_stream():
    import os
    import re

    from whisper_medusa_tpu_torch.ops import cuda_lib

    src = {n: open(os.path.join(cuda_lib.CSRC_DIR, n)).read()
           for n in os.listdir(cuda_lib.CSRC_DIR)}
    assert '#include "ntstream.cuh"' in src["logits.cu"]
    assert '#include "ntstream.cuh"' in src["qmm.cu"]
    assert "nt_launch<false>" in src["logits.cu"] and "nt_launch<true>" in src["qmm.cu"]
    for text in src.values():     # the old kernel and its tile (not the TPU's name)
        for gone in ("vocab_tile", r"(?<!_)logits_kernel", "VOCAB_SMEM", "VTHREADS"):
            assert not re.search(gone, text)
