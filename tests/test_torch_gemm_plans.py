"""The plans of K2's weight-streaming GEMM and of K7 are functions of the
weight shapes, never of the rows.

A row's bits on the card depend on how its sums are cut and ordered: K2's
GEMM cuts K into slices (``ops/megastep.py::gemm_slices``, mirroring
``csrc/megastep.cu::gemm_slices``) and adds them in rank order; K7 sums each
64-entry vocab tile over the 64-wide K chunks in order
(``ops/qmm.py::nt_plan``, mirroring ``csrc/qmm.cu::wm_qmm_nt``).  Here the
plans are held equal for every M from 1 to the kernels' rows, at
whisper-large-v2's projections and its tied embedding, the slices must fill
the card's 132 SMs within one portable cluster, and the Python constants
must match the C sources'.
"""

import os
import re

import pytest

from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import megastep as MS
from whisper_medusa_tpu_torch.ops import qmm as QM

D, F, V = 1280, 5120, 51865
# (name, K, N, jobs) of a large-v2 layer's six projections.
PROJECTIONS = (("qkv", D, D, 3), ("o", D, D, 1), ("cross q", D, D, 1),
               ("cross o", D, D, 1), ("fc1", D, F, 1), ("fc2", F, D, 1))


def _constants(source):
    with open(os.path.join(cuda_lib.CSRC_DIR, source)) as f:
        text = f.read()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_python_constants_match_the_sources():
    ms, qm = _constants("megastep.cu"), _constants("qmm.cu")
    assert ms["G_TILE"] == MS.GEMM_TILE
    assert ms["G_CTAS"] == MS.GEMM_CTAS
    assert ms["G_MAX_SLICES"] == MS.GEMM_MAX_SLICES
    assert qm["NT_VT"] == QM.TILE and qm["NT_KC"] == QM.NT_CHUNK
    assert qm["NT_MAX_MT"] * 16 == QM.MAX_NT_ROWS


@pytest.mark.parametrize("name,k,n,jobs", PROJECTIONS)
def test_k2_plan_does_not_change_with_m(name, k, n, jobs):
    slices, ranges, _ = MS.gemm_plan(1, k, n, jobs)
    for m in range(2, MS.MAX_ROWS + 1):
        s, r, tiles = MS.gemm_plan(m, k, n, jobs)
        assert (s, r) == (slices, ranges), f"{name}: the plan moved at M={m}"
        assert tiles == -(-m // 16)
    chunks = k // MS.GEMM_TILE
    assert ranges[0][0] == 0 and ranges[-1][1] == chunks
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    assert 1 <= slices <= MS.GEMM_MAX_SLICES
    ctas = slices * jobs * n // MS.GEMM_TILE
    assert ctas >= MS.GEMM_CTAS, f"{name}: {ctas} CTAs"


def test_k2_slices_of_large_v2():
    got = {name: MS.gemm_slices(k, n, jobs) for name, k, n, jobs in PROJECTIONS}
    assert got == {"qkv": 3, "o": 7, "cross q": 7, "cross o": 7, "fc1": 2, "fc2": 7}
    # Whisper tiny's widths (the per-op step serves them; the rule still holds).
    assert MS.gemm_slices(384, 384) == 6 and MS.gemm_slices(384, 1536) == 6


@pytest.mark.parametrize("v,d", [(V, D), (V, 384), (256, 256)])
def test_k7_tiling_does_not_change_with_m(v, d):
    first = QM.nt_plan(1, v, d)
    assert first["tiles"] == -(-v // 64) and first["chunks"] == d // 64
    for m in range(2, 2 * QM.MAX_NT_ROWS + 2):
        plan = QM.nt_plan(m, v, d)
        assert (plan["tiles"], plan["chunks"]) == (first["tiles"], first["chunks"])
        assert plan["row_tiles"] == -(-min(m, QM.MAX_NT_ROWS) // 16)
        assert plan["launches"] == -(-m // QM.MAX_NT_ROWS)


def test_k7_plan_refuses_other_widths():
    with pytest.raises(ValueError):
        QM.nt_plan(10, V, 1000)
