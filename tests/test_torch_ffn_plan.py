"""K11's plan on the shared weight-streaming GEMM, and its row blocking.

``csrc/decode_ops.cu::wm_ffn_decode`` runs fc1 and fc2 on the GEMM of
``csrc/wgemm.cuh`` (K2's): K cut into slices (``gemm_slices``) and the ring
into stages (``ffn_stages``), both from the weight's (K, N) alone, and up to
192 rows a launch; the wrapper sends more rows in blocks
(``ops/decode_ops.py::ffn_plan``, ``ffn_decode_blocked``).  A row's bits on
the card depend only on how its sums are cut and ordered, so the plan is held
equal for every M from 1 to 300 at whisper-large-v2's and whisper tiny's
widths; the Python constants must match the C sources'; and the blocking,
applied with the plain version, must give the plain version over all rows.
"""

import os
import re

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import decode_ops as DO
from whisper_medusa_tpu_torch.ops import megastep as MS
from whisper_medusa_tpu_torch.ops import verify as VF

WIDTHS = (("large-v2", 1280, 5120), ("tiny", 384, 1536))


def _constants(source):
    with open(os.path.join(cuda_lib.CSRC_DIR, source)) as f:
        text = f.read()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_python_constants_match_the_sources():
    wg, dec, ver = (_constants(n) for n in ("wgemm.cuh", "decode_ops.cu", "verify.cu"))
    assert wg["G_TILE"] == MS.GEMM_TILE
    assert wg["G_CTAS"] == MS.GEMM_CTAS
    assert wg["G_MAX_SLICES"] == MS.GEMM_MAX_SLICES
    assert wg["G_MAX_MT"] * 16 == DO.FFN_ROWS
    assert dec["FFN_MAX_STAGES"] == DO.FFN_MAX_STAGES
    assert ver["VS_VT"] == VF.TILE
    assert ver["VS_MAX_MT"] * 16 == VF.PASS_ROWS
    assert ver["VR_MAX_ROWS"] == VF.MAX_ROWS_R
    assert ver["VH_MAX_ROWS"] == VF.MAX_R


@pytest.mark.parametrize("name,d,f", WIDTHS)
def test_k11_plan_does_not_change_with_m(name, d, f):
    first = DO.ffn_plan(1, d, f)
    for m in range(2, 301):
        plan = DO.ffn_plan(m, d, f)
        assert (plan["fc1"], plan["fc2"]) == (first["fc1"], first["fc2"]), \
            f"{name}: the plan moved at M={m}"
        blocks = plan["blocks"]
        assert [r0 for r0, _ in blocks] == list(range(0, m, DO.FFN_ROWS))
        assert sum(n for _, n in blocks) == m
        assert all(1 <= n <= DO.FFN_ROWS for _, n in blocks)
        assert all(n == DO.FFN_ROWS for _, n in blocks[:-1])
    for which, (k, n) in (("fc1", (d, f)), ("fc2", (f, d))):
        p = first[which]
        assert p["slices"] == MS.gemm_slices(k, n)
        assert p["ranges"][0][0] == 0 and p["ranges"][-1][1] == k // MS.GEMM_TILE
        assert 2 <= p["stages"] <= DO.FFN_MAX_STAGES


def test_k11_plans_at_the_served_widths():
    """The slices and stages the card runs: large-v2's fc1 2 slices of 10
    chunks over 80 column tiles, fc2 7 slices over 20; tiny's 6 and 8."""
    got = {name: {w: (DO.ffn_plan(1, d, f)[w]["slices"], DO.ffn_plan(1, d, f)[w]["stages"])
                  for w in ("fc1", "fc2")} for name, d, f in WIDTHS}
    assert got == {"large-v2": {"fc1": (2, 3), "fc2": (7, 3)},
                   "tiny": {"fc1": (6, 2), "fc2": (8, 3)}}


def _weights(d, f, seed):
    rng = np.random.default_rng(seed)
    bf = lambda *shape, s=0.05: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).bfloat16()
    return bf(d, f), bf(f), bf(f, d), bf(d)


@pytest.mark.parametrize("m", [1, 176, 192, 193, 300, 401])
def test_blocked_ffn_is_the_plain_ffn(m):
    """The wrapper's row blocks, each through the plain version into its rows
    of the output, give the plain version over all rows."""
    d, f = 64, 256
    w1, b1, w2, b2 = _weights(d, f, m)
    x = torch.from_numpy(np.random.default_rng(m + 1).standard_normal((m, d))
                         .astype(np.float32)).bfloat16()
    got = DO.ffn_decode_blocked(
        x, lambda xb, yb: yb.copy_(DO.ffn_decode_plain(xb, w1, b1, w2, b2)))
    ref = DO.ffn_decode_plain(x, w1, b1, w2, b2)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
