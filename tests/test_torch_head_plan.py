"""The plan of K4's stage A and ``wm_head_rows`` on the weight-streaming
GEMM's heads mode, and the rows' plain version against the JAX kernel's row
construction.

Both entries launch ``csrc/wgemm.cuh::wgemm_heads_launch``: the head is the
grid's z, and each head row's sum is cut into K slices
(``head_slices``, mirrored by ``ops/verify.py::head_plan``) and added in rank
order.  The two-pass loop holds its B=8 tokens to the B=1 decode, so head
0's bits must not depend on M, on the number of heads in the launch or on
which entry launched it: the plan's slices and chunk ranges are held equal
for every M from 1 to the launch cap and every head count from 1 to 11, at
whisper-large-v2's and whisper tiny's widths.  The Python constants must
match the C sources'.  ``head_rows_plain`` (the CPU path and the kernels'
reference) is held to the rows the JAX ``_kernel_hidden`` builds at its grid
step 0, run in interpret mode, at tiny's width, bf16 and int8.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_medusa_tpu.ops import verify as jverify
from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import megastep as MS
from whisper_medusa_tpu_torch.ops import qmm as QM
from whisper_medusa_tpu_torch.ops import verify as VF

WIDTHS = (("large-v2", 1280), ("tiny", 384))


def _constants(source):
    with open(os.path.join(cuda_lib.CSRC_DIR, source)) as f:
        text = f.read()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_python_constants_match_the_sources():
    wg, ver = _constants("wgemm.cuh"), _constants("verify.cu")
    assert wg["G_MAX_MT"] * 16 == VF.MAX_SRC_ROWS
    assert wg["H_STAGES"] == VF.HEAD_STAGES
    assert ver["VH_MAX_SRC"] == VF.MAX_SRC
    assert ver["VH_MAX_ROWS"] == VF.MAX_R


def test_head_slices_follow_the_gemm_rule_of_one_job():
    """The C rule is ``head_slices(k, n) = gemm_slices(k, n, 1)``: never the
    head count (as ``jobs``), which would give head 0 other slices in an
    11-head launch."""
    with open(os.path.join(cuda_lib.CSRC_DIR, "wgemm.cuh")) as f:
        text = f.read()
    assert re.search(r"inline int head_slices\(int k, int n\) \{ return gemm_slices\(k, n, 1\); \}",
                     text)
    assert "head_slices(k, n)" in text.split("int wgemm_heads_launch", 1)[1]


@pytest.mark.parametrize("name,d", WIDTHS)
def test_head_plan_does_not_change_with_m_or_heads(name, d):
    first = VF.head_plan(1, d, 1)
    for nh in range(1, 12):
        for m in range(1, VF.MAX_SRC_ROWS + 1):
            plan = VF.head_plan(m, d, nh)
            assert (plan["slices"], plan["ranges"]) == (first["slices"], first["ranges"]), \
                f"{name}: the plan moved at M={m}, {nh} heads"
            assert plan["blocks"] == [(0, m)]
            (launch,) = plan["launches"]
            assert launch["grid"] == (first["slices"], d // 64, nh)
            assert launch["row_tiles"] == -(-m // 16)
    chunks = d // 64
    ranges = first["ranges"]
    assert ranges[0][0] == 0 and ranges[-1][1] == chunks
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))


def test_head_slices_of_the_widths():
    """large-v2: 7 slices x 20 column tiles (140 CTAs for one head, 1540 in
    clusters of 7 for eleven); tiny: 6 x 6, one 64-wide chunk a slice."""
    assert VF.head_plan(88, 1280)["slices"] == MS.gemm_slices(1280, 1280, 1) == 7
    assert VF.head_plan(11, 1280, 11)["launches"][0]["grid"] == (7, 20, 11)
    assert VF.head_plan(88, 384)["slices"] == 6
    assert VF.head_plan(88, 384)["ranges"] == [(i, i + 1) for i in range(6)]


@pytest.mark.parametrize("m", [193, 300, 385])
def test_head_plan_blocks_rows_past_one_launch(m):
    plan = VF.head_plan(m, 1280, 1)
    blocks = plan["blocks"]
    assert [r0 for r0, _ in blocks] == list(range(0, m, VF.MAX_SRC_ROWS))
    assert sum(n for _, n in blocks) == m
    assert all(n == VF.MAX_SRC_ROWS for _, n in blocks[:-1])
    assert [x["rows"] for x in plan["launches"]] == [n for _, n in blocks]


def _jax_rows(src, hw, hws, hb, hquant):
    """The (R, D) rows JAX's ``_kernel_hidden`` builds at grid step 0
    (``rows[k] = src + SiLU(src @ W_k + b_k)``), read back by running that
    step alone in interpret mode with its row scratch as a fifth output."""
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    bn, d = src.shape
    nh = hw.shape[0]
    r = nh * bn
    r_pad = max(8, -(-r // 8) * 8)
    v = 8
    kern = functools.partial(
        jverify._kernel_hidden, v=v, n_verif=0, kp1=nh, bn=bn, identity0=False,
        begin_index=0, eos_id=0, decay=None, ts_cfg=None, quant=False, hquant=hquant)
    stat = jax.ShapeDtypeStruct((r_pad, 128), jnp.float32)
    meta = jnp.zeros((r_pad, 128), jnp.int32)
    full = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))
    outs = pl.pallas_call(
        kern, grid=(1,),
        in_specs=[full((bn, d)), full((bn, d)), full((nh, d, d)), full((nh, d)),
                  full((nh, d))] + [full((r_pad, 128))] * 5
                 + [full((v, d)), full((1, v)), full((2, v))],
        out_specs=[full((r_pad, 128))] * 4 + [full((r_pad, d))],
        out_shape=[stat, stat, jax.ShapeDtypeStruct((r_pad, 128), jnp.int32), stat,
                   jax.ShapeDtypeStruct((r_pad, d), jnp.bfloat16)],
        scratch_shapes=[pltpu.VMEM((r_pad, 128), jnp.float32),
                        pltpu.VMEM((r_pad, 128), jnp.float32),
                        pltpu.VMEM((r_pad, 128), jnp.int32),
                        pltpu.VMEM((r_pad, 128), jnp.float32)],
        interpret=True,
    )(src, src, hw, hws, hb, meta, meta, meta, meta, meta,
      jnp.zeros((v, d), jnp.bfloat16), jnp.ones((1, v), jnp.float32),
      jnp.zeros((2, v), jnp.int8))
    return np.asarray(outs[4][:r].astype(jnp.float32))


@pytest.mark.parametrize("int8", [False, True])
def test_head_rows_plain_matches_jax_row_construction_at_tiny_width(int8):
    """``head_rows_plain`` at D = 384 (whisper tiny), 10 heads x 11 source
    rows, against the rows of the JAX kernel's stage: within 3e-2 (bf16)."""
    d, m, nh = 384, 11, 10
    rng = np.random.default_rng(15 + int8)
    src = rng.standard_normal((m, d)).astype(np.float32)
    w = (rng.standard_normal((nh, d, d)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((nh, d)) * 0.1).astype(np.float32)
    jsrc = jnp.asarray(src, jnp.bfloat16)
    tsrc = torch.from_numpy(np.array(jsrc.astype(jnp.float32))).bfloat16()
    if int8:
        q, s = QM.quantize_array(torch.from_numpy(w), axis=-2)
        tw = {"q": q, "s": s}
        jw, jws = jnp.asarray(q.numpy()), jnp.asarray(s.numpy())
    else:
        jw = jnp.asarray(w, jnp.bfloat16)
        jws = jnp.ones((nh, d), jnp.float32)
        tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).bfloat16()
    ref = _jax_rows(jsrc, jw, jws, jnp.asarray(b), int8).reshape(nh, m, d)
    got = VF.head_rows(tsrc, tw, torch.from_numpy(b))
    assert got.shape == (nh, m, d) and got.dtype == torch.bfloat16
    assert VF.head_launches == 0 and VF.q_head_launches == 0
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=3e-2, atol=3e-2)
