"""K2's layer norms folded into its projections' X path, checked on the CPU.

On the card the q/k/v, cross-q and fc1 GEMMs of ``csrc/wgemm.cuh`` (their
LN mode) normalize the raw residual stream themselves: each CTA of a column
tile's cluster takes its K slice's per-row (mean, M2), and the slices are
combined in rank order (Chan's formula).  ``ops/megastep.py::ln_fold_stats``
mirrors that arithmetic in f32.  Here it is held against the JAX kernel's
``_ln`` (``whisper_medusa_tpu/ops/megastep.py``) to within one bf16 ulp of
the normalized output, also on rows with a large mean offset; a row's
statistics are shown to be bitwise the same at M = 1, 11 and 88; and the
slices are those of the GEMM each norm feeds (``gemm_slices``).  The C
sources are read to show the fold is in place: one ``ln_rows`` launch a
step (ln_post), the LN mode's lane count equal to the mirror's.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_medusa_tpu.ops import megastep as jmegastep
from whisper_medusa_tpu_torch.config import WhisperDims
from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import megastep as MS

LARGE_V2 = (1280, 5120)


def _rows(rng, m, d, offset):
    x = offset + rng.standard_normal((m, d))
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _ulps(a, b, floor):
    """|a - b| in units of the bf16 spacing at max(|a|, |b|, floor)."""
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(floor)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return ((a - b).abs() / ulp).max().item()


@pytest.mark.parametrize("d,f", [LARGE_V2, (256, 1024), (768, 3072)])
@pytest.mark.parametrize("offset", [0.0, 1e3])
def test_folded_norm_matches_jax_ln(d, f, offset):
    rng = np.random.default_rng(d + int(offset))
    x = _rows(rng, 11, d, offset)
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(d)).astype(np.float32))
    scale, bias = scale.bfloat16().float(), bias.bfloat16().float()
    ref = np.asarray(jmegastep._ln(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                   jnp.asarray(scale.numpy())[None],
                                   jnp.asarray(bias.numpy())[None]).astype(jnp.float32))
    ref = torch.from_numpy(ref.copy())
    # Rows near 1e3 put an f32 mean's rounding (~1e-5 here, on either side)
    # into every output: below 1/16 a bf16 ulp is finer than that, so
    # elements there are held to the ulp at 1/16.  Unit rows: every element
    # to its own ulp.
    floor = 2.0 ** -4 if offset else 2.0 ** -126
    for name, slices in MS.ln_slices(d, f).items():
        mean, rstd = MS.ln_fold_stats(x, slices)
        got = ((x.float() - mean[:, None]) * rstd[:, None] * scale + bias).bfloat16()
        assert _ulps(got, ref, floor) <= 1.0, f"{name} ({slices} slices)"


@pytest.mark.parametrize("slices", [1, 2, 3, 7])
def test_statistics_do_not_depend_on_m(slices):
    rng = np.random.default_rng(slices)
    x = _rows(rng, 88, 1280, 0.5)
    x[40:] = _rows(rng, 48, 1280, 1e3)
    mean88, rstd88 = MS.ln_fold_stats(x, slices)
    for m in (1, 11):
        mean, rstd = MS.ln_fold_stats(x[:m], slices)
        assert torch.equal(mean, mean88[:m]) and torch.equal(rstd, rstd88[:m])
    # ... and agree with an f64 two-pass over the whole row.
    x64 = x.double()
    want = torch.rsqrt(x64.var(dim=1, unbiased=False) + 1e-5)
    assert torch.allclose(mean88.double(), x64.mean(dim=1), rtol=1e-6, atol=1e-4)
    assert torch.allclose(rstd88.double(), want, rtol=1e-5)


def test_slices_are_the_fed_gemms():
    for d, f in (LARGE_V2, (256, 1024), (1024, 4096)):
        assert MS.ln_slices(d, f) == {"self": MS.gemm_slices(d, d, 3),
                                      "cross": MS.gemm_slices(d, d, 1),
                                      "ffn": MS.gemm_slices(d, f, 1)}
    assert MS.ln_slices(*LARGE_V2) == {"self": 3, "cross": 7, "ffn": 2}
    # A lane holds the longest slice's pieces: large-v2's fc1 (10 chunks)
    # is the longest K2 takes; a norm past it routes to the per-op step.
    assert MS.ln_longest_slice(*LARGE_V2) == MS.LN_MAX_CHUNKS
    for d, f in ((512, 2048), (768, 3072), (1024, 4096)):
        assert MS.ln_longest_slice(d, f) <= MS.LN_MAX_CHUNKS
    layers = {"fc1_b": torch.zeros((1, 5120))}
    x, ck = torch.zeros((1, 11, 1280)), torch.zeros((1, 1, 20, 64, 1500))
    assert MS.fits(layers, x, torch.zeros((1, 1, 460, 1280)), ck, 20)
    assert MS.ln_longest_slice(2048, 4096) > MS.LN_MAX_CHUNKS
    assert not MS.fits({"fc1_b": torch.zeros((1, 4096))}, torch.zeros((1, 11, 2048)),
                       torch.zeros((1, 1, 460, 2048)), torch.zeros((1, 1, 32, 64, 1500)), 32)
    # chip_smoke.py's 2-layer checks run at the default (large-v2) widths.
    dims = WhisperDims(decoder_layers=2)
    assert MS.ln_slices(dims.d_model, dims.decoder_ffn_dim) == MS.ln_slices(*LARGE_V2)


def _source(name):
    with open(os.path.join(cuda_lib.CSRC_DIR, name)) as f:
        return f.read()


def test_the_fold_is_in_the_sources():
    wgemm, mega = _source("wgemm.cuh"), _source("megastep.cu")
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", wgemm)}
    assert consts["G_LN_LANES"] == MS.LN_LANES
    assert consts["G_LN_MAXP"] == MS.LN_MAX_CHUNKS
    assert "template <int MT, bool W8, bool LN, bool HEADS = false>" in wgemm
    # ln_rows is launched once a step (ln_post) and never inside a layer;
    # the three fed GEMMs take the residual stream in LN mode.
    assert len(re.findall(r"WM_TRY\(ln_rows\(", mega)) == 1
    layer = mega[mega.index("int layer_step("):mega.index("}  // namespace\n}  // namespace wm")]
    assert "ln_rows" not in layer
    assert layer.count("const LnArgs ") == 3 and layer.count("_ln));") == 3
    assert "P_XA" not in mega
