"""Weight-only int8 serving — kernels K6 (``qmm``) and K7 (``qmm_nt``), and
the quantization of a parameter tree (counterpart of
whisper_medusa_tpu/ops/qmm.py).

Scheme (the JAX package's): symmetric per-output-channel int8,
``w ≈ q * s`` with ``s = max|w| / 127`` over the contraction axis (1.0 where
the column is all zero), ``q = clip(round_half_even(w / s), ±127)``.
Activations stay bf16; the int8 values convert to bf16 exactly on the way
into the tensor cores (W8A16) and the f32 sum is multiplied by the column's
scale.  An int8 weight is the dict ``{"q": int8, "s": float32}``.

K6 replaces ``whisper_medusa_tpu/ops/qmm.py::_qmm_kernel`` (``qmm``):
``(bf16(x) @ bf16(wq)) * s`` -> f32 (M, N).  On the decode path it projects
each example's encoder output (1500, 1280) into the int8 cross K/V in
``init_cache`` and runs the int8 projections and FFN of the per-op step
(M = B T <= 176).  ``csrc/qmm.cu::wm_qmm`` computes Y^T = W^T x^T on
``wgmma`` (the weight gives its 64-row side, the batch rows its N side) from
a TMA ring: one producer warp loads the bf16 x tile and the int8 weight
tile, one consumer warpgroup converts the weight exactly to bf16 and runs
the products.  K is cut into slices chosen from (K, N) only, summed in a
fixed order: in registers when the grid is large (M = 1500), else one slice
per CTA into f32 scratch that this wrapper allocates
(``wm_qmm_scratch``) and a second kernel adds, with the same bits, so a
row's result never depends on M.  Bound at (1500, 1280, 1280): the 4.9
GFLOP of products (5 us at 989 TFLOP/s) over its 13.2 MB; at decode sizes
the weight stream.

K7 replaces ``_qmm_nt_kernel`` (``qmm_nt``): ``(bf16(x) @ bf16(wq)^T) * s``
for the int8 tied embedding (V, D), the vocab projection of the prefill, the
draft heads at B >= 2 and ``detect_language``.  ``csrc/qmm.cu::wm_qmm_nt``
is the weight stream of ``csrc/ntstream.cuh``, shared with K3
(``ops/logits.py``, the bf16 embedding): a persistent grid walks the
64-entry vocab tiles, a producer warp keeps a TMA ring of int8 E tiles and
the matching ``ceil(M / 16) * 16``-row x tiles in flight, a consumer
warpgroup converts each E tile exactly to bf16 in shared memory and runs
``wgmma`` (E the 64-row side, the rows rounded up to 16 its N side), and
the epilogue writes ``sum * s[v]`` from the accumulators.  The tiles and K
chunks come from (V, D) alone (:func:`nt_plan`, both kernels' tiling), and
every x tile runs the same instruction, so a row's bits do not depend on M.
Bound by bytes: the 66 MB int8 embedding plus the f32 output.

Both wrappers cast ``x`` to bf16 first, as the JAX functions do; CUDA
tensors then launch the kernel, CPU tensors take the plain version.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from whisper_medusa_tpu_torch.ops import cuda_lib

Params = Dict[str, Any]

TILE = 64                # csrc/qmm.cu QT, csrc/ntstream.cuh NT_VT
MAX_NT_ROWS = 192        # rows per K7 / K3 launch (csrc/ntstream.cuh NT_MAX_MT x 16)
NT_CHUNK = 64            # the stream's K chunk (csrc/ntstream.cuh NT_KC): D % 64 == 0

launches = 0             # K6 (wm_qmm) launches
nt_launches = 0          # K7 (wm_qmm_nt) launches


def is_quantized(w) -> bool:
    return isinstance(w, dict)


def wmap(w, fn):
    """Apply ``fn`` to a weight, or to both tensors of an int8 weight (their
    leading dims match, so slicing them alike keeps q and s paired)."""
    if is_quantized(w):
        return {"q": fn(w["q"]), "s": fn(w["s"])}
    return fn(w)


def quantize_array(w: torch.Tensor, axis: int = -2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the contraction ``axis``: (int8 values, f32 scales with
    ``axis`` removed).  ``torch.round`` rounds half to even, as ``jnp.round``."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def qmm_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(M, K) @ dequant((K, N) int8) -> (M, N) f32: bf16 operands, exact
    products, f32 sums, times the column scale."""
    return (x.to(torch.bfloat16).float() @ wq.float()) * scale.float()


def qmm_nt_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(M, K) @ dequant((N, K) int8)^T -> (M, N) f32."""
    return (x.to(torch.bfloat16).float() @ wq.float().T) * scale.float()


def _check_weight(name, x, wq, scale, n):
    cuda_lib.require_cuda(name, x)
    cuda_lib.require_cuda(name, wq, dtype=torch.int8, device=x.device)
    cuda_lib.require_cuda(name, scale, dtype=torch.float32, device=x.device)
    if scale.shape != (n,):
        raise ValueError(f"{name}: scales must be ({n},), got {tuple(scale.shape)}")


def nt_plan(m: int, v: int, d: int) -> Dict[str, int]:
    """The tiling of the tied-embedding stream at (M, V, D), K7's and K3's
    (csrc/ntstream.cuh ``nt_launch``): ``tiles`` 64-entry vocab tiles, each
    summed over ``chunks`` 64-wide K chunks in order, for every one of
    ``launches`` launches of up to ``MAX_NT_ROWS`` rows; ``row_tiles``
    16-row x tiles of the first launch.  What decides an output's sum —
    tiles and chunks — reads V and D only."""
    if m < 1 or d % NT_CHUNK or d < NT_CHUNK or v < 1:
        raise ValueError(f"qmm_nt takes M >= 1, V >= 1 and D % {NT_CHUNK} == 0")
    return {"tiles": -(-v // TILE), "chunks": d // NT_CHUNK,
            "row_tiles": -(-min(m, MAX_NT_ROWS) // 16),
            "launches": -(-m // MAX_NT_ROWS)}


def nt_blocks(m: int, v: int, d: int):
    """(first row, rows) of each launch of the stream (:func:`nt_plan`)."""
    plan = nt_plan(m, v, d)
    return [(i * MAX_NT_ROWS, min(MAX_NT_ROWS, m - i * MAX_NT_ROWS))
            for i in range(plan["launches"])]


def qmm_kernel(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch K6: x (M, K) bf16, wq (K, N) int8, scale (N,) f32 -> (M, N) f32."""
    global launches
    m, k = x.shape
    n = wq.shape[1]
    _check_weight("qmm", x, wq, scale, n)
    if wq.shape[0] != k or k % TILE or n % TILE or m < 1:
        raise ValueError(f"qmm kernel takes K and N multiples of {TILE}; got x "
                         f"{tuple(x.shape)}, wq {tuple(wq.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    floats = cuda_lib.lib().wm_qmm_scratch(m, k, n)
    if floats < 0:
        raise ValueError(f"qmm kernel: no plan for (M, K, N) = ({m}, {k}, {n})")
    scratch = torch.empty((floats,), dtype=torch.float32, device=x.device) if floats else None
    cuda_lib.launch("wm_qmm", x.device, x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                    m, k, n)
    launches += 1
    return out


def qmm_nt_kernel(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch K7: x (M, K) bf16, wq (N, K) int8, scale (N,) f32 -> (M, N)
    f32; rows in blocks of up to 192, one launch each (:func:`nt_plan`)."""
    global nt_launches
    m, k = x.shape
    n = wq.shape[0]
    _check_weight("qmm_nt", x, wq, scale, n)
    if wq.shape[1] != k or k % NT_CHUNK or m < 1:
        raise ValueError(f"qmm_nt kernel takes K % {NT_CHUNK} == 0; got x {tuple(x.shape)}, "
                         f"wq {tuple(wq.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    for r0, rows in nt_blocks(m, n, k):
        cuda_lib.launch("wm_qmm_nt", x.device, x[r0:].data_ptr(), wq.data_ptr(),
                        scale.data_ptr(), out[r0:].data_ptr(), rows, n, k)
        nt_launches += 1
    return out


def qmm(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(wq)`` with f32 accumulation, (M, N) f32.  CUDA tensors
    launch K6; CPU tensors take the plain version."""
    x = x.to(torch.bfloat16).contiguous()
    fn = qmm_kernel if x.is_cuda else qmm_plain
    return fn(x, wq, scale)


def qmm_nt(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(wq).T`` (the int8 tied-embedding projection), (M, N)
    f32.  CUDA tensors launch K7; CPU tensors take the plain version."""
    x = x.to(torch.bfloat16).contiguous()
    fn = qmm_nt_kernel if x.is_cuda else qmm_nt_plain
    return fn(x, wq, scale)


def matmul_plain(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` as float32 over the last axis of ``x`` in plain PyTorch on
    any device: exact f32 products for a plain weight, :func:`qmm_plain`
    for an int8 one (the plain decoder step that K2 is held against)."""
    if not is_quantized(w):
        return x.float() @ w.float()
    k = w["q"].shape[0]
    y = qmm_plain(x.reshape(-1, k), w["q"], w["s"])
    return y.reshape(*x.shape[:-1], y.shape[-1])


# ---------------------------------------------------------------------------
# Parameter-tree quantization
# ---------------------------------------------------------------------------

_LAYER_WEIGHTS = ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w")


def quantize_layers(tree: Params) -> Params:
    """Quantize every ``*_w`` leaf of a (stacked, or single) decoder-layer
    tree on its contraction axis; every other leaf, and a weight that is
    int8 already, is kept."""
    out = {}
    for k, v in tree.items():
        if k in _LAYER_WEIGHTS:
            out[k] = _quantized(v, -2)
        elif isinstance(v, dict):
            out[k] = quantize_layers(v)
        else:
            out[k] = v
    return out


def _quantized(w, axis: int):
    """``w`` as an int8 weight; a weight that already is one is kept as it
    is, so quantizing a quantized tree changes nothing."""
    if is_quantized(w):
        return w
    q, s = quantize_array(w, axis=axis)
    return {"q": q, "s": s}


def quantize_decoder(params: Params, medusa_params: Optional[Params] = None
                     ) -> Tuple[Params, Optional[Params]]:
    """Int8-quantize the decode-path weights: every decoder layer weight,
    the Medusa-Block layer's (``block``, like a decoder layer) and the
    Medusa heads on their contraction axis (-2: heads (H, L, D, D) give
    scales (H, L, D)), the tied embedding (V, D) on -1 (scales (V,)).  The
    encoder, layer norms, biases and positional embeddings are shared with
    the input tree, not copied; weights that are int8 already are kept."""
    params = dict(params)
    dec = dict(params["decoder"])
    dec["layers"] = quantize_layers(dec["layers"])
    dec["embed_tokens"] = _quantized(dec["embed_tokens"], -1)
    params["decoder"] = dec
    if medusa_params is not None:
        medusa_params = dict(medusa_params)
        heads = dict(medusa_params["heads"])
        heads["w"] = _quantized(heads["w"], -2)
        medusa_params["heads"] = heads
        if "block" in medusa_params:
            medusa_params["block"] = quantize_layers(medusa_params["block"])
    return params, medusa_params
