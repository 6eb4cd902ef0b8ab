"""The whole decoder stack over one decode chunk — kernel K2.

Replaces the TPU kernel ``whisper_medusa_tpu/ops/megastep.py::_kernel``
(launched by ``fused_decoder_layers``): one pallas_call over a (layers,
phases) grid that streams every decoder weight through VMEM while the hidden
state stays resident.

The Hopper version (``csrc/megastep.cu``) is one C entry, ``wm_megastep_step``,
that launches twelve small kernels per layer on the current stream — layernorm,
a skinny tensor-core GEMM for q/k/v (and o, cross q/o, fc1, fc2) with fused
bias / scale / GELU / residual epilogues, self-attention with the in-place
K/V commit, and cross-attention split over 128-key chunks plus a combine —
so Python makes one ctypes call per decode step; the entry ends with the
final layer norm (``ln_post``) into a second buffer.  It is bound by bytes:
at large-v2 a step reads 1.47 GB of bf16 weights whatever B is, and
B x 246 MB of cross K/V (counted from the shapes).  The skinny GEMM reads each
weight once per step for all B*T rows, with the whole matrix in flight;
splitting cross-attention over the keys spreads a step over 240 x B CTAs.
Every kernel's per-row arithmetic is independent of B*T, so an example
decodes to the same bits alone or in a batch of eight.

int8 serving (the JAX kernel's ``quant`` / ``kv_quant`` / ``skv_quant``
mode) is a mode of the same entry: the eight streamed weights are int8 with
f32 per-column scales (W8A16: the skinny GEMM converts each 16x16 int8
fragment to bf16 through shared memory, multiplies the f32 sum by the
column's scale before the bias), the cross K/V are int8 with f32 per-(head,
position) scales (scores times the K scale before the softmax,
probabilities times the V scale before the PV product), and the self slabs
are int8 with bf16 per-(position, head) scales: the commit quantizes each
64-lane row with ``sc = max(amax, 1e-30) / 127`` and round-half-even,
attention reads the history rows as ``bf16(q * sc)`` and the chunk's own
rows as the fresh bf16 K/V.  At large-v2 the step then streams 0.73 GB of
weights and B x 123 MB of cross K/V (counted from the shapes).

The plain version is the ``models/whisper.py::decoder_layer_step`` loop
followed by ``layer_norm``.  Both update the self slabs (and scales) in place
and return ``(pre_norm, hidden)``.  Scope of the kernel: bf16 activations,
bf16 or int8 weights and caches, B <= 8, T <= 16 (so B*T <= 128), Dh = 64,
d_model and ffn_dim multiples of 256.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

from whisper_medusa_tpu_torch.ops import cuda_lib
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod

Params = Dict[str, Any]

MAX_B = 8
MAX_T = 16               # csrc/megastep.cu MAXT
MAX_ROWS = 128           # csrc/common.cuh SK_MAX_ROWS
CROSS_CHUNK = 128        # csrc/megastep.cu CS

launches = 0            # bf16 mode
q_launches = 0          # int8 mode

# Weight order of the C pointer table (csrc/megastep.cu MegastepPtr, from
# P_SELF_LN_S on).
_WEIGHTS = (("self_ln", "scale"), ("self_ln", "bias"), ("self", "q_w"),
            ("self", "q_b"), ("self", "k_w"), ("self", "v_w"), ("self", "v_b"),
            ("self", "o_w"), ("self", "o_b"), ("cross_ln", "scale"),
            ("cross_ln", "bias"), ("cross", "q_w"), ("cross", "q_b"),
            ("cross", "o_w"), ("cross", "o_b"), ("ffn_ln", "scale"),
            ("ffn_ln", "bias"), ("fc1_w",), ("fc1_b",), ("fc2_w",), ("fc2_b",))
# The streamed weights, in the order of their scale slots (P_Q_S ... P_FC2_S).
_QUANT = (("self", "q_w"), ("self", "k_w"), ("self", "v_w"), ("self", "o_w"),
          ("cross", "q_w"), ("cross", "o_w"), ("fc1_w",), ("fc2_w",))

def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def megastep_plain(dec_layers: Params, ln_post: Params, x, self_k, self_v, cross_k,
                   cross_v, offsets, chunk_mask, cross_len: int, num_heads: int,
                   cross_k_s=None, cross_v_s=None, self_s=None):
    """The decoder_layer_step loop (models/whisper.py), then ln_post."""
    from whisper_medusa_tpu_torch.models import whisper

    mask = whisper.make_step_mask(offsets, x.shape[1], self_k.shape[2], chunk_mask)
    at = lambda a, i: None if a is None else a[i]
    h = x
    for layer in range(self_k.shape[0]):
        h = whisper.decoder_layer_step(
            whisper.layer_params(dec_layers, layer), h, self_k[layer],
            self_v[layer], cross_k[layer], cross_v[layer], offsets, mask,
            num_heads, cross_len, cross_k_s=at(cross_k_s, layer),
            cross_v_s=at(cross_v_s, layer), self_s=at(self_s, layer))
    return h, whisper.layer_norm(h, ln_post["scale"], ln_post["bias"])


def megastep_kernel(dec_layers: Params, ln_post: Params, x, self_k, self_v, cross_k,
                    cross_v, offsets, chunk_mask, cross_len: int, num_heads: int,
                    cross_k_s=None, cross_v_s=None, self_s=None):
    """Launch K2 over all layers; returns (pre_norm, hidden), each (B, T, D).
    int8 mode when the weights are int8 (then the caches must be too)."""
    global launches, q_launches
    b, t, d = x.shape
    nl, _, s_len, _ = self_k.shape
    s_enc = cross_k.shape[4]
    quant = qmm_mod.is_quantized(dec_layers["self"]["q_w"])
    leaves = [_leaf(dec_layers, p) for p in _WEIGHTS]
    weights = [w["q"] if qmm_mod.is_quantized(w) else w for w in leaves]
    ln = [ln_post["scale"], ln_post["bias"]]
    f = dec_layers["fc1_b"].shape[-1]
    dev = x.device
    extra = [None] * (len(_QUANT) + 3)     # the int8 mode's scale slots, empty
    if not quant:
        cuda_lib.require_cuda("megastep", x, self_k, self_v, cross_k, cross_v, *weights, *ln)
    else:
        qw = [_leaf(dec_layers, p) for p in _QUANT]
        if (not all(qmm_mod.is_quantized(w) for w in qw) or self_s is None
                or cross_k_s is None or cross_v_s is None):
            raise ValueError("megastep kernel: int8 mode takes int8 streamed weights, "
                             "an int8 cross cache with scales and int8 self slabs "
                             "with self_s")
        plain = [w for w in leaves if not qmm_mod.is_quantized(w)]
        cuda_lib.require_cuda("megastep", x, *plain, *ln, self_s)
        cuda_lib.require_cuda("megastep", *[w["q"] for w in qw], self_k, self_v,
                              cross_k, cross_v, dtype=torch.int8, device=dev)
        cuda_lib.require_cuda("megastep", *[w["s"] for w in qw], cross_k_s, cross_v_s,
                              dtype=torch.float32, device=dev)
        if (cross_k_s.shape != (nl, b, num_heads, s_enc)
                or cross_v_s.shape != cross_k_s.shape
                or self_s.shape != (nl, b, s_len, 2 * num_heads)):
            raise ValueError("megastep kernel: scales must be (L, B, H, S_enc), "
                             "self_s (L, B, S, 2H)")
        extra = [w["s"] for w in qw] + [cross_k_s, cross_v_s, self_s]
    dh = d // num_heads
    if (b > MAX_B or t > MAX_T or dh != 64 or d % 256 or f % 256
            or self_k.shape != (nl, b, s_len, d) or self_v.shape != self_k.shape
            or cross_k.shape != (nl, b, num_heads, dh, s_enc)
            or cross_v.shape != (nl, b, s_enc, d)
            or s_enc % 4 or not 1 <= cross_len <= s_enc):
        raise ValueError(
            f"megastep kernel takes B <= {MAX_B}, T <= {MAX_T}, Dh=64, D and F multiples "
            f"of 256, S_enc % 4 == 0 and KVCache layouts; got x {tuple(x.shape)}, self "
            f"{tuple(self_k.shape)}, cross_k {tuple(cross_k.shape)}, F={f}")
    if offsets.dtype != torch.int32 or offsets.shape != (b,) or offsets.device != x.device:
        raise ValueError("offsets must be int32 (B,) on the kernel's device")
    if chunk_mask is None:
        chunk_mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))
    mask = chunk_mask.to(device=dev, dtype=torch.uint8).contiguous()
    nch = -(-cross_len // CROSS_CHUNK)
    bf = dict(dtype=torch.bfloat16, device=dev)
    m16 = -(-(b * t) // 16) * 16          # the skinny GEMM reads 16-row tiles
    xbuf = torch.zeros((m16, d), **bf)
    xbuf[:b * t] = x.reshape(b * t, d)
    scratch = [torch.zeros((m16, d), **bf) for _ in range(5)]
    hbuf = torch.zeros((m16, f), **bf)
    hidden = torch.empty((b * t, d), **bf)
    part = torch.empty((b * num_heads * t * nch * (dh + 2),), dtype=torch.float32,
                       device=dev)
    tensors = [xbuf, *scratch, hbuf, part, self_k, self_v, cross_k, cross_v,
               offsets, mask, *weights, *ln, hidden, *extra]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if tt is None else tt.data_ptr() for tt in tensors])
    ints = (ctypes.c_int * 9)(nl, b, t, d, num_heads, f, s_len, s_enc, cross_len)
    cuda_lib.launch("wm_megastep_step", dev, ptrs, ints)
    if quant:
        q_launches += 1
    else:
        launches += 1
    return xbuf[:b * t].reshape(b, t, d), hidden.reshape(b, t, d)


def fused_decoder_layers(dec_layers: Params, ln_post: Params, x: torch.Tensor,
                         self_k: torch.Tensor,
                         self_v: torch.Tensor, cross_k: torch.Tensor,
                         cross_v: torch.Tensor, offsets: torch.Tensor,
                         chunk_mask: Optional[torch.Tensor], cross_len: int,
                         num_heads: int, cross_k_s: Optional[torch.Tensor] = None,
                         cross_v_s: Optional[torch.Tensor] = None,
                         self_s: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All decoder layers over a (B, T, D) chunk at per-example ``offsets``,
    then ``ln_post`` ({"scale", "bias"}).

    Writes the chunk's K/V rows into ``self_k``/``self_v`` in place (and
    their scales into ``self_s`` in int8 serving) and returns (pre_norm,
    hidden), each (B, T, D).  CUDA tensors launch K2; CPU tensors run the
    plain layer loop."""
    fn = megastep_kernel if x.is_cuda else megastep_plain
    return fn(dec_layers, ln_post, x, self_k, self_v, cross_k, cross_v, offsets,
              chunk_mask, cross_len, num_heads, cross_k_s=cross_k_s,
              cross_v_s=cross_v_s, self_s=self_s)
