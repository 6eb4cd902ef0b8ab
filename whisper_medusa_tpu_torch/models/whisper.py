"""Whisper encoder and KV-cached decoder — counterpart of
whisper_medusa_tpu/models/whisper.py.

Layouts are the JAX package's, so parameters bridge without reshaping:
weights are stored (in, out), the transformer layers are stacked (L, ...), the
self-KV slabs are head-flat (L, B, S, D), cross K is head-major
(L, B, H, Dh, S_enc) and cross V head-flat (L, B, S_enc, D).  Unlike the TPU
package the slabs carry no alignment slack: ``max_len`` rows exactly, and the
cross cache is never padded.

Decode runs through ``ops/megastep.py`` (kernel K2 on CUDA tensors, the
:func:`decoder_layer_step` loop on CPU tensors) where K2 takes the call
(bf16 or int8 weights, B <= 8, T <= 16, ``megastep.fits``), else through the
per-op step :func:`decoder_layers_ops` (cuBLAS projections, or the f32 GEMM
for f32 weights, K10's mask mode for the self-attention, K10
cross-attention, K11 FFN), with the Medusa-Block layer
as one more layer on its own cache slot when given; the cache slabs are
updated in place.  Beam search (``cross_beam``) always takes the per-op
step: B * K self rows, B cross rows, each example's beams' queries folded
into one cross-attention block.  Encoder self-attention runs through
``ops/attention.py`` (K1).  An example's decoder state does not depend on the batch it is in:
the cross K/V are projected one example at a time, and K2's and K10's
per-row arithmetic is independent of the row count.

f32 weights (ModelConfig's default, as in the JAX package) run every step
on the per-op step with the f32 modes of K10 and K11 and the f32 GEMM, the
encoder on cuBLAS f32 (full f32: PyTorch's default leaves TF32 off) and K1's
f32 mode; :func:`layer_norm`, :func:`embed_lookup` and the caches take the
weights' dtype.

Tensor parallelism (``model.shard(tp=)``, ``parallel/mesh.py``): under an
ambient mesh whose model axis is split, a layer's q/k/v and fc1 weights
hold this rank's output columns and o / fc2 its input rows, so every
attention runs on this rank's heads (:func:`_local_heads`, read from the
weights' shapes) and the caches hold them; the row-parallel outputs are
summed over the model group with the bias added once after the sum
(:func:`_row_out`), and K2 is never taken (the per-op step runs, as JAX's
scan path under a model axis).  The tied embedding is whole on every rank.

int8 serving (``ops/qmm.py::quantize_decoder``): a weight may be the dict
``{"q": int8, "s": float32}``; :func:`dense` then runs ``qmm`` (K6), the
embedding gathers dequantized rows and :func:`project_logits` runs
``qmm_nt`` (K7).  The cache then holds int8 cross K/V with f32
per-(head, position) scales and int8 self slabs with bf16 per-(position,
head) scales (``KVCache``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, create_selective_checkpoint_contexts,
                                    noop_context_fn)

from whisper_medusa_tpu_torch.config import WhisperDims
from whisper_medusa_tpu_torch.ops import attention as attn_mod
from whisper_medusa_tpu_torch.ops import decode_ops
from whisper_medusa_tpu_torch.ops import gelu as gelu_mod
from whisper_medusa_tpu_torch.ops import logits as logits_mod
from whisper_medusa_tpu_torch.ops import qmm as qmm_mod
from whisper_medusa_tpu_torch.parallel import mesh as mesh_mod

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Primitive blocks
# ---------------------------------------------------------------------------

def sinusoidal_positions(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal encoder positional embedding (float32)."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float32,
                                        device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm with float32 statistics, returned in ``x.dtype``.

    On the card (x, scale and bias of one dtype) it is ``F.layer_norm``, whose
    kernel reduces each row in one block: a row's statistics do not depend on
    how many rows the call has.  The two-pass ``mean`` below does not promise
    that on the card (PyTorch splits a reduction over more CTAs when it has
    few rows), and the per-op decoder step must give an example the same
    bits at B=1 as in a batch."""
    if x.is_cuda and scale.dtype == bias.dtype == x.dtype:
        return F.layer_norm(x, (x.shape[-1],), scale, bias, 1e-5)
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as float32.  On the GPU a bf16 product runs on the tensor cores
    (f32 accumulation, one bf16 rounding of the product); elsewhere in f32.
    Unlike ``qmm.matmul_plain`` (exact f32 products on every device), it keeps
    the encoder's GEMMs on the bf16 tensor cores."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch.matmul(x, w).float()
    return x.float() @ w.float()


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w + b rounded once to ``x.dtype``; an int8 ``w`` goes through
    ``qmm`` (its scale multiplies the f32 sum before the bias)."""
    if qmm_mod.is_quantized(w):
        y = qmm_mod.qmm(x.reshape(-1, x.shape[-1]), w["q"], w["s"])
        y = y.reshape(*x.shape[:-1], y.shape[-1])
    else:
        y = _mm_f32(x, w)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def dense_step(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-op decoder step's projections: :func:`dense`, except that f32
    operands on the card go through the f32 GEMM (``decode_ops.gemm_f32``,
    FFMA, K slices from (K, N) alone).  cuBLAS picks another f32 kernel at
    another row count, so its rows' bits depend on B (seen on the H100 at
    every decode shape), and the step must give an example its B=1 bits."""
    if x.is_cuda and x.dtype == torch.float32 and not qmm_mod.is_quantized(w):
        return decode_ops.gemm_f32(x, w, b)
    return dense(x, w, b)


def dense_exact(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w + b with exact f32 products and one rounding to ``x.dtype`` on
    every device — the JAX ``preferred_element_type=f32`` semantics, used by
    the plain decoder step that the megastep kernel is held against."""
    y = qmm_mod.matmul_plain(x, w)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _vocab_rows(embed) -> int:
    """The embedding's row count, bf16 or int8 (``{"q", "s"}``)."""
    return (embed["q"] if qmm_mod.is_quantized(embed) else embed).shape[0]


def embed_lookup(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding gather; an int8 embedding gives
    ``bf16(q[tok]) * bf16(s[tok])``."""
    if qmm_mod.is_quantized(embed):
        rows = embed["q"][tokens].to(torch.bfloat16)
        return rows * embed["s"][tokens][..., None].to(torch.bfloat16)
    return embed[tokens]


def _local_heads(w, num_heads: int) -> int:
    """The heads that a (..., D, cols) q/k/v weight's output columns hold:
    ``num_heads``, or num_heads / tp on a tensor-parallel shard."""
    a = w["q"] if qmm_mod.is_quantized(w) else w
    return num_heads * a.shape[-1] // a.shape[-2]


def _row_out(fn, b: Optional[torch.Tensor]) -> torch.Tensor:
    """A row-parallel projection's output ``fn(b)``; under tensor
    parallelism this rank's partial ``fn(None)`` summed over the model group
    in f32, the bias added once after the sum, in the partial's dtype."""
    if mesh_mod.model_parallel() is None:
        return fn(b)
    y = fn(None)
    r = mesh_mod.reduce_from_model(y.float())
    if b is not None:
        r = r + b.float()
    return r.to(y.dtype)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], num_heads, x.shape[-1] // num_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def attention_with_probs(q, k, v, mask: Optional[torch.Tensor] = None):
    """Plain attention, q/k/v (B, T, H, Dh), mask broadcastable to
    (B, H, Tq, Tk) with True = keep: (out (B, Tq, H, Dh), the f32 softmax
    probabilities (B, H, Tq, Tk)).  P is rounded to the value dtype before
    P @ V, which sums in f32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask is not None:
        logits = torch.where(mask, logits, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype), probs


def attention(q, k, v, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`attention_with_probs`' output alone."""
    return attention_with_probs(q, k, v, mask)[0]


def _proj_bhsd(x: torch.Tensor, w, b, num_heads: int) -> torch.Tensor:
    """(B, S, Din) -> head-major (B, H, S, Dh)."""
    y = _mm_f32(x, w)
    if b is not None:
        y = y + b.float()
    y = _split_heads(y.to(x.dtype), num_heads)
    return y.permute(0, 2, 1, 3).contiguous()


def _out_proj_bhsd(out: torch.Tensor, w, b, num_heads: int) -> torch.Tensor:
    """(B, H, S, Dh) @ o_w -> (B, S, D)."""
    flat = _merge_heads(out.permute(0, 2, 1, 3))
    return _row_out(lambda bias: dense(flat, w, bias), b)


def _attn_full(lp: Params, x: torch.Tensor, kv_src: torch.Tensor, num_heads: int,
               causal: bool, kv_len: Optional[int], with_probs: bool):
    """Full-sequence attention of ``x`` over ``kv_src``: (B, T, D), and with
    ``with_probs`` also the f32 probabilities (B, H, T, S).

    Float weights: head-major projections and K1 on the card (the plain
    version on the CPU); the probabilities are the f32 softmax of the same
    q and k (``attention_probs``), so asking for them does not change the
    output.  int8 weights (the decoder of ``quantize()``, whose keys are
    never padded): JAX's int8 branch, :func:`dense` (K6) projections and the
    plain :func:`attention_with_probs`, whose probabilities are the ones
    applied.  Under tensor parallelism this rank's heads, the
    probabilities gathered over the model group."""
    head_dim = x.shape[-1] // num_heads
    num_heads = _local_heads(lp["q_w"], num_heads)
    same = kv_src is x
    x = mesh_mod.copy_to_model(x)
    kv_src = x if same else mesh_mod.copy_to_model(kv_src)
    if qmm_mod.is_quantized(lp["q_w"]):
        q = _split_heads(dense(x, lp["q_w"], lp["q_b"]), num_heads) * (head_dim ** -0.5)
        k = _split_heads(dense(kv_src, lp["k_w"]), num_heads)
        v = _split_heads(dense(kv_src, lp["v_w"], lp["v_b"]), num_heads)
        t = x.shape[1]
        mask = (torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))[None, None]
                if causal else None)
        out, probs = attention_with_probs(q, k, v, mask)
        flat = _merge_heads(out)
        out = _row_out(lambda bias: dense(flat, lp["o_w"], bias), lp["o_b"])
        return (out, mesh_mod.gather_heads(probs, 1)) if with_probs else out
    kv_len = kv_src.shape[1] if kv_len is None else kv_len
    q = _proj_bhsd(x, lp["q_w"], lp["q_b"], num_heads) * (head_dim ** -0.5)
    k = _proj_bhsd(kv_src, lp["k_w"], None, num_heads)
    v = _proj_bhsd(kv_src, lp["v_w"], lp["v_b"], num_heads)
    out = _out_proj_bhsd(attn_mod.full_attention_bhsd(q, k, v, kv_len=kv_len, causal=causal),
                         lp["o_w"], lp["o_b"], num_heads)
    if not with_probs:
        return out
    return out, mesh_mod.gather_heads(attn_mod.attention_probs(q, k, kv_len, causal), 1)


def self_attn_full(lp: Params, x: torch.Tensor, num_heads: int, causal: bool,
                   kv_len: Optional[int] = None) -> torch.Tensor:
    """Full-sequence self-attention (encoder, or teacher-forced decoder):
    K1 on the card; int8 weights through K6 and the plain attention."""
    return _attn_full(lp, x, x, num_heads, causal, kv_len, False)


def cross_attn_full(lp: Params, x: torch.Tensor, enc: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """Teacher-forced cross-attention, T queries against the unpadded
    encoder frames (K1, and K9 in the backward, take the ragged 1500)."""
    return _attn_full(lp, x, enc, num_heads, False, None, False)


def self_attn_probs(lp: Params, x: torch.Tensor, num_heads: int):
    """Causal self-attention that also returns its probabilities: (out
    (B, T, D), probs (B, H, T, T) float32), the maps of the JAX package's
    ``decoder_attentions``.  The output is :func:`self_attn_full`'s, bit
    for bit (K1 on the card for float weights)."""
    return _attn_full(lp, x, x, num_heads, True, None, True)


def cross_attn_probs(lp: Params, x: torch.Tensor, enc: torch.Tensor, num_heads: int):
    """Cross-attention that also returns its probabilities: (out (B, T, D),
    probs (B, H, T, S) float32), the maps DTW word timestamps align
    (``decoding/word_timestamps.py``).  The output is
    :func:`cross_attn_full`'s, bit for bit."""
    return _attn_full(lp, x, enc, num_heads, False, None, True)


def ffn(lp: Params, x: torch.Tensor) -> torch.Tensor:
    h = gelu_mod.gelu(dense(mesh_mod.copy_to_model(x), lp["fc1_w"], lp["fc1_b"]))
    return _row_out(lambda bias: dense(h, lp["fc2_w"], bias), lp["fc2_b"])


def layer_params(stacked: Params, index: int) -> Params:
    """Slice layer ``index`` out of a stacked (L, ...) parameter tree."""
    return {k: (layer_params(v, index) if isinstance(v, dict) else v[index])
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def conv1d_stem(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                stride: int) -> torch.Tensor:
    """k=3, pad=1 1-D convolution as an im2col matmul, then GELU.
    x: (B, T, C_in); w: (3, C_in, C_out); -> (B, ceil(T/stride), C_out)."""
    t = x.shape[1]
    t_out = -(-t // stride)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1))
    taps = []
    for w0 in range(3):
        s = xp[:, w0:w0 + stride * (t_out - 1) + 1:stride]
        if s.shape[1] < t_out:
            s = torch.nn.functional.pad(s, (0, 0, 0, t_out - s.shape[1]))
        taps.append(s[:, :t_out])
    cat = torch.cat(taps, dim=-1)                          # (B, T_out, 3*C_in)
    y = _mm_f32(cat, w.reshape(-1, w.shape[-1])) + b.float()
    return gelu_mod.gelu(y.to(x.dtype))


# ---------------------------------------------------------------------------
# Rematerialization (training)
# ---------------------------------------------------------------------------

def _checkpointed(fn, context_fn=noop_context_fn):
    """``fn`` under ``torch.utils.checkpoint`` when a graph is being built;
    ``context_fn`` gives a selective policy's contexts."""
    def run(*args):
        if torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                     context_fn=context_fn)
        return fn(*args)
    return run


# Products without batch dimensions: the weight projections, which
# torch.matmul runs as aten.mm once the leading dimensions are folded.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of
    products without batch dimensions, recompute everything else (the
    elementwise chain, batched products such as the plain attention's
    einsums, and K1, whose ctypes launch no policy can keep)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat_plan(remat):
    """(layer wrapper, residual-branch wrapper) for a JAX ``remat`` name.

    The names change memory, never numbers.  ``False``/``None`` keeps every
    activation; ``True``/``"full"`` checkpoints each layer (its input is
    kept, the rest recomputed in the backward); ``"attn"`` checkpoints each
    residual branch (self-attention, cross-attention, FFN) on its own, so the
    residual stream at every attention output is kept and only the insides
    of the branches are recomputed; ``"dots"`` checkpoints each layer under
    :func:`_dots_policy` (XLA's ``dots_with_no_batch_dims_saveable``): the
    layer's weight projections are kept, the rest recomputed."""
    keep = lambda fn: fn
    if remat in (False, None):
        return keep, keep
    if remat in (True, "full"):
        return _checkpointed, keep
    if remat == "attn":
        return keep, _checkpointed
    if remat == "dots":
        return (lambda fn: _checkpointed(fn, _dots_contexts)), keep
    raise ValueError(f"remat={remat!r}: expected bool, 'full', 'dots' or 'attn'")


def _encoder_layer(lp: Params, x: torch.Tensor, nh: int, branch) -> torch.Tensor:
    x = x + branch(lambda h: self_attn_full(lp["self"], layer_norm(
        h, lp["self_ln"]["scale"], lp["self_ln"]["bias"]), nh, causal=False))(x)
    return x + branch(lambda h: ffn(lp, layer_norm(
        h, lp["ffn_ln"]["scale"], lp["ffn_ln"]["bias"])))(x)


def encode(params: Params, dims: WhisperDims, mel: torch.Tensor,
           remat=False) -> torch.Tensor:
    """mel (B, num_mel_bins, num_frames) -> (B, max_source_positions, D).

    ``remat`` (training) takes the JAX names; see :func:`_remat_plan`."""
    enc = params["encoder"]
    x = mel.transpose(1, 2).to(enc["conv1_w"].dtype)
    x = conv1d_stem(x, enc["conv1_w"], enc["conv1_b"], stride=1)
    x = conv1d_stem(x, enc["conv2_w"], enc["conv2_b"], stride=2)
    x = x + enc["pos_embed"][None, :x.shape[1]]
    nh = dims.encoder_attention_heads
    layer, branch = _remat_plan(remat)
    for i in range(dims.encoder_layers):
        lp = layer_params(enc["layers"], i)
        x = layer(lambda h, lp=lp: _encoder_layer(lp, h, nh, branch))(x)
    return layer_norm(x, enc["ln_post"]["scale"], enc["ln_post"]["bias"])


# ---------------------------------------------------------------------------
# Decoder — incremental with a static KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Decoder cache.  self_k/self_v: (L, B, max_len, D) head-flat, written in
    place at per-example offsets.  cross_k: (L, B, H, Dh, S) head-major;
    cross_v: (L, B, S, D) head-flat — both computed once per utterance.

    int8 serving: cross_k / cross_v are int8 with f32 scales cross_k_s /
    cross_v_s (L, B, H, S), one per (head, position); self_k / self_v are
    int8 and self_s (L, B, max_len, 2H) bf16 holds one scale per
    (position, head), K in lanes [0, H), V in [H, 2H) (ones until written)."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_s: Optional[torch.Tensor] = None
    cross_v_s: Optional[torch.Tensor] = None
    self_s: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.self_k.shape[2]


def _cross_kv(cross: Params, enc_out: torch.Tensor, num_heads: int):
    """One layer's cross K (B, H, Dh, S) and V (B, S, D), each example
    projected on its own (a library GEMM may pick another algorithm, and
    round differently, for another row count).  int8 projections give int8
    K/V with f32 (B, H, S) scales, quantized per (head, position) over the
    head dim; else the scales are None."""
    num_heads = _local_heads(cross["k_w"], num_heads)
    k = torch.cat([dense(e[None], cross["k_w"]) for e in enc_out])
    k = _split_heads(k, num_heads).permute(0, 2, 3, 1)
    v = torch.cat([dense(e[None], cross["v_w"], cross["v_b"]) for e in enc_out])
    if not qmm_mod.is_quantized(cross["k_w"]):
        return k, v, None, None
    k, k_s = qmm_mod.quantize_array(k, axis=2)
    # V: one scale per (position, head) chunk of Dh lanes.
    v, v_s = qmm_mod.quantize_array(_split_heads(v, num_heads), axis=-1)
    return k, _merge_heads(v), k_s, v_s.permute(0, 2, 1)


def init_cache(params: Params, dims: WhisperDims, enc_out: torch.Tensor,
               max_len: int, extra_layers: int = 0,
               self_batch: Optional[int] = None) -> KVCache:
    """Allocate the self slabs (``max_len`` rows, no slack) and precompute the
    cross K/V of every layer, each example on its own, so that its cache
    does not depend on the batch.  ``extra_layers`` more slots (the
    Medusa-Block layer's, filled by :func:`set_block_cross_kv`) start zero.
    ``self_batch`` gives the self slabs (and their int8 scales) that many
    rows, beam search's B * K, while the cross K/V keep the B examples' rows:
    the beams of an example share them (:func:`decode_step`'s ``cross_beam``).

    With int8 cross projections (int8 serving) the cross K/V are quantized
    per (head, position) over the head dim and the self slabs are int8 with
    a bf16 scale slab of ones."""
    b = enc_out.shape[0]
    nl = dims.decoder_layers
    self_w = params["decoder"]["layers"]["self"]["k_w"]
    # This rank's heads (and their width) under tensor parallelism.
    nh = _local_heads(self_w, dims.decoder_attention_heads)
    d = (self_w["q"] if qmm_mod.is_quantized(self_w) else self_w).shape[-1]
    layers = params["decoder"]["layers"]["cross"]
    quant = qmm_mod.is_quantized(layers["k_w"])
    per_layer = [_cross_kv(layer_params(layers, i), enc_out, dims.decoder_attention_heads)
                 for i in range(nl)]
    per_layer += [tuple(None if a is None else torch.zeros_like(a) for a in per_layer[0])
                  ] * extra_layers
    ks, vs, kss, vss = zip(*per_layer)
    dev = enc_out.device
    slab_dt = torch.int8 if quant else enc_out.dtype
    n = nl + extra_layers
    sb = b if self_batch is None else self_batch
    cache = KVCache(
        self_k=torch.zeros((n, sb, max_len, d), dtype=slab_dt, device=dev),
        self_v=torch.zeros((n, sb, max_len, d), dtype=slab_dt, device=dev),
        cross_k=torch.stack(ks).contiguous(),
        cross_v=torch.stack(vs).contiguous(),
    )
    if quant:
        cache.cross_k_s = torch.stack(kss).contiguous()
        cache.cross_v_s = torch.stack(vss).contiguous()
        cache.self_s = torch.ones((n, sb, max_len, 2 * nh), dtype=torch.bfloat16,
                                  device=dev)
    return cache


def set_block_cross_kv(cache: KVCache, block: Params, enc_out: torch.Tensor,
                       num_heads: int) -> KVCache:
    """In place: fill the last cache slot's cross K/V (and int8 scales) from
    the Medusa-Block layer's cross projections; returns ``cache``."""
    k, v, k_s, v_s = _cross_kv(block["cross"], enc_out, num_heads)
    cache.cross_k[-1] = k
    cache.cross_v[-1] = v
    if cache.cross_k_s is not None:
        cache.cross_k_s[-1] = k_s
        cache.cross_v_s[-1] = v_s
    return cache


def _quantize(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def quantize_self_rows(x: torch.Tensor, num_heads: int):
    """Per-(position, head) int8 quantization of head-flat (B, T, D) self K/V
    rows, the math K2 applies when it commits: ``sc = max(amax, 1e-30) /
    127``; (int8 rows, f32 scales (B, T, H))."""
    b, t, d = x.shape
    x32 = x.float().reshape(b, t, num_heads, d // num_heads)
    sc = x32.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 127.0
    return _quantize(x32, sc).reshape(b, t, d), sc[..., 0]


def dequant_self(buf: torch.Tensor, scales: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, D) int8 slab x (B, S, H) bf16 scales -> bf16 head-flat slab."""
    b, s, d = buf.shape
    x = buf.float().reshape(b, s, num_heads, d // num_heads)
    return (x * scales.float()[..., None]).reshape(b, s, d).to(torch.bfloat16)


def make_step_mask(offsets: torch.Tensor, chunk_len: int, max_len: int,
                   chunk_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 1, T, max_len) bool: key j is visible to query i of example b iff
    j < offsets[b], or j - offsets[b] in [0, T) and chunk_mask[i, j - off]."""
    dev = offsets.device
    if chunk_mask is None:
        chunk_mask = torch.tril(torch.ones((chunk_len, chunk_len), dtype=torch.bool,
                                           device=dev))
    key = torch.arange(max_len, device=dev)[None, None, None, :]
    off = offsets[:, None, None, None]
    rel = key - off
    in_chunk = (rel >= 0) & (rel < chunk_len)
    q_idx = torch.arange(chunk_len, device=dev)[None, None, :, None]
    intra = chunk_mask[q_idx, rel.clamp(0, chunk_len - 1)] & in_chunk
    return (key < off) | intra


def write_rows(buf: torch.Tensor, rows: torch.Tensor, offsets: torch.Tensor) -> None:
    """In place: buf (B, S, D)[b, offsets[b] + t] = rows[b, t]."""
    b, t = rows.shape[:2]
    idx = offsets[:, None] + torch.arange(t, device=rows.device)[None]
    buf[torch.arange(b, device=rows.device)[:, None], idx] = rows


def _layer_step(lp: Params, h: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor,
                cross_k: torch.Tensor, cross_v: torch.Tensor, offsets: torch.Tensor,
                self_mask: torch.Tensor, num_heads: int, cross_len: int,
                cross_k_s: Optional[torch.Tensor], cross_v_s: Optional[torch.Tensor],
                self_s: Optional[torch.Tensor], proj, attend, cross_fn, ffn_fn,
                cross_beam: int = 1) -> torch.Tensor:
    """One decoder layer (JAX ``decoder_layer_step``, whisper.py:953-1042)
    with its projections through ``proj``, self-attention through
    ``attend(q, k_slab, v_slab, self_mask)``, cross-attention through
    ``cross_fn`` and the FFN branch through ``ffn_fn(lp, x)``.

    ``cross_beam`` K > 1 (beam search): h holds B * K rows, beam-major per
    example, and the cross K/V B rows; each example's K beams' queries are
    folded into one (B, K * T) query block for the cross-attention and
    unfolded after it, so the shared cross K/V are read once per example.
    Under tensor parallelism: this rank's heads, the o projections summed
    over the model group (:func:`_row_out`)."""
    head_dim = h.shape[-1] // num_heads
    num_heads = _local_heads(lp["self"]["q_w"], num_heads)
    sx = layer_norm(h, lp["self_ln"]["scale"], lp["self_ln"]["bias"])
    q = _split_heads(proj(sx, lp["self"]["q_w"], lp["self"]["q_b"]), num_heads)
    q = q * (head_dim ** -0.5)
    k_new = proj(sx, lp["self"]["k_w"])
    v_new = proj(sx, lp["self"]["v_w"], lp["self"]["v_b"])
    if self_s is None:
        write_rows(k_buf, k_new, offsets)
        write_rows(v_buf, v_new, offsets)
        k_att, v_att = k_buf, v_buf
    else:
        kq, k_sc = quantize_self_rows(k_new, num_heads)
        vq, v_sc = quantize_self_rows(v_new, num_heads)
        write_rows(k_buf, kq, offsets)
        write_rows(v_buf, vq, offsets)
        write_rows(self_s, torch.cat([k_sc, v_sc], dim=-1).to(self_s.dtype), offsets)
        k_att = dequant_self(k_buf, self_s[..., :num_heads], num_heads)
        v_att = dequant_self(v_buf, self_s[..., num_heads:], num_heads)
        write_rows(k_att, k_new.to(torch.bfloat16), offsets)
        write_rows(v_att, v_new.to(torch.bfloat16), offsets)
    out = _merge_heads(attend(q, k_att, v_att, self_mask))
    h = h + _row_out(lambda bias: proj(out, lp["self"]["o_w"], bias), lp["self"]["o_b"])
    cx = layer_norm(h, lp["cross_ln"]["scale"], lp["cross_ln"]["bias"])
    cq = _split_heads(proj(cx, lp["cross"]["q_w"], lp["cross"]["q_b"]), num_heads)
    cq = cq * (head_dim ** -0.5)
    bk, t = cq.shape[:2]
    cq = cq.reshape(bk // cross_beam, cross_beam * t, *cq.shape[2:])
    co = cross_fn(cq.transpose(1, 2), cross_k, cross_v, cross_len, cross_k_s,
                  cross_v_s).transpose(1, 2)                    # (B, K * T, H, Dh)
    co = _merge_heads(co.reshape(bk, t, *co.shape[2:]))
    h = h + _row_out(lambda bias: proj(co, lp["cross"]["o_w"], bias), lp["cross"]["o_b"])
    fx = layer_norm(h, lp["ffn_ln"]["scale"], lp["ffn_ln"]["bias"])
    return h + ffn_fn(lp, fx)


def _attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Self-attention of a decode chunk over the head-flat slabs k, v (B,
    max_len, D) under ``make_step_mask``'s mask."""
    h = q.shape[2]
    return attention(q, _split_heads(k, h), _split_heads(v, h), mask)


def _step_mask_ops(offsets: torch.Tensor, chunk_len: int, max_len: int,
                   chunk_mask: Optional[torch.Tensor]):
    """The per-op step's self mask: on the card K10's mask-mode operands
    (offsets, chunk bits), elsewhere :func:`make_step_mask`."""
    if offsets.is_cuda:
        return offsets, decode_ops.chunk_bits(chunk_mask, chunk_len, offsets.device, max_len)
    return make_step_mask(offsets, chunk_len, max_len, chunk_mask)


def _attend_ops(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask) -> torch.Tensor:
    """The per-op step's self-attention: K10's mask mode on CUDA tensors
    (batch-invariant: each example's sums in an order fixed by max_len),
    :func:`_attend_plain` on CPU tensors.  f32 queries on the bf16 slab of
    an int8 self cache (the int8 copy of an f32 model: the history
    dequantized to bf16 with the chunk's rows in bf16, JAX ``_dequant_self``)
    take K10's f32 mask mode on that slab widened to f32; the output comes
    back in the slab's dtype, as :func:`attention` returns it."""
    if q.is_cuda and q.dtype == torch.float32 and v.dtype == torch.bfloat16:
        return decode_ops.self_attention_decode_kernel(q, k.float(), v.float(),
                                                       *mask).to(v.dtype)
    if q.is_cuda:
        return decode_ops.self_attention_decode_kernel(q, k, v, *mask)
    return _attend_plain(q, k, v, mask)


def _ffn_plain(lp: Params, x: torch.Tensor) -> torch.Tensor:
    return decode_ops.ffn_decode_plain(x, lp["fc1_w"], lp["fc1_b"], lp["fc2_w"], lp["fc2_b"])


def _ffn_ops(lp: Params, x: torch.Tensor) -> torch.Tensor:
    """The per-op step's FFN, as the JAX scan path (whisper.py:1036-1041):
    int8 weights through :func:`ffn` (K6), bf16 and f32 through
    ``ffn_decode`` (K11 and its f32 mode; under tensor parallelism on this
    rank's columns with a zero fc2 bias, :func:`_row_out` adding it once)."""
    if qmm_mod.is_quantized(lp["fc1_w"]):
        return ffn(lp, x)
    b2 = lp["fc2_b"]
    return _row_out(lambda bias: decode_ops.ffn_decode(
        x, lp["fc1_w"], lp["fc1_b"], lp["fc2_w"], torch.zeros_like(b2) if bias is None
        else bias), b2)


def decoder_layer_step(lp: Params, h: torch.Tensor, k_buf: torch.Tensor,
                       v_buf: torch.Tensor, cross_k: torch.Tensor,
                       cross_v: torch.Tensor, offsets: torch.Tensor,
                       self_mask: torch.Tensor, num_heads: int,
                       cross_len: int, cross_k_s: Optional[torch.Tensor] = None,
                       cross_v_s: Optional[torch.Tensor] = None,
                       self_s: Optional[torch.Tensor] = None,
                       cross_beam: int = 1) -> torch.Tensor:
    """One decoder layer over a T-token chunk in plain PyTorch on every
    device — the plain version of K2 (exact f32 products, the plain
    cross-attention and FFN); writes the chunk's K/V rows into
    ``k_buf``/``v_buf`` (B, max_len, D) in place.  Returns the new hidden.

    int8 self slabs (``self_s`` (B, max_len, 2H) given): the chunk's rows are
    committed quantized per (position, head) with their scales; attention
    then reads the history rows dequantized to bf16 but the chunk's own rows
    as the fresh bf16 K/V."""
    return _layer_step(lp, h, k_buf, v_buf, cross_k, cross_v, offsets, self_mask,
                       num_heads, cross_len, cross_k_s, cross_v_s, self_s,
                       proj=dense_exact, attend=_attend_plain,
                       cross_fn=decode_ops.cross_attention_decode_plain, ffn_fn=_ffn_plain,
                       cross_beam=cross_beam)


def decoder_layer_ops(lp: Params, h: torch.Tensor, k_buf: torch.Tensor,
                      v_buf: torch.Tensor, cross_k: torch.Tensor, cross_v: torch.Tensor,
                      offsets: torch.Tensor, self_mask: torch.Tensor, num_heads: int,
                      cross_len: int, cross_k_s: Optional[torch.Tensor] = None,
                      cross_v_s: Optional[torch.Tensor] = None,
                      self_s: Optional[torch.Tensor] = None,
                      cross_beam: int = 1) -> torch.Tensor:
    """One decoder layer of the per-op step (the JAX scan path): the
    projections through :func:`dense_step` (cuBLAS at bf16, K6 at int8, the
    f32 GEMM at f32), the self-attention through K10's mask mode
    (``self_mask`` is then :func:`_step_mask_ops`'s (offsets, chunk bits)),
    cross-attention through K10 and the bf16 or f32 FFN through K11
    (ops/decode_ops.py); on CPU tensors the wrappers run their plain
    versions."""
    return _layer_step(lp, h, k_buf, v_buf, cross_k, cross_v, offsets, self_mask,
                       num_heads, cross_len, cross_k_s, cross_v_s, self_s,
                       proj=dense_step, attend=_attend_ops,
                       cross_fn=decode_ops.cross_attention_decode, ffn_fn=_ffn_ops,
                       cross_beam=cross_beam)


def run_layers(layer_fn, dec_layers: Params, ln_post: Params, x: torch.Tensor,
               self_k: torch.Tensor, self_v: torch.Tensor, cross_k: torch.Tensor,
               cross_v: torch.Tensor, offsets: torch.Tensor,
               chunk_mask: Optional[torch.Tensor], cross_len: int, num_heads: int,
               cross_k_s: Optional[torch.Tensor] = None,
               cross_v_s: Optional[torch.Tensor] = None,
               self_s: Optional[torch.Tensor] = None, block: Optional[Params] = None,
               mask_fn=make_step_mask, cross_beam: int = 1):
    """``layer_fn`` over every stacked decoder layer (slot i of each cache
    slab), then ``ln_post``, then the block (if given) on ln_post's output
    at slot L; (pre_norm, hidden, block_hidden or None), the self slabs
    (and scales) updated in place.  ``mask_fn(offsets, T, max_len,
    chunk_mask)`` gives the self mask the layers take, once per step;
    ``cross_beam`` goes to every layer (:func:`_layer_step`)."""
    from whisper_medusa_tpu_torch.ops import megastep

    nl = megastep.check_slots(dec_layers, self_k, block)
    mask = mask_fn(offsets, x.shape[1], self_k.shape[2], chunk_mask)
    at = lambda a, i: None if a is None else a[i]

    def step(lp, h, i):
        return layer_fn(lp, h, self_k[i], self_v[i], cross_k[i], cross_v[i], offsets, mask,
                        num_heads, cross_len, cross_k_s=at(cross_k_s, i),
                        cross_v_s=at(cross_v_s, i), self_s=at(self_s, i),
                        cross_beam=cross_beam)

    h = x
    for layer in range(nl):
        h = step(layer_params(dec_layers, layer), h, layer)
    hidden = layer_norm(h, ln_post["scale"], ln_post["bias"])
    block_hidden = None if block is None else step(block, hidden, nl)
    return h, hidden, block_hidden


def decoder_layers_ops(dec_layers: Params, ln_post: Params, x: torch.Tensor,
                       self_k: torch.Tensor, self_v: torch.Tensor, cross_k: torch.Tensor,
                       cross_v: torch.Tensor, offsets: torch.Tensor,
                       chunk_mask: Optional[torch.Tensor], cross_len: int, num_heads: int,
                       cross_k_s: Optional[torch.Tensor] = None,
                       cross_v_s: Optional[torch.Tensor] = None,
                       self_s: Optional[torch.Tensor] = None,
                       block: Optional[Params] = None, cross_beam: int = 1):
    """The per-op decoder step — the JAX ``lax.scan`` over
    ``decoder_layer_step`` (whisper.py:1223-1279) that serves what K2 does
    not take: :func:`decoder_layer_ops` over every layer, ``ln_post``, then
    the Medusa-Block layer on slot L.  Same arguments and outputs as
    ``ops/megastep.py::fused_decoder_layers``."""
    return run_layers(decoder_layer_ops, dec_layers, ln_post, x, self_k, self_v, cross_k,
                      cross_v, offsets, chunk_mask, cross_len, num_heads,
                      cross_k_s=cross_k_s, cross_v_s=cross_v_s, self_s=self_s, block=block,
                      mask_fn=_step_mask_ops, cross_beam=cross_beam)


@dataclasses.dataclass
class DecoderOutput:
    hidden: torch.Tensor      # (B, T, D) after the final layer norm
    pre_norm: torch.Tensor    # (B, T, D) before it
    block_hidden: Optional[torch.Tensor] = None   # (B, T, D) Medusa-Block layer output
    penultimate: Optional[torch.Tensor] = None    # (B, T, D) input to the last layer


def decode_step(params: Params, dims: WhisperDims, tokens: torch.Tensor,
                cache: KVCache, offsets: torch.Tensor,
                rel_positions: Optional[torch.Tensor] = None,
                chunk_mask: Optional[torch.Tensor] = None,
                block: Optional[Params] = None, cross_beam: int = 1) -> DecoderOutput:
    """Incremental decoder pass over T new tokens (B, T) at per-example
    ``offsets``; updates ``cache``'s self slabs in place.

    ``block`` (the Medusa-Block layer, one unstacked decoder layer) runs
    after ``ln_post`` on ``hidden``, on the cache's last slot (init_cache
    ``extra_layers=1``), and gives ``block_hidden`` (no ``ln_post``).  It
    goes to K2 as a layer of its own, never concatenated onto the stacked
    decoder weights (that would copy every decoder weight per call).

    ``cross_beam`` K > 1 (beam search): ``tokens`` holds B * K beam rows and
    the cache B * K self rows but B cross rows (init_cache ``self_batch``);
    each example's beams share its cross K/V.

    Dispatch, as the JAX package's: K2 (``fused_decoder_layers``) where
    ``megastep.fits`` the call, else the per-op step
    (:func:`decoder_layers_ops`): B > 8, T > 16, widths off K2's scope,
    beams, and every call under tensor parallelism (JAX's gate takes its
    scan path under a model axis)."""
    from whisper_medusa_tpu_torch.ops import megastep

    dec = params["decoder"]
    t = tokens.shape[1]
    nh = dims.decoder_attention_heads
    if rel_positions is None:
        rel_positions = torch.arange(t, device=tokens.device)
    abs_pos = (offsets[:, None] + rel_positions[None, :]).clamp(
        0, dims.max_target_positions - 1)
    x = embed_lookup(dec["embed_tokens"], tokens) + dec["pos_embed"][abs_pos]
    fused = (mesh_mod.model_parallel() is None
             and megastep.fits(dec["layers"], x, cache.self_k, cache.cross_k, nh, cross_beam))
    fn = (megastep.fused_decoder_layers if fused
          else functools.partial(decoder_layers_ops, cross_beam=cross_beam))
    pre_norm, hidden, block_hidden = fn(
        dec["layers"], dec["ln_post"], x, cache.self_k, cache.self_v,
        cache.cross_k, cache.cross_v, offsets.to(torch.int32), chunk_mask,
        cross_len=min(dims.max_source_positions, cache.cross_k.shape[4]),
        num_heads=nh, cross_k_s=cache.cross_k_s,
        cross_v_s=cache.cross_v_s, self_s=cache.self_s, block=block)
    return DecoderOutput(hidden=hidden, pre_norm=pre_norm, block_hidden=block_hidden)


# ---------------------------------------------------------------------------
# Decoder — teacher-forced (training)
# ---------------------------------------------------------------------------

def decoder_layer_full(lp: Params, x: torch.Tensor, enc_out: torch.Tensor,
                       num_heads: int, branch=lambda fn: fn) -> torch.Tensor:
    """One full-sequence decoder layer (causal self + cross + FFN): the
    Medusa-Block layer, the frozen teacher replay and each layer of
    :func:`decode_train`.  ``branch`` wraps each residual branch (remat)."""
    h = x + branch(lambda y: self_attn_full(lp["self"], layer_norm(
        y, lp["self_ln"]["scale"], lp["self_ln"]["bias"]), num_heads, causal=True))(x)
    h = h + branch(lambda y: cross_attn_full(lp["cross"], layer_norm(
        y, lp["cross_ln"]["scale"], lp["cross_ln"]["bias"]), enc_out, num_heads))(h)
    return h + branch(lambda y: ffn(lp, layer_norm(
        y, lp["ffn_ln"]["scale"], lp["ffn_ln"]["bias"])))(h)


def decode_train(params: Params, dims: WhisperDims, tokens: torch.Tensor,
                 enc_out: torch.Tensor, collect_penultimate: bool = False,
                 remat=False, grad_last_only: bool = False) -> DecoderOutput:
    """Teacher-forced decoder pass over a full token sequence (B, T).

    Token ids are clamped into the vocabulary, as JAX's gather does (the
    start id 50258 lies past a test vocabulary), and such a clamped row
    gets no gradient, as in JAX.  ``collect_penultimate``
    gives the hidden state entering the last layer (the teacher replay's
    input).  ``grad_last_only`` (the ``all_but_last`` policy) runs the
    embedding and layers 0..L-2 under ``torch.no_grad()`` and the last layer
    on the live slice of the stacked leaves, whose gradient is then zero in
    the frozen slices.  ``remat``: see :func:`_remat_plan`."""
    dec = params["decoder"]
    nh = dims.decoder_attention_heads
    t = tokens.shape[1]
    nl = dims.decoder_layers
    vocab = _vocab_rows(dec["embed_tokens"])
    tokens = tokens.long()
    layer, branch = _remat_plan(False if grad_last_only else remat)

    def layer_fn(i):
        lp = layer_params(dec["layers"], i)
        return layer(lambda h: decoder_layer_full(lp, h, enc_out, nh, branch))

    with torch.set_grad_enabled(torch.is_grad_enabled() and not grad_last_only):
        # JAX's gather clamps an out-of-range id in the forward and its
        # transpose drops that row's gradient; so do these two lines.
        rows = embed_lookup(dec["embed_tokens"], tokens.clamp(0, vocab - 1))
        rows = torch.where(((tokens >= 0) & (tokens < vocab))[..., None], rows, rows.detach())
        x = rows + dec["pos_embed"][None, :t]
        for i in range(nl - 1):
            x = layer_fn(i)(x)
    penult = x
    x = layer_fn(nl - 1)(x)
    hidden = layer_norm(x, dec["ln_post"]["scale"], dec["ln_post"]["bias"])
    return DecoderOutput(hidden=hidden, pre_norm=x,
                         penultimate=penult if collect_penultimate else None)


def _capture_plan(sel) -> Dict[int, list]:
    """{layer: [(slot, head), ...]} of a (layer, head) selection; {} for
    None and "all"."""
    want: Dict[int, list] = {}
    if sel is not None and sel != "all":
        for i, (l, h) in enumerate(sel):
            want.setdefault(int(l), []).append((i, int(h)))
    return want


def decode_train_capture(params: Params, dims: WhisperDims, tokens: torch.Tensor,
                         enc_out: torch.Tensor, cross=None, self_attn=None,
                         collect_hidden: bool = False, to_host: bool = False):
    """Teacher-forced decoder pass (B, T) that also captures attention maps
    and hidden states, the counterpart of the JAX function of this name.

    ``cross`` / ``self_attn``: None skips the capture; "all" keeps every
    head, (L, B, H, T, S) cross / (L, B, H, T, T) self; a tuple of
    (layer, head) pairs keeps those maps, (N_sel, B, T, S) / (N_sel, B, T,
    T) float32 in the given order.  ``collect_hidden`` also returns the
    (L+1, B, T, D) stack: row 0 the embedding output, row 1 + l layer l's
    output (before ``ln_post``).  The layer loop is unrolled: a layer whose
    maps are asked for runs :func:`self_attn_probs` / :func:`cross_attn_probs`,
    whose outputs are bit for bit those of the layers that run
    :func:`self_attn_full` / :func:`cross_attn_full` (K1 on the card), so
    the pass computes :func:`decode_train`'s activations whatever is
    captured, and a map does not depend on which others were asked for.
    The cross-attention reads the unpadded encoder frames.  ``to_host``
    moves each captured map and hidden row to the CPU as it is made, so
    the card holds one layer's maps at a time.

    Returns (hidden (B, T, D) after ``ln_post``, cross maps, self maps,
    hidden stack); what was not asked for is None."""
    dec = params["decoder"]
    nh = dims.decoder_attention_heads
    t = tokens.shape[1]
    vocab = _vocab_rows(dec["embed_tokens"])
    keep = (lambda a: a.cpu()) if to_host else (lambda a: a)
    x = (embed_lookup(dec["embed_tokens"], tokens.long().clamp(0, vocab - 1))
         + dec["pos_embed"][None, :t])
    c_want, s_want = _capture_plan(cross), _capture_plan(self_attn)
    c_sel = [None] * (0 if cross in (None, "all") else len(cross))
    s_sel = [None] * (0 if self_attn in (None, "all") else len(self_attn))
    c_all, s_all = [], []
    hiddens = [keep(x)] if collect_hidden else []

    def capture(probs, sel, want, every, picked, layer):
        if sel == "all":
            every.append(keep(probs))
        else:
            for i, hd in want[layer]:
                picked[i] = keep(probs[:, hd])

    for l in range(dims.decoder_layers):
        lp = layer_params(dec["layers"], l)
        ln_x = layer_norm(x, lp["self_ln"]["scale"], lp["self_ln"]["bias"])
        if self_attn == "all" or l in s_want:
            s_out, probs = self_attn_probs(lp["self"], ln_x, nh)
            capture(probs, self_attn, s_want, s_all, s_sel, l)
        else:
            s_out = self_attn_full(lp["self"], ln_x, nh, causal=True)
        h = x + s_out
        ln_h = layer_norm(h, lp["cross_ln"]["scale"], lp["cross_ln"]["bias"])
        if cross == "all" or l in c_want:
            c_out, probs = cross_attn_probs(lp["cross"], ln_h, enc_out, nh)
            capture(probs, cross, c_want, c_all, c_sel, l)
        else:
            c_out = cross_attn_full(lp["cross"], ln_h, enc_out, nh)
        h = h + c_out
        x = h + ffn(lp, layer_norm(h, lp["ffn_ln"]["scale"], lp["ffn_ln"]["bias"]))
        if collect_hidden:
            hiddens.append(keep(x))
    hidden = layer_norm(x, dec["ln_post"]["scale"], dec["ln_post"]["bias"])
    cross_maps = (torch.stack(c_all) if cross == "all"
                  else torch.stack(c_sel) if c_sel else None)
    self_maps = (torch.stack(s_all) if self_attn == "all"
                 else torch.stack(s_sel) if s_sel else None)
    return hidden, cross_maps, self_maps, torch.stack(hiddens) if collect_hidden else None


def decode_train_cross_attn(params: Params, dims: WhisperDims, tokens: torch.Tensor,
                            enc_out: torch.Tensor, select=None):
    """Cross-attention-only capture (:func:`decode_train_capture`):
    ``select`` a tuple of (layer, head) alignment heads, (N_sel, B, T, S)
    float32 in the given order; None keeps every head, (L, B, H, T, S).
    Returns (hidden after ``ln_post``, maps)."""
    hidden, maps, _, _ = decode_train_capture(
        params, dims, tokens, enc_out, cross="all" if select is None else select)
    return hidden, maps


def project_logits_train(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Differentiable vocab projection for training: ``hidden @ embed.T`` in
    float32 through ``torch.matmul`` (exact products of bf16 operands, f32
    sums — the JAX ``preferred_element_type=f32`` product).  Unlike
    :func:`project_logits` (K3 / K7, serving) it has a backward."""
    w = params["decoder"]["embed_tokens"]
    return torch.matmul(hidden.float(), w.float().t())


def project_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Vocab projection through the tied embedding, float32: kernel K3 on
    CUDA, or K7 (``qmm_nt``) for an int8 embedding."""
    w = params["decoder"]["embed_tokens"]
    if qmm_mod.is_quantized(w):
        d = hidden.shape[-1]
        y = qmm_mod.qmm_nt(hidden.reshape(-1, d), w["q"], w["s"])
        return y.reshape(*hidden.shape[:-1], y.shape[-1])
    return logits_mod.project_logits_stream(hidden, w)
