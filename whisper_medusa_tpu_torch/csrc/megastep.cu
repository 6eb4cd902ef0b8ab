// K2 — the whole decoder stack over one decode chunk (T <= 16 tokens per
// example, B <= 8 examples, B*T <= 128 rows), plus the final layer norm.
//
// Replaces whisper_medusa_tpu/ops/megastep.py::_kernel (TPU, launched by
// fused_decoder_layers), one pallas_call whose grid walks (layers, phases)
// with the hidden state carried in VMEM while Mosaic streams the next phase's
// weights.  On Hopper the same work is a fixed sequence of eight kernels per
// layer, launched back to back on one stream by one C entry (one ctypes call
// per decode step):
//
//   LN + q/k/v (one GEMM launch, 3 jobs) -> self-attention + in-place K/V
//   commit -> o + residual -> LN + cross q -> cross-attention -> cross o +
//   residual -> LN + fc1 + GELU -> fc2 + residual
//
// and after the last layer ln_post (ln_rows_kernel) into a second buffer
// (hidden), so the whole decoder output comes from kernels whose per-row
// arithmetic does not depend on the number of rows (batch invariance).  The
// three layer norms of a layer run inside the GEMMs that consume them (the
// GEMM's LN mode, wgemm.cuh): the cluster of a column tile spans K, so its
// CTAs combine per-slice row statistics in rank order and normalize each X
// tile in shared memory; the GEMM reads the residual stream itself.
//
// The hidden state stays in a bf16 buffer of ceil(B*T / 16) * 16 rows in
// device memory (L2 resident) between kernels.  Bound on H100: bytes.  At
// large-v2 one step reads 32 x (6 x 1280^2 + 2 x 1280 x 5120) bf16 weights =
// 1.47 GB, whatever B is, plus B x 32 x 2 x 1500 x 1280 bf16 cross K/V =
// B x 246 MB (counted from the shapes).
//
// The self- and cross-attention run the thread-block-cluster body of K10
// (cluster_attn.cuh, cross_decode_kernel<KT, SELF, K2 = true>): one cluster
// per (head, example) whose CTAs split the keys into slices chosen from S
// alone (cd_split: 8 x 192 over large-v2's 1500 cross keys, 3 x 160 over
// the 460-row self slabs, never from B, T or the data, so an example's
// bits do not depend on its batch), mma.sync scores and PV, the row
// statistics merged in rank order through distributed shared memory and P
// rounded to bf16 once after the whole-row softmax, as the plain version
// and the JAX kernel do.  The self-attention is the body's mask mode over
// the slab of the layer's slot; it also commits the chunk's K/V rows (the
// rank whose slice holds position off + t writes it) and attends the
// chunk's own keys from the fresh projection rows; it packs the (T, T)
// uint8 chunk mask into bit rows itself.  At large-v2 and B = 1 that is 160
// cross CTAs and 60 self CTAs a layer.
//
// The six projections of a layer run on the weight-streaming GEMM of
// wgemm.cuh (wgemm_kernel, shared with K11; q/k/v, cross q and fc1 in its
// LN mode), Y^T = W^T X^T on wgmma: a CTA per (64 W columns, K slice), the
// W tile wgmma's 64-row side and the X tile (ceil(M / 16) * 16 rows) its N
// side; K slices from (K, N, jobs) alone
// (q/k/v 3 slices x 60 tiles, o / cross q / cross o and fc2 7 x 20, fc1 2 x
// 80), added in rank order across a thread-block cluster; here the ring
// holds a CTA's whole slice at B = 1 (up to 96 KB; 4 stages past 32 rows,
// gemm_stages); the weights come from tensor maps over the (L, K, N)
// stacks, encoded once a step (the layer is a coordinate).
//
// Every kernel of the step is launched with programmatic dependent launch
// (cudaLaunchAttributeProgrammaticStreamSerialization): each lets the next
// kernel launch at its start (griddepcontrol.launch_dependents) and waits
// for the previous one (griddepcontrol.wait) before it touches what that
// one writes.  Rule, kept by every kernel here: before its wait a kernel
// reads only weights and the cross K/V, and writes only its own shared
// memory.  Both are written before the step's first kernel starts (the
// weights at load time, the cross K/V by init_cache / set_block_cross_kv,
// ordinary stream-ordered work that completes before the step's first
// launch may begin) and by no kernel of any step, so no early launch can
// read them stale.  A GEMM's producer issues its first ring of weight loads
// before the wait, so the next projection's weights are in flight while the
// kernels before it finish: the Hopper counterpart of the TPU kernel's
// cross-phase prefetch; the cross-attention issues the copies of its K and
// V slices before its wait, so the bytes that bound it load while the
// cross-q GEMM runs.  The self-attention reads nothing before its wait: the
// slabs' history rows were written by earlier steps.
//
// Numerics follow models/whisper.py::decoder_layer_step: f32 layernorm
// statistics (a row's per-slice partials combined in rank order: the same
// for every M, not ln_rows's summation order), softmax and accumulation;
// bf16 operands and activations; exact erf GELU (erff).  Self-attention
// masks: history key j < offset is visible; chunk key offset + c is visible
// to query t iff mask[t][c] (the mask's diagonal set: every query sees
// itself); masked keys get probability exactly 0, keys past offset + T are
// neither read nor counted.
// Cross keys >= cross_len are excluded (the JAX path gives them NEG_CROSS,
// i.e. zero probability).  The chunk's K/V rows are written into the self
// slabs in place (the JAX kernel aliases its slab outputs to its inputs);
// positions at or past S are not written.
//
// int8 serving (the JAX kernel's quant / kv_quant / skv_quant mode), chosen
// by non-null scale pointers: the eight streamed weights are int8 with f32
// per-column scales (W8A16: the summed column times its scale, then the
// bias, megastep.py:433-457); the cross K/V are int8 with f32 (B, H, S) scales,
// converted to bf16 as they are staged, each score multiplied by its key's
// scale before the max and exp and each probability by its value's scale
// before the PV product, the softmax denominator unscaled
// (megastep.py:1053-1066); the self slabs are int8 with a bf16 scale slab
// (L, B, S, 2H): the commit quantizes each (position, head) row of 64 lanes
// with sc = max(amax, 1e-30) / 127 and rintf (half to even), clipped to
// +-127, and stores bf16(sc) (megastep.py:619-644); attention reads history
// rows j < offset as bf16(q * f32(bf16 scale)), dequantized as they are
// staged, and the chunk's own rows as the fresh bf16 K/V
// (models/whisper.py:943-950, :1006-1012).  One step then
// streams 0.73 GB of weights and B x 123 MB of cross K/V at large-v2.
//
// Medusa-Block serving (the JAX kernel runs the block as grid layer L,
// megastep.py:41-45, :562-571), chosen by a non-null P_BLOCK_HIDDEN: ln_post
// writes hidden into that third row buffer too and the entry runs the
// block layer on it through the same per-layer body (layer_step) with the
// block's own weight table (21 pointers, 8 scales at int8; never stacked
// onto the decoder's) and cache slot L of slabs holding L + 1 slots.  The
// buffer ends as block_hidden, with no ln_post (models/whisper.py:1258-1279);
// x keeps the main stack's pre_norm.  The block adds 46 MB of bf16 weights
// (23 MB int8) and B x 7.7 MB of cross K/V to the step's bytes.
//
// W8A32 (the int8 copy of an f32 model: the JAX kernel's quant / kv_quant /
// skv_quant mode at f32 activations), wm_megastep_w8a32, a C entry of its
// own: f32 residual stream, int8 streamed weights with f32 column scales,
// every other leaf f32, int8 self slabs with bf16 scales, int8 cross K/V
// with f32 scales.  The tensor cores take f32 only as TF32, so every
// product is FFMA on the CUDA cores (ffma_gemm.cuh, ffma_attn.cuh).  A
// layer is eleven launches:
//
//   ln_rows_f32 -> q/k/v (one GEMM, 3 jobs) -> self-attention with the
//   commit -> o + residual -> ln -> cross q -> cross-attention -> cross o +
//   residual -> ln -> fc1 + GELU -> fc2 + residual
//
// then ln_post into hidden (and the block's stream, whose layer runs on
// slot L as in the bf16 mode).  The six GEMMs are ffma_gemm.cuh's int8-
// weight mode (one launch each, no scratch: a TMA ring of 32 K x 64 int8 W
// chunks, each value converted exactly to f32 as a product warp reads it,
// the slices' sums added in rank order across a cluster, then the column's
// scale, the bias and the epilogue in the same kernel; K slices from (K, N)
// alone; the weights' maps over their (L, K, N) stacks, the layer a row
// offset; the plans, maps and shared memory set once a step).  The two
// attentions are ffma_attn.cuh's cluster body, decode_attn_f32_kernel<NR,
// SELF, Q8 = true, K2 = true> (one cluster per (head, example), slices from
// S alone, NR query rows from T; history from the int8 slab times its bf16
// scales, the chunk's keys from the fresh f32 rows, the commit in rank 0's
// CTA; cross scores times the key scale, probabilities times the value
// scale).  The GEMMs and the attentions are launched with programmatic
// dependent launch: a GEMM issues its first weight stages before its
// griddepcontrol.wait, the cross-attention its K / V loads and scales, the
// self-attention nothing (it waits first); ln_rows_f32_kernel is launched
// in stream order, after the kernel before it has finished (launched under
// programmatic dependent launch it made the step slower).  The
// arithmetic follows ops/megastep.py::w8a32_layer_step, the JAX kernel's
// line by line (megastep.py:589-720, :759-905, :1005-1160).  Bound on H100:
// bytes, 0.73 GB of int8 weights and B x 123 MB of int8 cross K/V a step at
// large-v2 (counted from the shapes), 0.26 ms at 3.35 TB/s for B = 1.
#include "cluster_attn.cuh"
#include "common.cuh"
#include "ffma_attn.cuh"
#include "ffma_gemm.cuh"
#include "hopper.cuh"
#include "wgemm.cuh"

namespace wm {
namespace {

constexpr int K2_MAX_ROWS = 128;   // B * T rows a step: the GEMM's 8 row tiles (gemm)

// ln_post: y[row] = LN(x[row]) in bf16 (and into y2 too, when given: the
// block's residual stream starts from ln_post's output); f32 statistics; one
// CTA per row.
__global__ void __launch_bounds__(256)
ln_rows_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, bf16* __restrict__ y2,
               const bf16* __restrict__ scale, const bf16* __restrict__ bias, int d) {
  griddep_launch();
  griddep_wait();
  __shared__ float red[8];
  const bf16* xr = x + (size_t)blockIdx.x * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int i = threadIdx.x; i < d; i += 256) s += bf2f(xr[i]);
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  float tot = 0.0f;
  for (int i = 0; i < 8; ++i) tot += red[i];
  const float mean = tot / d;
  __syncthreads();
  float v = 0.0f;
  for (int i = threadIdx.x; i < d; i += 256) {
    const float c = bf2f(xr[i]) - mean;
    v += c * c;
  }
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  tot = 0.0f;
  for (int i = 0; i < 8; ++i) tot += red[i];
  const float rstd = rsqrtf(tot / d + 1e-5f);
  for (int i = threadIdx.x; i < d; i += 256) {
    const bf16 r = f2bf((bf2f(xr[i]) - mean) * rstd * bf2f(scale[i]) + bf2f(bias[i]));
    y[(size_t)blockIdx.x * d + i] = r;
    if (y2) y2[(size_t)blockIdx.x * d + i] = r;
  }
}

// The eight streamed weights of a layer table as tensor maps over their
// (L, K, N) stacks (one layer: L = 1), in the order of _QUANT.
struct LayerMaps {
  CUtensorMap q, k, v, o, cq, co, fc1, fc2;
};

// One layer's weights, already offset to the layer: bf16, or int8 (the
// eight streamed weights) with their f32 per-column scales; the streamed
// weights themselves are read through ``maps`` at layer ``layer``.
struct LayerW {
  const bf16 *self_ln_s, *self_ln_b, *q_b, *v_b, *o_b, *cross_ln_s, *cross_ln_b, *cq_b,
      *co_b, *ffn_ln_s, *ffn_ln_b, *fc1_b, *fc2_b;
  const float *q_s, *k_s, *v_s, *o_s, *cq_s, *co_s, *fc1_s, *fc2_s;   // null: bf16
  const LayerMaps* maps;
  int layer;
};

// The buffers, cache and shapes one decode step shares across its layers.
struct StepCtx {
  int B, T, D, H, F, S, SE, cross_len, M, MT;
  bool quant;
  CdPlan self_plan, cross_plan;   // the attention kernels' splits (S, SE alone)
  bf16 *qb, *kb, *vb, *attn, *hb;
  void *self_k, *self_v;
  const void *cross_k, *cross_v;
  const float *cross_k_s, *cross_v_s;
  bf16* self_s;
  const int* offsets;
  const uint8_t* mask;
  CUtensorMap x_attn, x_h;   // X operands of o / cross o and fc2 (M rows)
  cudaStream_t st;
};

// The 21 weights of a layer table starting at pointer slot w0 (the order of
// ops/megastep.py _WEIGHTS) and its 8 scales at slot s0 (_QUANT), at layer l
// of (L, ...) stacks; a single layer (the block) is l = 0.
LayerW layer_weights(void* const* p, int w0, int s0, size_t l, int D, int F, bool quant,
                     const LayerMaps* maps) {
  const size_t lD = l * D, lF = l * F;
  auto B16 = [&](int i, size_t off) { return static_cast<const bf16*>(p[w0 + i]) + off; };
  auto S = [&](int i, size_t off) -> const float* {
    return quant ? static_cast<const float*>(p[s0 + i]) + off : nullptr;
  };
  LayerW w;
  w.self_ln_s = B16(0, lD);  w.self_ln_b = B16(1, lD);
  w.q_b = B16(3, lD);        w.v_b = B16(6, lD);      w.o_b = B16(8, lD);
  w.cross_ln_s = B16(9, lD); w.cross_ln_b = B16(10, lD);
  w.cq_b = B16(12, lD);      w.co_b = B16(14, lD);
  w.ffn_ln_s = B16(15, lD);  w.ffn_ln_b = B16(16, lD);
  w.fc1_b = B16(18, lF);     w.fc2_b = B16(20, lD);
  w.q_s = S(0, lD);  w.k_s = S(1, lD);  w.v_s = S(2, lD);  w.o_s = S(3, lD);
  w.cq_s = S(4, lD); w.co_s = S(5, lD); w.fc1_s = S(6, lF); w.fc2_s = S(7, lD);
  w.maps = maps;
  w.layer = (int)l;
  return w;
}

// Tensor maps of the eight streamed weights of the table at slot w0: (L, K,
// N) stacks of L layers, bf16 (128-byte swizzle) or int8 (raw).
int encode_layer_maps(LayerMaps* m, void* const* p, int w0, int L, int D, int F, bool quant) {
  const CUtensorMapDataType dt =
      quant ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = quant ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  const cuuint64_t es = quant ? 1 : 2;
  const cuuint32_t box[3] = {G_TILE, G_TILE, 1};
  struct { CUtensorMap* map; int slot, k, n; } w[8] = {
      {&m->q, 2, D, D},   {&m->k, 4, D, D},   {&m->v, 5, D, D},    {&m->o, 7, D, D},
      {&m->cq, 11, D, D}, {&m->co, 13, D, D}, {&m->fc1, 17, D, F}, {&m->fc2, 19, F, D}};
  for (auto& x : w) {
    const cuuint64_t dims[3] = {(cuuint64_t)x.n, (cuuint64_t)x.k, (cuuint64_t)L};
    const cuuint64_t strides[2] = {x.n * es, (cuuint64_t)x.k * x.n * es};
    const int err = encode_map(x.map, dt, 3, p[w0 + x.slot], dims, strides, box, sw);
    if (err) return err;
  }
  return 0;
}

// One projection of the step: Y (M, N) = epilogue(X (M, K) @ W[layer]) for
// ``njobs`` jobs sharing X; given ``ln``, in LN mode: X is the residual
// stream, normalized inside the GEMM.
int gemm(const StepCtx& c, const CUtensorMap& mx, const CUtensorMap* w0, const CUtensorMap* w1,
         const CUtensorMap* w2, int njobs, const GemmJobs& jobs, int layer, int k, int n,
         int ldo, const LnArgs* lna = nullptr) {
  const int stages = gemm_stages(k, n, njobs, c.MT, c.quant);
  const bool ln = lna != nullptr;
  if (ln && gemm_ln_k(k, n, njobs) > G_LN_MAXP * G_TILE) return (int)cudaErrorInvalidValue;
  const size_t smem = gemm_smem(c.MT, c.quant, stages, true, ln ? gemm_ln_k(k, n, njobs) : 0);
#define WM_GEMM(W8, LN)                                                                    \
  if (c.quant == W8 && ln == LN)                                                           \
    return wgemm_launch<8, W8, LN>(c.MT, stages, smem, c.st, mx, *w0, *w1, *w2, njobs, jobs, \
                                   layer, c.M, k, n, ldo, ldo, ln ? *lna : LnArgs{});
  WM_GEMM(false, false) WM_GEMM(false, true) WM_GEMM(true, false) WM_GEMM(true, true)
#undef WM_GEMM
  return (int)cudaErrorInvalidValue;
}

// Shared memory of the GEMM instantiations a step uses (above 48 KB needs
// the attribute; per call: it belongs to the current device's context):
// room for the deepest ring a projection takes, and in LN mode for the
// longest K slice of q/k/v, cross q and fc1.
void gemm_set_smem(int mt, bool w8, int d, int f) {
  const int stages = gemm_max_stages(mt, w8);
  const int lq = gemm_ln_k(d, d, 3), lc = gemm_ln_k(d, d, 1), lf = gemm_ln_k(d, f, 1);
  const int lk = lq > lc ? (lq > lf ? lq : lf) : (lc > lf ? lc : lf);
  const int smem = gemm_smem(mt, w8, stages), smem_ln = gemm_smem(mt, w8, stages, true, lk);
  if (w8) {
    wgemm_set_smem<8, true>(mt, smem);
    wgemm_set_smem<8, true, true>(mt, smem_ln);
  } else {
    wgemm_set_smem<8, false>(mt, smem);
    wgemm_set_smem<8, false, true>(mt, smem_ln);
  }
}

int ln_rows(const bf16* x, bf16* y, bf16* y2, const bf16* s, const bf16* b, int m, int d,
            cudaStream_t st) {
  return launch_pdl(ln_rows_kernel, dim3(m), dim3(256), 0, 0, st, x, y, y2, s, b, d);
}

#define WM_TRY(call)             \
  do {                           \
    const int err_ = (call);     \
    if (err_) return err_;       \
  } while (0)

// K2's attention on the cluster body (cluster_attn.cuh): q and out are the
// chunk's (M16, D) rows, i.e. (B, T, H, 64).
CdArgs attn_args(const StepCtx& c) {
  CdArgs a = {};
  a.q = c.qb;
  a.out = c.attn;
  a.q_b = (long long)c.T * c.D;
  a.q_h = CD_DH;
  a.q_t = c.D;
  a.heads = c.H;
  a.t_len = c.T;
  a.t_chunk = c.T;
  return a;
}

// Self-attention of slot `slot` in mask mode, committing the chunk's K/V
// rows (and int8 scales) into the slabs.
int self_attention(const StepCtx& c, size_t slot) {
  CdArgs a = attn_args(c);
  const size_t slab = slot * c.B * c.S * c.D;
  a.off = c.offsets;
  a.mask = c.mask;
  a.kn = c.kb;
  a.vn = c.vb;
  a.s_len = c.S;
  a.kv_len = c.S;
  if (c.quant) {
    a.k = static_cast<int8_t*>(c.self_k) + slab;
    a.v = static_cast<int8_t*>(c.self_v) + slab;
    a.ss = c.self_s + slot * c.B * c.S * 2 * c.H;
    return cd_launch<int8_t, true, true>(a, c.self_plan, c.B, c.st);
  }
  a.k = static_cast<bf16*>(c.self_k) + slab;
  a.v = static_cast<bf16*>(c.self_v) + slab;
  return cd_launch<bf16, true, true>(a, c.self_plan, c.B, c.st);
}

// Cross-attention of slot `slot` over its first cross_len keys.
int cross_attention(const StepCtx& c, size_t slot) {
  CdArgs a = attn_args(c);
  const size_t ck = slot * c.B * c.H * CD_DH * c.SE, cv = slot * c.B * c.SE * c.D;
  a.s_len = c.SE;
  a.kv_len = c.cross_len;
  if (c.quant) {
    const size_t cs = slot * c.B * c.H * c.SE;
    a.k = static_cast<const int8_t*>(c.cross_k) + ck;
    a.v = static_cast<const int8_t*>(c.cross_v) + cv;
    a.ks = c.cross_k_s + cs;
    a.vs = c.cross_v_s + cs;
    return cd_launch<int8_t, false, true>(a, c.cross_plan, c.B, c.st);
  }
  a.k = static_cast<const bf16*>(c.cross_k) + ck;
  a.v = static_cast<const bf16*>(c.cross_v) + cv;
  return cd_launch<bf16, false, true>(a, c.cross_plan, c.B, c.st);
}

// The two attention kernels' splits and shared memory, set once per call.
int attention_plans(StepCtx* c) {
  if (c->quant) {
    WM_TRY((cd_plan<int8_t, true, true>(c->S, &c->self_plan)));
    return cd_plan<int8_t, false, true>(c->SE, &c->cross_plan);
  }
  WM_TRY((cd_plan<bf16, true, true>(c->S, &c->self_plan)));
  return cd_plan<bf16, false, true>(c->SE, &c->cross_plan);
}

// One decoder layer over the chunk's rows in x (residual stream, updated in
// place; mx its tensor map), reading and writing cache slot `slot` of every
// slab.
int layer_step(const LayerW& w, bf16* x, const CUtensorMap& mx, size_t slot,
               const StepCtx& c) {
  const int D = c.D, F = c.F;
  const int l = w.layer;
  const LayerMaps& mp = *w.maps;
  const float scale = 0.125f;   // head dim ** -0.5
  // --- self-attention
  const LnArgs self_ln = {x, w.self_ln_s, w.self_ln_b};
  GemmJobs qkv;
  qkv.j[0] = gjob(w.q_b, c.qb, EPI_BIAS_SCALE, nullptr, scale, w.q_s);
  qkv.j[1] = gjob(nullptr, c.kb, EPI_BIAS, nullptr, 1.0f, w.k_s);
  qkv.j[2] = gjob(w.v_b, c.vb, EPI_BIAS, nullptr, 1.0f, w.v_s);
  WM_TRY(gemm(c, mx, &mp.q, &mp.k, &mp.v, 3, qkv, l, D, D, D, &self_ln));
  WM_TRY(self_attention(c, slot));
  GemmJobs o;
  o.j[0] = gjob(w.o_b, x, EPI_BIAS_RESID, x, 1.0f, w.o_s);
  WM_TRY(gemm(c, c.x_attn, &mp.o, &mp.o, &mp.o, 1, o, l, D, D, D));
  // --- cross-attention
  const LnArgs cross_ln = {x, w.cross_ln_s, w.cross_ln_b};
  GemmJobs cq;
  cq.j[0] = gjob(w.cq_b, c.qb, EPI_BIAS_SCALE, nullptr, scale, w.cq_s);
  WM_TRY(gemm(c, mx, &mp.cq, &mp.cq, &mp.cq, 1, cq, l, D, D, D, &cross_ln));
  WM_TRY(cross_attention(c, slot));
  GemmJobs co;
  co.j[0] = gjob(w.co_b, x, EPI_BIAS_RESID, x, 1.0f, w.co_s);
  WM_TRY(gemm(c, c.x_attn, &mp.co, &mp.co, &mp.co, 1, co, l, D, D, D));
  // --- FFN
  const LnArgs ffn_ln = {x, w.ffn_ln_s, w.ffn_ln_b};
  GemmJobs f1;
  f1.j[0] = gjob(w.fc1_b, c.hb, EPI_BIAS_GELU, nullptr, 1.0f, w.fc1_s);
  WM_TRY(gemm(c, mx, &mp.fc1, &mp.fc1, &mp.fc1, 1, f1, l, D, F, F, &ffn_ln));
  GemmJobs f2;
  f2.j[0] = gjob(w.fc2_b, x, EPI_BIAS_RESID, x, 1.0f, w.fc2_s);
  WM_TRY(gemm(c, c.x_h, &mp.fc2, &mp.fc2, &mp.fc2, 1, f2, l, F, D, D));
  return 0;
}

}  // namespace
}  // namespace wm

namespace wm {
namespace {

// W8A32: y[row] = LN(x[row]) in f32 (and into y2 too, when given); the
// two-pass f32 statistics of models/whisper.py::layer_norm; one CTA per row.
__global__ void __launch_bounds__(256)
ln_rows_f32_kernel(const float* __restrict__ x, float* __restrict__ y, float* __restrict__ y2,
                   const float* __restrict__ scale, const float* __restrict__ bias, int d) {
  __shared__ float red[8];
  const float* xr = x + (size_t)blockIdx.x * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int i = threadIdx.x; i < d; i += 256) s += xr[i];
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  float tot = 0.0f;
  for (int i = 0; i < 8; ++i) tot += red[i];
  const float mean = tot / d;
  __syncthreads();
  float v = 0.0f;
  for (int i = threadIdx.x; i < d; i += 256) {
    const float c = xr[i] - mean;
    v += c * c;
  }
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  tot = 0.0f;
  for (int i = 0; i < 8; ++i) tot += red[i];
  const float rstd = rsqrtf(tot / d + 1e-5f);
  for (int i = threadIdx.x; i < d; i += 256) {
    const float r = (xr[i] - mean) * rstd * scale[i] + bias[i];
    y[(size_t)blockIdx.x * d + i] = r;
    if (y2) y2[(size_t)blockIdx.x * d + i] = r;
  }
}

// One W8A32 layer's weights at layer l of (L, ...) stacks (a single layer,
// the block: l = 0): the f32 tensors of ops/megastep.py _WEIGHTS from slot
// w0 (the 8 streamed int8 weights are read through ``maps`` at W row l K)
// and the 8 f32 scales of _QUANT from slot s0.
struct LayerW32 {
  const float *self_ln_s, *self_ln_b, *q_b, *v_b, *o_b, *cross_ln_s, *cross_ln_b, *cq_b,
      *co_b, *ffn_ln_s, *ffn_ln_b, *fc1_b, *fc2_b;
  const float *q_s, *k_s, *v_s, *o_s, *cq_s, *co_s, *fc1_s, *fc2_s;
  const LayerMaps* maps;   // the 8 streamed weights' (L K, N) int8 maps
  int l;
};

LayerW32 layer_weights_w8a32(void* const* p, int w0, int s0, size_t l, int D, int F,
                             const LayerMaps* maps) {
  const size_t lD = l * D, lF = l * F;
  auto F32 = [&](int i, size_t off) { return static_cast<const float*>(p[w0 + i]) + off; };
  auto S = [&](int i, size_t off) { return static_cast<const float*>(p[s0 + i]) + off; };
  LayerW32 w;
  w.self_ln_s = F32(0, lD);  w.self_ln_b = F32(1, lD);
  w.q_b = F32(3, lD);        w.v_b = F32(6, lD);        w.o_b = F32(8, lD);
  w.cross_ln_s = F32(9, lD); w.cross_ln_b = F32(10, lD);
  w.cq_b = F32(12, lD);      w.co_b = F32(14, lD);
  w.ffn_ln_s = F32(15, lD);  w.ffn_ln_b = F32(16, lD);
  w.fc1_b = F32(18, lF);     w.fc2_b = F32(20, lD);
  w.q_s = S(0, lD);  w.k_s = S(1, lD);  w.v_s = S(2, lD);  w.o_s = S(3, lD);
  w.cq_s = S(4, lD); w.co_s = S(5, lD); w.fc1_s = S(6, lF); w.fc2_s = S(7, lD);
  w.maps = maps;
  w.l = (int)l;
  return w;
}

// The int8 maps of the eight streamed weights of the table at slot w0 over
// their (L, K, N) stacks (ffma_gemm.cuh's fg_w_map: L K rows; kept).
int encode_layer_maps_w8(LayerMaps* m, void* const* p, int w0, int L, int D, int F) {
  struct { CUtensorMap* map; int slot, k, n; } w[8] = {
      {&m->q, 2, D, D},   {&m->k, 4, D, D},   {&m->v, 5, D, D},    {&m->o, 7, D, D},
      {&m->cq, 11, D, D}, {&m->co, 13, D, D}, {&m->fc1, 17, D, F}, {&m->fc2, 19, F, D}};
  for (auto& x : w) {
    const int err = fg_w_map(x.map, p[w0 + x.slot], L * x.k, x.n, true);
    if (err) return err;
  }
  return 0;
}

// The buffers, caches, maps and plans one W8A32 step shares across its
// layers.
struct StepCtx32 {
  int B, T, D, H, F, S, SE, cross_len, M;
  float *ln, *qb, *kb, *vb, *attn, *hb;
  int8_t *self_k, *self_v, *cross_k, *cross_v;
  const float *cross_k_s, *cross_v_s;
  bf16* self_s;
  const int *offsets, *bits;
  CUtensorMap x_ln, x_attn, x_h;     // the GEMMs' X operands (M rows)
  FgPlan g_dd3, g_dd, g_df, g_fd;    // q/k/v (3 jobs), D x D, fc1, fc2
  DaPlan self_plan, cross_plan;      // the attention's splits (S, SE) and rows (T)
  CUtensorMap cross_mk, cross_mv;    // the cross V's map over every slot (K: int8, cp.async)
  cudaStream_t st;
};

FgJob job32(const float* s, const float* b, float* out, int epi, int wrow,
            const float* resid = nullptr, float post = 1.0f) {
  return FgJob{b, s, resid, out, post, epi, wrow};
}

// One W8A32 GEMM of the step: Y = epi(X @ W + b) for ``njobs`` jobs sharing
// X (maps of W in ``mw``), on the plan for (K, N).
int gemm32(const StepCtx32& c, const CUtensorMap& mx, const CUtensorMap* mw, int njobs,
           const FgJob* jobs, const FgPlan& p, int k, int n) {
  FgArgs a = {};
  for (int i = 0; i < njobs; ++i) a.j[i] = jobs[i];
  a.njobs = njobs;
  return fg_launch_maps(mx, mw, njobs, a, p, c.M, k, n, njobs, true, c.st);
}

// The attention's arguments over the chunk's (M, D) rows, (B, T, H, 64).
DfArgs attn_args32(const StepCtx32& c) {
  DfArgs a = {};
  a.q = c.qb;
  a.out = c.attn;
  a.q_b = (long long)c.T * c.D;
  a.q_h = CD_DH;
  a.q_t = c.D;
  a.heads = c.H;
  a.t_len = c.T;
  a.t_chunk = c.T;
  return a;
}

#define WM_TRY32(call)           \
  do {                           \
    const int err_ = (call);     \
    if (err_) return err_;       \
  } while (0)

int launch_ln32(const float* x, float* y, float* y2, const float* s, const float* b, int m,
                int d, cudaStream_t st) {
  ln_rows_f32_kernel<<<m, 256, 0, st>>>(x, y, y2, s, b, d);
  return (int)cudaGetLastError();
}

// One W8A32 decoder layer over the chunk's rows in x (f32 residual stream,
// updated in place) on cache slot `slot`: eleven launches, the six GEMMs
// and the two attentions under programmatic dependent launch (the norms in
// stream order).
int layer_step_w8a32(const LayerW32& w, float* x, size_t slot, const StepCtx32& c) {
  const int D = c.D, F = c.F, M = c.M;
  const int rd = w.l * D, rf = w.l * F;   // the layer's first W row: (L, D, .) or (L, F, D)
  const LayerMaps& mp = *w.maps;
  const float scale = 0.125f;   // head dim ** -0.5
  // --- self-attention
  WM_TRY32(launch_ln32(x, c.ln, nullptr, w.self_ln_s, w.self_ln_b, M, D, c.st));
  const CUtensorMap qkv_maps[3] = {mp.q, mp.k, mp.v};
  const FgJob qkv[3] = {job32(w.q_s, w.q_b, c.qb, EPI_BIAS_SCALE, rd, nullptr, scale),
                        job32(w.k_s, nullptr, c.kb, EPI_BIAS, rd),
                        job32(w.v_s, w.v_b, c.vb, EPI_BIAS, rd)};
  WM_TRY32(gemm32(c, c.x_ln, qkv_maps, 3, qkv, c.g_dd3, D, D));
  {
    DfArgs a = attn_args32(c);
    const size_t slab = slot * c.B * c.S * D;
    a.off = c.offsets;
    a.bits = c.bits;
    a.k8 = c.self_k + slab;
    a.v8 = c.self_v + slab;
    a.ss = c.self_s + slot * c.B * c.S * 2 * c.H;
    a.kn = c.kb;
    a.vn = c.vb;
    a.s_len = c.S;
    a.kv_len = c.S;
    WM_TRY32((da_launch<true, true, true>(c.cross_mk, c.cross_mv, a, c.self_plan, c.B, c.st)));
  }
  const FgJob o = job32(w.o_s, w.o_b, x, EPI_BIAS_RESID, rd, x);
  WM_TRY32(gemm32(c, c.x_attn, &mp.o, 1, &o, c.g_dd, D, D));
  // --- cross-attention
  WM_TRY32(launch_ln32(x, c.ln, nullptr, w.cross_ln_s, w.cross_ln_b, M, D, c.st));
  const FgJob cq = job32(w.cq_s, w.cq_b, c.qb, EPI_BIAS_SCALE, rd, nullptr, scale);
  WM_TRY32(gemm32(c, c.x_ln, &mp.cq, 1, &cq, c.g_dd, D, D));
  {
    DfArgs a = attn_args32(c);
    const size_t ck = slot * c.B * c.H * CD_DH * c.SE, cv = slot * c.B * c.SE * D;
    const size_t cs = slot * c.B * c.H * c.SE;
    a.k8 = c.cross_k + ck;
    a.v8 = c.cross_v + cv;
    a.ks = c.cross_k_s + cs;
    a.vs = c.cross_v_s + cs;
    a.s_len = c.SE;
    a.kv_len = c.cross_len;
    a.vz = (int)(slot * c.B);
    WM_TRY32((da_launch<false, true, true>(c.cross_mk, c.cross_mv, a, c.cross_plan, c.B, c.st)));
  }
  const FgJob co = job32(w.co_s, w.co_b, x, EPI_BIAS_RESID, rd, x);
  WM_TRY32(gemm32(c, c.x_attn, &mp.co, 1, &co, c.g_dd, D, D));
  // --- FFN
  WM_TRY32(launch_ln32(x, c.ln, nullptr, w.ffn_ln_s, w.ffn_ln_b, M, D, c.st));
  const FgJob f1 = job32(w.fc1_s, w.fc1_b, c.hb, EPI_BIAS_GELU, rd);
  WM_TRY32(gemm32(c, c.x_ln, &mp.fc1, 1, &f1, c.g_df, D, F));
  const FgJob f2 = job32(w.fc2_s, w.fc2_b, x, EPI_BIAS_RESID, rf, x);
  WM_TRY32(gemm32(c, c.x_h, &mp.fc2, 1, &f2, c.g_fd, F, D));
  return 0;
}

}  // namespace
}  // namespace wm

// Pointer table of wm_megastep_w8a32 (ops/megastep.py builds the same list).
enum MegastepW8A32Ptr {
  A_X = 0,        // (M, D) f32 residual stream: embedded chunk in, pre_norm out
  A_LN,           // (M, D) f32 scratch: a layer norm's output
  A_Q, A_K, A_V,  // (M, D) f32 scratch: projections
  A_ATTN,         // (M, D) f32 scratch: attention output
  A_H,            // (M, F) f32 scratch: fc1 output
  A_SELF_K, A_SELF_V,        // (L', B, S, D) int8 slabs, updated in place
  A_SELF_S,                  // (L', B, S, 2H) bf16 scales, updated in place
  A_CROSS_K,                 // (L', B, H, 64, Se) int8
  A_CROSS_V,                 // (L', B, Se, D) int8
  A_CROSS_K_S, A_CROSS_V_S,  // (L', B, H, Se) f32
  A_OFFSETS,                 // (B,) int32
  A_BITS,                    // (T, 1) int32 chunk bits (decode_ops.chunk_bits), diagonal set
  A_W0,                      // the stack's 21 weights (_WEIGHTS), (L, ...)
  A_S0 = A_W0 + 21,          // and its 8 scales (_QUANT)
  A_LN_POST_S = A_S0 + 8, A_LN_POST_B,   // (D,) f32
  A_HIDDEN,                  // (M, D) f32 out: ln_post(pre_norm)
  A_BLOCK_HIDDEN,            // (M, D) f32 block stream, out: block_hidden; null: no block
  A_B_W0,                    // the block's 21 weights, unstacked
  A_B_S0 = A_B_W0 + 21,      // and its 8 scales
  A_COUNT = A_B_S0 + 8
};

// ints: L, B, T, D, H, F, S (self slab rows), Se (cross rows), cross_len;
// L' = L slab slots, or L + 1 with the block (slot L is the block's).  D and
// F multiples of 64 (and of 32: the GEMM's K chunk), Se % 4 == 0.
extern "C" int wm_megastep_w8a32(void** p, const int* ints, void* stream) {
  using namespace wm;
  const int L = ints[0], B = ints[1], T = ints[2], D = ints[3], H = ints[4];
  const int F = ints[5], S = ints[6], SE = ints[7], cross_len = ints[8];
  if (T < 1 || T > CD_MAXT || B < 1 || B > 8 || D != H * CD_DH || D % FG_COLS ||
      F % FG_COLS || SE % 4 || cross_len < 1 || cross_len > SE || S < T)
    return (int)cudaErrorInvalidValue;
  const bool block = p[A_BLOCK_HIDDEN] != nullptr;
  for (int i = 0; i <= A_HIDDEN; ++i)
    if (!p[i]) return (int)cudaErrorInvalidValue;
  for (int i = A_B_W0; block && i < A_COUNT; ++i)
    if (!p[i]) return (int)cudaErrorInvalidValue;
  StepCtx32 c;
  c.B = B; c.T = T; c.D = D; c.H = H; c.F = F; c.S = S; c.SE = SE; c.M = B * T;
  c.cross_len = cross_len;
  auto P = [&](int i) { return static_cast<float*>(p[i]); };
  float* x = P(A_X);
  c.ln = P(A_LN); c.qb = P(A_Q); c.kb = P(A_K); c.vb = P(A_V);
  c.attn = P(A_ATTN); c.hb = P(A_H);
  c.self_k = static_cast<int8_t*>(p[A_SELF_K]);
  c.self_v = static_cast<int8_t*>(p[A_SELF_V]);
  c.self_s = static_cast<bf16*>(p[A_SELF_S]);
  c.cross_k = static_cast<int8_t*>(p[A_CROSS_K]);
  c.cross_v = static_cast<int8_t*>(p[A_CROSS_V]);
  c.cross_k_s = P(A_CROSS_K_S);
  c.cross_v_s = P(A_CROSS_V_S);
  c.offsets = static_cast<const int*>(p[A_OFFSETS]);
  c.bits = static_cast<const int*>(p[A_BITS]);
  c.st = (cudaStream_t)stream;
  // The GEMMs' plans (K slices from (K, N) alone, passes from M) and their
  // shared memory; the X maps; the streamed weights' maps; the attention's
  // plans and shared memory: once a step.
  const int M = c.M;
  c.g_dd3 = fg_plan(M, D, D, 3, true);
  c.g_dd = fg_plan(M, D, D, 1, true);
  c.g_df = fg_plan(M, D, F, 1, true);
  c.g_fd = fg_plan(M, F, D, 1, true);
  int smem = 0;
  for (const FgPlan* g : {&c.g_dd3, &c.g_dd, &c.g_df, &c.g_fd})
    smem = g->smem > smem ? g->smem : smem;
  WM_TRY32(fg_set_smem(c.g_dd.rq, true, smem));
  WM_TRY32(fg_x_map(&c.x_ln, c.ln, M, D, c.g_dd.rq));
  WM_TRY32(fg_x_map(&c.x_attn, c.attn, M, D, c.g_dd.rq));
  WM_TRY32(fg_x_map(&c.x_h, c.hb, M, F, c.g_dd.rq));
  LayerMaps stack_maps, block_maps;
  WM_TRY32(encode_layer_maps_w8(&stack_maps, p, A_W0, L, D, F));
  if (block) WM_TRY32(encode_layer_maps_w8(&block_maps, p, A_B_W0, 1, D, F));
  WM_TRY32((da_plan<true, true, true>(S, T, &c.self_plan)));
  WM_TRY32((da_plan<false, true, true>(SE, T, &c.cross_plan)));
  const int slots = L + (block ? 1 : 0);
  WM_TRY32(da_maps(&c.cross_mk, &c.cross_mv, c.cross_k, c.cross_v, true, SE, H,
                   slots * B * H * CD_DH, slots * B, da_kbox(c.cross_plan.slice)));
  for (int l = 0; l < L; ++l)
    WM_TRY32(layer_step_w8a32(
        layer_weights_w8a32(p, A_W0, A_S0, l, D, F, &stack_maps), x, l, c));
  float* bx = block ? P(A_BLOCK_HIDDEN) : nullptr;
  WM_TRY32(launch_ln32(x, P(A_HIDDEN), bx, P(A_LN_POST_S), P(A_LN_POST_B), c.M, D, c.st));
  if (block)
    WM_TRY32(layer_step_w8a32(layer_weights_w8a32(p, A_B_W0, A_B_S0, 0, D, F, &block_maps), bx,
                              L, c));
  return (int)cudaGetLastError();
}

// Pointer table of wm_megastep_step (ops/megastep.py builds the same list).
enum MegastepPtr {
  P_X = 0,        // (M16, D) bf16 hidden: embedded chunk in, pre_norm out
  P_Q, P_K, P_V,  // (M16, D) bf16 scratch: projections
  P_ATTN,         // (M16, D) bf16 scratch: attention output
  P_H,            // (M16, F) bf16 scratch: fc1 output
  P_SELF_K, P_SELF_V,    // (L', B, S, D) bf16 (int8) slabs, updated in place
  P_CROSS_K,             // (L', B, H, 64, Se) bf16 (int8)
  P_CROSS_V,             // (L', B, Se, D) bf16 (int8)
  P_OFFSETS,             // (B,) int32
  P_MASK,                // (T, T) uint8 chunk mask, its diagonal set
  P_SELF_LN_S, P_SELF_LN_B, P_Q_W, P_Q_B, P_K_W, P_V_W, P_V_B, P_O_W, P_O_B,
  P_CROSS_LN_S, P_CROSS_LN_B, P_CQ_W, P_CQ_B, P_CO_W, P_CO_B,
  P_FFN_LN_S, P_FFN_LN_B, P_FC1_W, P_FC1_B, P_FC2_W, P_FC2_B,
  P_LN_POST_S, P_LN_POST_B,   // (D,) bf16 final layer norm
  P_HIDDEN,                   // (M, D) bf16 out: ln_post(pre_norm)
  // int8 serving (all null in bf16 mode): the streamed weights above are
  // int8 and these are their f32 per-column scales, (L, D) or (L, F) ...
  P_Q_S, P_K_S, P_V_S, P_O_S, P_CQ_S, P_CO_S, P_FC1_S, P_FC2_S,
  P_CROSS_K_S, P_CROSS_V_S,   // (L', B, H, Se) f32 cross scales
  P_SELF_S,                   // (L', B, S, 2H) bf16 self scales, updated in place
  // Block mode (all null without a block): the Medusa-Block layer's
  // residual stream, (M16, D) bf16, out: block_hidden ...
  P_BLOCK_HIDDEN,
  // ... its 21 weights, unstacked, in the order of P_SELF_LN_S .. P_FC2_B ...
  P_B_W0,
  // ... and, at int8, the 8 scales of its streamed weights.
  P_B_S0 = P_B_W0 + 21,
  P_COUNT = P_B_S0 + 8
};

// How many clusters of K2's self- and cross-attention kernels the card can
// hold at once (cudaOccupancyMaxActiveClusters, with their shared memory
// set): out[0] self over S slab rows, out[1] cross over SE keys, -1 where the
// query fails; int8 caches when quant.  A diagnostic for chip_smoke.py.
extern "C" int wm_megastep_clusters(int B, int H, int S, int SE, int quant, int* out) {
  using namespace wm;
  StepCtx c;
  c.S = S;
  c.SE = SE;
  c.quant = quant != 0;
  WM_TRY(attention_plans(&c));
  out[0] = c.quant ? cd_max_clusters<int8_t, true, true>(c.self_plan, H, B)
                   : cd_max_clusters<bf16, true, true>(c.self_plan, H, B);
  out[1] = c.quant ? cd_max_clusters<int8_t, false, true>(c.cross_plan, H, B)
                   : cd_max_clusters<bf16, false, true>(c.cross_plan, H, B);
  return (int)cudaGetLastError();
}

// ints: L, B, T, D, H, F, S (self slab rows), Se (cross rows), cross_len.
// L' = L slab slots, or L + 1 in block mode (slot L is the block's).
// M16 = ceil(B * T / 16) * 16 rows are allocated in every row buffer.
// D % 128 and F % D, the JAX gate's widths (whisper tiny's 384 and 1536:
// every projection then has 64-wide K slices, 6-CTA clusters; every K slice
// and cluster size comes from gemm_slices, so no width needs code of its
// own); ops/megastep.py::fits adds the narrower conditions the kernels need.
extern "C" int wm_megastep_step(void** p, const int* ints, void* stream) {
  using namespace wm;
  const int L = ints[0], B = ints[1], T = ints[2], D = ints[3], H = ints[4];
  const int F = ints[5], S = ints[6], SE = ints[7], cross_len = ints[8];
  const int M = B * T;
  cudaStream_t st = (cudaStream_t)stream;
  if (T > CD_MAXT || B > 8 || M > K2_MAX_ROWS || H < 1 || D != H * CD_DH || D % 128 || F % D ||
      SE % 4 || cross_len < 1 || cross_len > SE || S < T)
    return (int)cudaErrorInvalidValue;
  const bool quant = p[P_Q_S] != nullptr;
  const bool block = p[P_BLOCK_HIDDEN] != nullptr;
  for (int i = P_K_S; quant && i <= P_SELF_S; ++i)
    if (!p[i]) return (int)cudaErrorInvalidValue;
  for (int i = P_B_W0; block && i < P_B_S0 + (quant ? 8 : 0); ++i)
    if (!p[i]) return (int)cudaErrorInvalidValue;
  StepCtx c;
  c.B = B; c.T = T; c.D = D; c.H = H; c.F = F; c.S = S; c.SE = SE; c.M = M;
  c.MT = (M + 15) / 16;
  c.cross_len = cross_len;
  c.quant = quant;
  WM_TRY(attention_plans(&c));
  gemm_set_smem(c.MT, quant, D, F);
  auto P = [&](int i) { return static_cast<bf16*>(p[i]); };
  bf16* x = P(P_X);
  c.qb = P(P_Q); c.kb = P(P_K); c.vb = P(P_V);
  c.attn = P(P_ATTN); c.hb = P(P_H);
  c.self_k = p[P_SELF_K]; c.self_v = p[P_SELF_V];
  c.cross_k = p[P_CROSS_K]; c.cross_v = p[P_CROSS_V];
  c.cross_k_s = static_cast<const float*>(p[P_CROSS_K_S]);
  c.cross_v_s = static_cast<const float*>(p[P_CROSS_V_S]);
  c.self_s = P(P_SELF_S);
  c.offsets = static_cast<const int*>(p[P_OFFSETS]);
  c.mask = static_cast<const uint8_t*>(p[P_MASK]);
  c.st = st;
  // Tensor maps: the GEMMs' X operands (the residual streams for the LN
  // mode), then the streamed weights of the stack and of the block, each
  // over its whole stack (the layer is a coordinate).
  bf16* bx = block ? P(P_BLOCK_HIDDEN) : nullptr;
  CUtensorMap x_map, bx_map;
  LayerMaps stack_maps, block_maps;
  WM_TRY(encode_x_map(&x_map, x, M, D, c.MT));
  if (block) WM_TRY(encode_x_map(&bx_map, bx, M, D, c.MT));
  WM_TRY(encode_x_map(&c.x_attn, c.attn, M, D, c.MT));
  WM_TRY(encode_x_map(&c.x_h, c.hb, M, F, c.MT));
  WM_TRY(encode_layer_maps(&stack_maps, p, P_SELF_LN_S, L, D, F, quant));
  if (block) WM_TRY(encode_layer_maps(&block_maps, p, P_B_W0, 1, D, F, quant));

  for (int l = 0; l < L; ++l)
    WM_TRY(layer_step(layer_weights(p, P_SELF_LN_S, P_Q_S, l, D, F, quant, &stack_maps), x,
                      x_map, l, c));
  // ln_post; in block mode also into the block's residual stream, which
  // starts from ln_post's output while x keeps the main stack's pre_norm.
  WM_TRY(ln_rows(x, P(P_HIDDEN), bx, P(P_LN_POST_S), P(P_LN_POST_B), M, D, st));
  if (block)
    WM_TRY(layer_step(layer_weights(p, P_B_W0, P_B_S0, 0, D, F, quant, &block_maps), bx,
                      bx_map, L, c));
  return (int)cudaGetLastError();
}
