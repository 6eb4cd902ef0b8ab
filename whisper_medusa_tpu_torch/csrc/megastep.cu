// K2 — the whole decoder stack over one decode chunk (T <= 16 tokens per
// example, B <= 8 examples, B*T <= 128 rows), plus the final layer norm.
//
// Replaces whisper_medusa_tpu/ops/megastep.py::_kernel (TPU, launched by
// fused_decoder_layers), one pallas_call whose grid walks (layers, phases)
// with the hidden state carried in VMEM while Mosaic streams the next phase's
// weights.  On Hopper the same work is a fixed sequence of small kernels per
// layer, launched back to back on one stream by one C entry (one ctypes call
// per decode step):
//
//   LN -> q/k/v (one GEMM launch, 3 jobs) -> self-attention + in-place
//   K/V commit -> o + residual -> LN -> cross q -> cross-attention partials
//   over 128-key chunks -> combine -> cross o + residual -> LN -> fc1 + GELU
//   -> fc2 + residual
//
// and after the last layer ln_post into a second buffer (hidden), so the
// whole decoder output comes from kernels whose per-row arithmetic does not
// depend on the number of rows (batch invariance).
//
// The hidden state stays in a bf16 buffer of ceil(B*T / 16) * 16 rows in
// device memory (L2 resident) between kernels.  Bound on H100: bytes.  At
// large-v2 one step reads 32 x (6 x 1280^2 + 2 x 1280 x 5120) bf16 weights =
// 1.47 GB, whatever B is, plus B x 32 x 2 x 1500 x 1280 bf16 cross K/V =
// B x 246 MB (counted from the shapes); cross-attention splits the 1500 keys
// into 128-key chunks, a grid of 12 x 20 x B CTAs; self-attention runs
// 20 x B CTAs.
//
// The six projections of a layer run on one weight-streaming GEMM
// (wgemm_kernel), Y^T = W^T X^T on wgmma:
//
//  * a CTA takes 64 W columns (wgmma's 64-row A side, MN-major, 128-byte
//    swizzle) over one K slice; one producer warp streams the W tiles (64 K
//    x 64 columns, bf16 as TMA writes them, int8 raw and converted exactly
//    to bf16 in shared memory) and the matching X tiles (ceil(M / 16) * 16
//    rows x 64 K, rows past M zero-filled, from L2) through a TMA ring deep
//    enough for the CTA's whole slice at B = 1 (up to 96 KB; 4 stages past
//    32 rows); one consumer warpgroup runs one m64nNk16 product per 16-deep
//    step, N = ceil(M / 16) * 16 (WgmmaN); a row's products are one chain in
//    K order whatever M is (on the H100 an element of wgmma does not depend
//    on N: chip_smoke.py holds B = 8 bitwise B = 1);
//  * K is cut into slices from (K, N, jobs) alone (gemm_slices), enough for
//    132 CTAs and at most 8: q/k/v 3 slices x 60 tiles, o / cross q / cross
//    o and fc2 7 x 20, fc1 2 x 80.  The slices of a column tile are one
//    thread-block cluster; each CTA leaves its f32 partial in shared memory
//    and rank r adds the slices for its share of the rows in rank order
//    through distributed shared memory, then runs the epilogue (bias, the
//    q scale, exact-erf GELU or the residual, rounded where the plain
//    version rounds).  One fixed order, no atomics, no scratch: B = 8 gives
//    each example its B = 1 bits;
//  * the weights come from tensor maps over the (L, K, N) stacks, encoded
//    once a step (the layer is a coordinate).
//
// Every kernel of the step is launched with programmatic dependent launch
// (cudaLaunchAttributeProgrammaticStreamSerialization): each lets the next
// kernel launch at its start (griddepcontrol.launch_dependents) and waits
// for the previous one (griddepcontrol.wait) before it touches what that
// one writes.  Rule, kept by every kernel here: before its wait a kernel
// reads only weights and writes only its own shared memory.  A GEMM's
// producer issues its first ring of weight loads before the wait, so the
// next projection's weights are in flight while the kernels before it
// finish: the Hopper counterpart of the TPU kernel's cross-phase prefetch.
//
// Numerics follow models/whisper.py::decoder_layer_step: f32 layernorm
// statistics, softmax and accumulation; bf16 operands and activations;
// exact erf GELU (erff).  Self-attention masks: history key j < offset is
// visible; chunk key offset + c is visible to query t iff mask[t][c];
// masked scores take NEG_SELF = -1e30 (megastep.py:134).  Cross keys
// >= cross_len are excluded (the JAX path gives them NEG_CROSS, i.e. zero
// probability).  The chunk's K/V rows are written into the self slabs in
// place (the JAX kernel aliases its slab outputs to its inputs).
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
// rows j < offset as bf16(q * f32(bf16 scale)) and the chunk's own rows as
// the fresh bf16 K/V (models/whisper.py:943-950, :1006-1012).  One step then
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
#include <cooperative_groups.h>

#include <type_traits>
#include <utility>

#include "common.cuh"
#include "hopper.cuh"

namespace wm {
namespace {

namespace cg = cooperative_groups;

constexpr int DH = 64;        // head dim
constexpr int CS = 128;       // cross-attention keys per chunk
constexpr int MAXT = 16;      // chunk rows per example
constexpr int AT = 512;       // threads of the attention kernels
constexpr int RG = AT / DH;   // row groups in the PV loops (rows g, g + RG)

// y[row] = LN(x[row]) in bf16 (and into y2 too, when given: the block's
// residual stream starts from ln_post's output); f32 statistics; one CTA per
// row.
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

__device__ __forceinline__ int8_t quant8(float x, float sc) {
  return (int8_t)fminf(fmaxf(rintf(x / sc), -127.0f), 127.0f);
}

// 8 int8 values times a scale, each rounded to bf16 (the dequantized row).
__device__ __forceinline__ uint4 dequant8(uint2 raw, float sc) {
  return make_uint4(pack_bf2(i8_at(raw.x, 0) * sc, i8_at(raw.x, 1) * sc),
                    pack_bf2(i8_at(raw.x, 2) * sc, i8_at(raw.x, 3) * sc),
                    pack_bf2(i8_at(raw.y, 0) * sc, i8_at(raw.y, 1) * sc),
                    pack_bf2(i8_at(raw.y, 2) * sc, i8_at(raw.y, 3) * sc));
}

// Self-attention over [0, offset + T) with the chunk's K/V committed first.
// One CTA (512 threads) per (head, example).  Dynamic smem: q (T x 64) and
// the score/probability rows (T x S), float; the head's V rows (S x 64), bf16,
// staged with 16-byte loads so the PV loop reads shared memory.  Q: int8
// slabs with the layer's (B, S, 2H) bf16 scale slab (see the file comment).
template <bool Q>
__global__ void __launch_bounds__(AT)
self_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 void* __restrict__ slab_k, void* __restrict__ slab_v,
                 bf16* __restrict__ slab_s, const int* __restrict__ offsets,
                 const uint8_t* __restrict__ mask, int t_len, int s_len, int d,
                 int n_heads) {
  griddep_launch();
  griddep_wait();
  using ST = typename std::conditional<Q, int8_t, bf16>::type;
  ST* sk = static_cast<ST*>(slab_k);
  ST* sv = static_cast<ST*>(slab_v);
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                    // [T][64]
  float* sc = sm + t_len * DH;       // [T][s_len]
  // [s_len][64], 16-byte aligned for the uint4 stores
  bf16* vs = reinterpret_cast<bf16*>(sm + ((t_len * (DH + s_len) + 3) & ~3));
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int off = offsets[b];
  const size_t slab0 = (size_t)b * s_len * d + (size_t)h * DH;
  // (position j, lane) of the scale slab: K scale of head h, V at + n_heads.
  const size_t srow0 = (size_t)b * s_len * 2 * n_heads + h;

  if constexpr (Q) {
    // One warp per chunk row: lanes hold columns lane and lane + 32.
    for (int t = warp; t < t_len; t += AT / 32) {
      const size_t src = (size_t)(b * t_len + t) * d + h * DH;
      const float k0 = bf2f(k[src + lane]), k1 = bf2f(k[src + lane + 32]);
      const float v0 = bf2f(v[src + lane]), v1 = bf2f(v[src + lane + 32]);
      const float ksc = fmaxf(warp_max(fmaxf(fabsf(k0), fabsf(k1))), 1e-30f) / 127.0f;
      const float vsc = fmaxf(warp_max(fmaxf(fabsf(v0), fabsf(v1))), 1e-30f) / 127.0f;
      if (off + t < s_len) {
        const size_t dst = slab0 + (size_t)(off + t) * d;
        sk[dst + lane] = quant8(k0, ksc);
        sk[dst + lane + 32] = quant8(k1, ksc);
        sv[dst + lane] = quant8(v0, vsc);
        sv[dst + lane + 32] = quant8(v1, vsc);
        if (lane == 0) {
          slab_s[srow0 + (size_t)(off + t) * 2 * n_heads] = f2bf(ksc);
          slab_s[srow0 + (size_t)(off + t) * 2 * n_heads + n_heads] = f2bf(vsc);
        }
      }
    }
    for (int i = tid; i < t_len * DH; i += AT) {
      const int t = i / DH, c = i % DH;
      qs[t * DH + c] = bf2f(q[(size_t)(b * t_len + t) * d + h * DH + c]);
    }
  } else {
    for (int i = tid; i < t_len * DH; i += AT) {
      const int t = i / DH, c = i % DH;
      const size_t src = (size_t)(b * t_len + t) * d + h * DH + c;
      if (off + t < s_len) {
        sk[slab0 + (size_t)(off + t) * d + c] = k[src];
        sv[slab0 + (size_t)(off + t) * d + c] = v[src];
      }
      qs[t * DH + c] = bf2f(q[src]);
    }
  }
  __syncthreads();

  const int nk = min(off + t_len, s_len);
  for (int i = tid; i < nk * (DH / 8); i += AT) {
    const int j = i / (DH / 8), c8 = (i % (DH / 8)) * 8;
    uint4 val;
    if constexpr (Q) {
      if (j < off)
        val = dequant8(*reinterpret_cast<const uint2*>(sv + slab0 + (size_t)j * d + c8),
                       bf2f(slab_s[srow0 + (size_t)j * 2 * n_heads + n_heads]));
      else
        val = load8(v + (size_t)(b * t_len + j - off) * d + h * DH + c8);
    } else {
      val = load8(sv + slab0 + (size_t)j * d + c8);
    }
    *reinterpret_cast<uint4*>(vs + j * DH + c8) = val;
  }
  for (int j = tid; j < nk; j += AT) {
    float acc[MAXT];
#pragma unroll
    for (int t = 0; t < MAXT; ++t) acc[t] = 0.0f;
    // History rows from the slab; with int8 slabs the chunk's rows come
    // fresh from k.
    const bool hist = !Q || j < off;
    const ST* kr = sk + slab0 + (size_t)j * d;
    const bf16* kf16 = k + ((size_t)b * t_len + (hist ? 0 : j - off)) * d + h * DH;
    const float ksc = (Q && hist) ? bf2f(slab_s[srow0 + (size_t)j * 2 * n_heads]) : 1.0f;
#pragma unroll
    for (int c8 = 0; c8 < DH; c8 += 8) {
      float kf[8];
      if constexpr (Q) {
        if (hist) {
          const uint2 raw = *reinterpret_cast<const uint2*>(kr + c8);
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = bfr(i8_at(e < 4 ? raw.x : raw.y, e & 3) * ksc);
        } else {
          const uint4 raw = load8(kf16 + c8);
          const bf16* kv8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = bf2f(kv8[e]);
        }
      } else {
        const uint4 raw = load8(kr + c8);
        const bf16* kv8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = bf2f(kv8[e]);
      }
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        if (t < t_len) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[t] += qs[t * DH + c8 + e] * kf[e];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (t < t_len) {
        const bool vis = j < off || mask[t * t_len + (j - off)] != 0;
        sc[t * s_len + j] = vis ? acc[t] : acc[t] + NEG_SELF;
      }
    }
  }
  __syncthreads();

  // Softmax per row, probabilities rounded to bf16 (as the JAX path does
  // before its PV product).
  for (int t = warp; t < t_len; t += AT / 32) {
    float* row = sc + t * s_len;
    float m = -INFINITY;
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.0f;
    for (int j = lane; j < nk; j += 32) s += expf(row[j] - m);
    s = warp_sum(s);
    const float inv = 1.0f / s;
    for (int j = lane; j < nk; j += 32) row[j] = bfr(expf(row[j] - m) * inv);
  }
  __syncthreads();

  // PV: thread (group g, column c) accumulates rows t = g, g + RG, ...
  const int c = tid & 63, g = tid >> 6;
  float acc[MAXT / RG];
#pragma unroll
  for (int i = 0; i < MAXT / RG; ++i) acc[i] = 0.0f;
  for (int j = 0; j < nk; ++j) {
    const float vv = bf2f(vs[j * DH + c]);
#pragma unroll
    for (int i = 0; i < MAXT / RG; ++i) {
      const int t = g + RG * i;
      if (t < t_len) acc[i] += sc[t * s_len + j] * vv;
    }
  }
#pragma unroll
  for (int i = 0; i < MAXT / RG; ++i) {
    const int t = g + RG * i;
    if (t < t_len) out[(size_t)(b * t_len + t) * d + h * DH + c] = f2bf(acc[i]);
  }
}

// Cross-attention partials: one CTA (512 threads; one per key in the score
// phase) per (chunk, head, example).  The chunk's K tile (64 x 128, head-major rows of
// S) and V tile (128 x 64, head-flat rows) are staged in shared memory with
// 8- and 16-byte loads.  Writes the chunk-normalized output o_c, the chunk
// max m_c and the chunk sum l_c for every query row.  s_enc % 4 == 0.
// KT int8: K/V converted to bf16 on staging, scores times ks, probabilities
// times vs (the layer's (B, H, S_enc) f32 scales).
template <typename KT>
__global__ void __launch_bounds__(AT)
cross_partial_kernel(const bf16* __restrict__ q, const KT* __restrict__ ck,
                     const KT* __restrict__ cv, const float* __restrict__ ks,
                     const float* __restrict__ vs_g, float* __restrict__ part_o,
                     float* __restrict__ part_ml, int t_len, int n_heads, int d,
                     int s_enc, int cross_len, int nch) {
  griddep_launch();
  griddep_wait();
  constexpr bool Q = sizeof(KT) == 1;
  __shared__ float qs[MAXT][DH];
  __shared__ __align__(16) bf16 kt[DH][CS + 8];
  __shared__ __align__(16) bf16 vt[CS][DH + 8];
  __shared__ float ps[MAXT][CS];
  const int ch = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = ch * CS;
  const int nkeys = min(CS, cross_len - s0);
  for (int i = tid; i < t_len * DH; i += AT) {
    const int t = i / DH, c = i % DH;
    qs[t][c] = bf2f(q[(size_t)(b * t_len + t) * d + h * DH + c]);
  }
  const KT* kh = ck + ((size_t)b * n_heads + h) * DH * s_enc + s0;
  for (int i = tid; i < DH * (CS / 4); i += AT) {
    const int c = i / (CS / 4), j4 = (i % (CS / 4)) * 4;
    uint2 val = make_uint2(0, 0);
    if (j4 + 4 <= nkeys) {
      val = load4(kh + (size_t)c * s_enc + j4);
    } else {
      bf16* e = reinterpret_cast<bf16*>(&val);
      for (int x = 0; x < 4; ++x)
        if (j4 + x < nkeys) e[x] = to_bf(kh[(size_t)c * s_enc + j4 + x]);
    }
    *reinterpret_cast<uint2*>(&kt[c][j4]) = val;
  }
  const KT* vh = cv + ((size_t)b * s_enc + s0) * d + h * DH;
  for (int i = tid; i < CS * (DH / 8); i += AT) {
    const int j = i / (DH / 8), c8 = (i % (DH / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (j < nkeys) val = load8(vh + (size_t)j * d + c8);
    *reinterpret_cast<uint4*>(&vt[j][c8]) = val;
  }
  // This (example, head)'s scales of the chunk's keys (int8 only).
  const float* ksr = Q ? ks + ((size_t)b * n_heads + h) * s_enc + s0 : nullptr;
  const float* vsr = Q ? vs_g + ((size_t)b * n_heads + h) * s_enc + s0 : nullptr;
  __syncthreads();

  if (tid < CS) {
    const bool valid = tid < nkeys;
    float acc[MAXT];
#pragma unroll
    for (int t = 0; t < MAXT; ++t) acc[t] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < DH; ++c) {
      const float kd = bf2f(kt[c][tid]);
#pragma unroll
      for (int t = 0; t < MAXT; ++t)
        if (t < t_len) acc[t] += qs[t][c] * kd;
    }
    const float ksc = (Q && valid) ? ksr[tid] : 1.0f;
#pragma unroll
    for (int t = 0; t < MAXT; ++t)
      if (t < t_len) ps[t][tid] = valid ? acc[t] * ksc : -INFINITY;
  }
  __syncthreads();

  const size_t row0 = ((size_t)b * n_heads + h) * t_len;
  for (int t = warp; t < t_len; t += AT / 32) {
    float m = -INFINITY;
    for (int j = lane; j < CS; j += 32) m = fmaxf(m, ps[t][j]);
    m = warp_max(m);
    float l = 0.0f;
    for (int j = lane; j < nkeys; j += 32) l += expf(ps[t][j] - m);
    l = warp_sum(l);
    const float inv = 1.0f / l;
    for (int j = lane; j < CS; j += 32)
      ps[t][j] = j < nkeys ? bfr(expf(ps[t][j] - m) * inv * (Q ? vsr[j] : 1.0f)) : 0.0f;
    if (lane == 0) {
      part_ml[((row0 + t) * nch + ch) * 2] = m;
      part_ml[((row0 + t) * nch + ch) * 2 + 1] = l;
    }
  }
  __syncthreads();

  const int c = tid & 63, g = tid >> 6;
  float o[MAXT / RG];
#pragma unroll
  for (int i = 0; i < MAXT / RG; ++i) o[i] = 0.0f;
  for (int j = 0; j < nkeys; ++j) {
    const float vv = bf2f(vt[j][c]);
#pragma unroll
    for (int i = 0; i < MAXT / RG; ++i) {
      const int t = g + RG * i;
      if (t < t_len) o[i] += ps[t][j] * vv;
    }
  }
#pragma unroll
  for (int i = 0; i < MAXT / RG; ++i) {
    const int t = g + RG * i;
    if (t < t_len) part_o[((row0 + t) * nch + ch) * DH + c] = o[i];
  }
}

// Combine the chunk partials: one CTA per (head, example).
__global__ void __launch_bounds__(256)
cross_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                     bf16* __restrict__ out, int t_len, int n_heads, int d, int nch) {
  griddep_launch();
  griddep_wait();
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t row0 = ((size_t)b * n_heads + h) * t_len;
  for (int i = threadIdx.x; i < t_len * DH; i += 256) {
    const int t = i / DH, c = i % DH;
    const float* ml = part_ml + (row0 + t) * nch * 2;
    float m = -INFINITY;
    for (int x = 0; x < nch; ++x) m = fmaxf(m, ml[2 * x]);
    float l = 0.0f, o = 0.0f;
    for (int x = 0; x < nch; ++x) {
      const float w = ml[2 * x + 1] * expf(ml[2 * x] - m);
      l += w;
      o += w * part_o[((row0 + t) * nch + x) * DH + c];
    }
    out[(size_t)(b * t_len + t) * d + h * DH + c] = f2bf(o / l);
  }
}

// ---------------------------------------------------------------------------
// The projections: a weight-streaming GEMM on wgmma, Y^T = W^T X^T
// ---------------------------------------------------------------------------

constexpr int G_TILE = 64;             // W columns per CTA (wgmma's M side), K chunk
constexpr int G_RING = 96 * 1024;      // ring bytes a CTA may hold at M <= 32
constexpr int G_RING_STAGES = 4;       // ring stages past 32 rows
constexpr int G_THREADS = 160;         // 4 consumer warps + 1 producer warp
constexpr int G_WTILE = G_TILE * G_TILE * 2;   // bf16 W tile (64 K x 64 N), bytes
constexpr int G_WRAW = G_TILE * G_TILE;        // int8 W tile, bytes
constexpr int G_XT = 16 * G_TILE * 2;          // one 16-row X tile (64 K), bytes
constexpr int G_WBUF = 3;              // converted bf16 W tiles (int8)
constexpr int G_CTAS = 132;            // CTAs a projection aims for (the H100's SMs)
constexpr int G_MAX_SLICES = 8;        // K slices: the CTAs of one portable cluster
constexpr int G_RP = G_TILE + 4;       // f32 pitch of a CTA's partial in shared memory

// The K slices of a projection: their number from (K, N, jobs) alone, never
// from M (ops/megastep.py::gemm_slices is the same rule).
__host__ __device__ inline int gemm_slices(int k, int n, int jobs) {
  const int chunks = k / G_TILE, tiles = jobs * (n / G_TILE);
  int want = (G_CTAS + tiles - 1) / tiles;
  if (want > G_MAX_SLICES) want = G_MAX_SLICES;
  if (want > chunks) want = chunks;
  return want < 1 ? 1 : want;
}
// Slice i covers 64-wide chunks [begin, end): fixed contiguous ranges.
__host__ __device__ inline int gemm_slice_begin(int chunks, int slices, int i) {
  const int base = chunks / slices, extra = chunks % slices;
  return i * base + (i < extra ? i : extra);
}

// The deepest ring a CTA may hold at mt row tiles: G_RING bytes at up to
// two row tiles (a B = 1 chunk), G_RING_STAGES stages past them, where a
// deeper ring measured slower (fewer CTAs of the next kernels fit beside
// the running one, so less of their weights is in flight early).
inline int gemm_max_stages(int mt, bool w8) {
  return mt <= 2 ? G_RING / (mt * G_XT + (w8 ? G_WRAW : G_WTILE)) : G_RING_STAGES;
}

// Ring stages of a projection: room for its longest K slice (so a CTA can
// hold all its weights before its wait), within gemm_max_stages, at least 2.
inline int gemm_stages(int k, int n, int jobs, int mt, bool w8) {
  const int slices = gemm_slices(k, n, jobs), chunks = k / G_TILE;
  const int longest = (chunks + slices - 1) / slices;
  const int fit = gemm_max_stages(mt, w8);
  const int s = longest < fit ? longest : fit;
  return s < 2 ? 2 : s;
}

inline int gemm_smem(int mt, bool w8, int stages) {
  return 1024 + stages * (mt * G_XT + (w8 ? G_WRAW : G_WTILE)) + (w8 ? G_WBUF * G_WTILE : 0) +
         16 * stages + 16 * mt * G_TILE * 2;
}

// One output of a GEMM launch (up to three share X: q/k/v).
struct GemmJob {
  const bf16* bias;      // (N,) or null
  const float* wscale;   // (N,) f32 per-column scales (int8 W), or null
  const bf16* res;       // residual rows (ld = ldres) or null; may be out
  bf16* out;             // output rows (ld = ldo)
  int epi;
  float scale;
};
struct GemmJobs {
  GemmJob j[3];
};

// grid (slices, N / 64, jobs), clusters of (slices, 1, 1): the cluster's
// CTA of rank r computes W columns [64 y, + 64) of job z over K slice r;
// then rank r adds the slices' partials, in rank order, for its share of
// the rows and runs the epilogue.  The W tile is wgmma's A side (64 columns
// x 16 K, MN-major, 128-byte swizzle as TMA writes it: the bf16 tile
// directly, an int8 tile after an exact conversion in shared memory); the
// X tile (16 MT rows, K-major) its N side, one m64nNk16 product a 16-deep
// step.  mx: X (M rows, K) bf16, box (64,
// 16 MT), rows past M zero-filled; mw0..2: the jobs' W stacks (L, K, N),
// box (64, 64, 1), at layer ``layer``.
//
// Programmatic dependent launch: before griddep_wait a kernel reads only
// weights and writes only its own shared memory.  The producer issues its
// first ring of W loads before the wait, so the weights stream while the
// previous kernel finishes; X, biases, residuals and outputs come after.
template <int MT, bool W8>
__global__ void __launch_bounds__(G_THREADS)
wgemm_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw0,
             const __grid_constant__ CUtensorMap mw1, const __grid_constant__ CUtensorMap mw2,
             const GemmJobs jobs, int layer, int m_rows, int chunks, int stages, int ldo,
             int ldres) {
  griddep_launch();
  cg::cluster_group cluster = cg::this_cluster();
  const int slices = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int z = blockIdx.z, n0 = blockIdx.y * G_TILE;
  const CUtensorMap* mw = z == 0 ? &mw0 : (z == 1 ? &mw1 : &mw2);
  const GemmJob jb = z == 0 ? jobs.j[0] : (z == 1 ? jobs.j[1] : jobs.j[2]);
  const int c_first = gemm_slice_begin(chunks, slices, rank);
  const int nch = gemm_slice_begin(chunks, slices, rank + 1) - c_first;
  constexpr int WB = W8 ? G_WRAW : G_WTILE;   // W bytes a stage

  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* xs = smem;                                   // stages x MT X tiles
  char* ws = xs + stages * MT * G_XT;                // stages W tiles (raw at int8)
  char* wb = ws + stages * WB;                       // G_WBUF converted tiles (int8)
  uint64_t* full = reinterpret_cast<uint64_t*>(wb + (W8 ? G_WBUF * G_WTILE : 0));
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // The epilogue's per-column operands (weights: loaded before the wait)
  // and this rank's residual rows (after it).
  __shared__ float col_bias[G_TILE], col_scale[G_TILE];
  bf16* res_rows = reinterpret_cast<bf16*>(empty + stages);   // <= 16 MT rows x 64
  const int per = (m_rows + slices - 1) / slices, r0 = rank * per;
  const int r1 = r0 + per < m_rows ? r0 + per : m_rows;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int pre = nch < stages ? nch : stages;
  if (warp == 4 && lane == 0) {   // the weights of the first stages: no wait
    for (int it = 0; it < pre; ++it) {
      mbar_arrive_tx(&full[it], WB + MT * G_XT);
      tma_load_3d(ws + it * WB, mw, &full[it], n0, (c_first + it) * G_TILE, layer);
    }
  }
  if (threadIdx.x < G_TILE) {
    col_bias[threadIdx.x] = jb.bias ? bf2f(jb.bias[n0 + threadIdx.x]) : 0.0f;
    col_scale[threadIdx.x] = W8 ? jb.wscale[n0 + threadIdx.x] : 1.0f;
  }
  griddep_wait();

  float acc[MT * 8];
  if (warp == 4) {   // producer; lanes 1-31 stage the residual rows meanwhile
    if (lane != 0 && jb.epi == EPI_BIAS_RESID) {
      for (int i = lane - 1; i < (r1 - r0) * (G_TILE / 8); i += 31) {
        const int m = r0 + i / (G_TILE / 8), c8 = (i % (G_TILE / 8)) * 8;
        *reinterpret_cast<uint4*>(&res_rows[(m - r0) * G_TILE + c8]) =
            *reinterpret_cast<const uint4*>(jb.res + (size_t)m * ldres + n0 + c8);
      }
    }
    if (lane == 0) {
      for (int it = 0; it < pre; ++it)
        tma_load_2d(xs + it * MT * G_XT, &mx, &full[it], (c_first + it) * G_TILE, 0);
      for (int it = pre; it < nch; ++it) {
        const int st = it % stages, c = c_first + it;
        mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
        mbar_arrive_tx(&full[st], WB + MT * G_XT);
        tma_load_3d(ws + st * WB, mw, &full[st], n0, c * G_TILE, layer);
        tma_load_2d(xs + st * MT * G_XT, &mx, &full[st], c * G_TILE, 0);
      }
    }
  } else {
    int pend = -1;
    for (int it = 0; it < nch; ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      char* wt = ws + st * WB;
      if constexpr (W8) {
        // int8 (k, n) rows of 64 bytes -> bf16 rows of 128 bytes, chunk j of
        // row k stored at chunk j ^ (k % 8) (the 128-byte swizzle).
        char* cv = wb + (it % G_WBUF) * G_WTILE;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int idx = threadIdx.x + 128 * h, kr = idx >> 2, q = idx & 3;
          const uint4 raw = *reinterpret_cast<const uint4*>(wt + kr * 64 + q * 16);
          char* rowp = cv + kr * 128;
          *reinterpret_cast<uint4*>(rowp + (((2 * q) ^ (kr & 7)) * 16)) =
              i8x8_to_bf16(make_uint2(raw.x, raw.y));
          *reinterpret_cast<uint4*>(rowp + (((2 * q + 1) ^ (kr & 7)) * 16)) =
              i8x8_to_bf16(make_uint2(raw.z, raw.w));
        }
        fence_proxy_async();
        named_sync(1, 128);
        wt = cv;
      }
      const uint64_t adesc = sw128_desc(smem_addr(wt));
      const uint64_t bdesc = sw128_desc(smem_addr(xs + st * MT * G_XT));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G_TILE / 16; ++kk)
        WgmmaN<MT, 1, 0>::run(acc, adesc + 128 * kk, bdesc + 2 * kk, it > 0 || kk > 0);
      wgmma_commit();
      // The previous chunk's products are done: its stage goes back to the
      // producer (at int8 the raw tile was read by the conversion already).
      wgmma_wait<1>();
      if (lane == 0 && pend >= 0) mbar_arrive(&empty[pend]);
      pend = st;
    }
    wgmma_wait<0>();
    reg_fence(acc);
  }
  __syncthreads();   // every product has read its tiles: the ring is free

  // This slice's partial (X rows x 64 W columns, f32) over the ring.
  float* red = reinterpret_cast<float*>(smem);
  if (warp < 4) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = 16 * t + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        red[row * G_RP + 16 * warp + (lane >> 2) + ((i & 2) ? 8 : 0)] = acc[8 * t + i];
      }
  }
  cluster.sync();    // the partials, and the staged residual rows, are visible
  // Rank r: rows [r * per, + per); the slices added in rank order, every
  // rank's value read before the first add.
  const float* part[G_MAX_SLICES];
#pragma unroll
  for (int q = 0; q < G_MAX_SLICES; ++q)
    part[q] = cluster.map_shared_rank(red, q < slices ? q : 0);
  for (int e = threadIdx.x; e < (r1 - r0) * G_TILE; e += G_THREADS) {
    const int m = r0 + e / G_TILE, col = e % G_TILE;
    float v[G_MAX_SLICES];
#pragma unroll
    for (int q = 0; q < G_MAX_SLICES; ++q) v[q] = q < slices ? part[q][m * G_RP + col] : 0.0f;
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < G_MAX_SLICES; ++q)
      if (q < slices) sum += v[q];
    if constexpr (W8) sum *= col_scale[col];
    if (jb.bias) sum += col_bias[col];
    float r;
    switch (jb.epi) {
      case EPI_BIAS_SCALE: r = bfr(sum) * jb.scale; break;
      case EPI_BIAS_GELU: r = gelu_erf(sum); break;
      case EPI_BIAS_RESID: r = bf2f(res_rows[(m - r0) * G_TILE + col]) + bfr(sum); break;
      default: r = sum;
    }
    jb.out[(size_t)m * ldo + n0 + col] = f2bf(r);
  }
  cluster.sync();    // every rank's partial stays until the others have read it
}

// Launches one kernel of the step after the previous one in the stream with
// programmatic stream serialization (its CTAs may start early and run up to
// their griddep_wait), in clusters of ``cluster`` CTAs along x when > 0.
template <typename... KArgs, typename... Args>
int launch_pdl(void (*kern)(KArgs...), dim3 grid, dim3 block, size_t smem, int cluster,
               cudaStream_t st, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  int n = 1;
  if (cluster > 0) {
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = cluster;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = 1;
    n = 2;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return (int)cudaLaunchKernelEx(&cfg, kern, std::forward<Args>(args)...);
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
  int B, T, D, H, F, S, SE, cross_len, nch, M, MT;
  bool quant;
  size_t self_smem;
  bf16 *xa, *qb, *kb, *vb, *attn, *hb;
  float *part_o, *part_ml;
  void *self_k, *self_v;
  const void *cross_k, *cross_v;
  const float *cross_k_s, *cross_v_s;
  bf16* self_s;
  const int* offsets;
  const uint8_t* mask;
  CUtensorMap x_xa, x_attn, x_h;   // the GEMMs' X operands (M rows)
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

// The X operand of a GEMM: M rows of k bf16 columns, 16 MT-row boxes.
int encode_x_map(CUtensorMap* map, const bf16* x, int m, int k, int mt) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(bf16)};
  const cuuint32_t box[2] = {G_TILE, (cuuint32_t)(16 * mt)};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

inline GemmJob gjob(const bf16* bias, bf16* out, int epi, const bf16* res = nullptr,
                    float scale = 1.0f, const float* wscale = nullptr) {
  GemmJob j;
  j.bias = bias;
  j.wscale = wscale;
  j.res = res;
  j.out = out;
  j.epi = epi;
  j.scale = scale;
  return j;
}

// One projection of the step: Y (M, N) = epilogue(X (M, K) @ W[layer]) for
// ``njobs`` jobs sharing X.
int gemm(const StepCtx& c, const CUtensorMap& mx, const CUtensorMap* w0, const CUtensorMap* w1,
         const CUtensorMap* w2, int njobs, const GemmJobs& jobs, int layer, int k, int n,
         int ldo) {
  const int slices = gemm_slices(k, n, njobs);
  const dim3 grid(slices, n / G_TILE, njobs);
  const int stages = gemm_stages(k, n, njobs, c.MT, c.quant);
  const size_t smem = gemm_smem(c.MT, c.quant, stages);
  const int chunks = k / G_TILE;
#define WM_GEMM(MT)                                                                      \
  case MT:                                                                               \
    return c.quant ? launch_pdl(wgemm_kernel<MT, true>, grid, dim3(G_THREADS), smem,    \
                                slices, c.st, mx, *w0, *w1, *w2, jobs, layer, c.M,       \
                                chunks, stages, ldo, ldo)                                \
                   : launch_pdl(wgemm_kernel<MT, false>, grid, dim3(G_THREADS), smem,   \
                                slices, c.st, mx, *w0, *w1, *w2, jobs, layer, c.M,       \
                                chunks, stages, ldo, ldo);
  switch (c.MT) {
    WM_GEMM(1) WM_GEMM(2) WM_GEMM(3) WM_GEMM(4)
    WM_GEMM(5) WM_GEMM(6) WM_GEMM(7) WM_GEMM(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WM_GEMM
}

// Shared memory of the GEMM instantiation a step uses (above 48 KB needs
// the attribute; per call: it belongs to the current device's context):
// room for the deepest ring a projection takes.
void gemm_set_smem(int mt, bool w8) {
  const int smem = gemm_smem(mt, w8, gemm_max_stages(mt, w8));
#define WM_GSMEM(MT)                                                                   \
  case MT:                                                                             \
    if (w8)                                                                            \
      cudaFuncSetAttribute(wgemm_kernel<MT, true>,                                     \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
    else                                                                               \
      cudaFuncSetAttribute(wgemm_kernel<MT, false>,                                    \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
    break;
  switch (mt) {
    WM_GSMEM(1) WM_GSMEM(2) WM_GSMEM(3) WM_GSMEM(4)
    WM_GSMEM(5) WM_GSMEM(6) WM_GSMEM(7) WM_GSMEM(8)
    default: break;
  }
#undef WM_GSMEM
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

// One decoder layer over the chunk's rows in x (residual stream, updated in
// place), reading and writing cache slot `slot` of every slab.
int layer_step(const LayerW& w, bf16* x, size_t slot, const StepCtx& c) {
  const int B = c.B, T = c.T, D = c.D, H = c.H, F = c.F, S = c.S, SE = c.SE, M = c.M;
  const int l = w.layer;
  const LayerMaps& mp = *w.maps;
  const float scale = 0.125f;   // DH ** -0.5
  const size_t slab = slot * B * S * D;
  cudaStream_t st = c.st;
  // --- self-attention
  WM_TRY(ln_rows(x, c.xa, nullptr, w.self_ln_s, w.self_ln_b, M, D, st));
  GemmJobs qkv;
  qkv.j[0] = gjob(w.q_b, c.qb, EPI_BIAS_SCALE, nullptr, scale, w.q_s);
  qkv.j[1] = gjob(nullptr, c.kb, EPI_BIAS, nullptr, 1.0f, w.k_s);
  qkv.j[2] = gjob(w.v_b, c.vb, EPI_BIAS, nullptr, 1.0f, w.v_s);
  WM_TRY(gemm(c, c.x_xa, &mp.q, &mp.k, &mp.v, 3, qkv, l, D, D, D));
  if (c.quant)
    WM_TRY(launch_pdl(self_attn_kernel<true>, dim3(H, B), dim3(AT), c.self_smem, 0, st,
                      c.qb, c.kb, c.vb, c.attn, static_cast<int8_t*>(c.self_k) + slab,
                      static_cast<int8_t*>(c.self_v) + slab, c.self_s + slot * B * S * 2 * H,
                      c.offsets, c.mask, T, S, D, H));
  else
    WM_TRY(launch_pdl(self_attn_kernel<false>, dim3(H, B), dim3(AT), c.self_smem, 0, st,
                      c.qb, c.kb, c.vb, c.attn, static_cast<bf16*>(c.self_k) + slab,
                      static_cast<bf16*>(c.self_v) + slab, (bf16*)nullptr, c.offsets, c.mask,
                      T, S, D, H));
  GemmJobs o;
  o.j[0] = gjob(w.o_b, x, EPI_BIAS_RESID, x, 1.0f, w.o_s);
  WM_TRY(gemm(c, c.x_attn, &mp.o, &mp.o, &mp.o, 1, o, l, D, D, D));
  // --- cross-attention
  WM_TRY(ln_rows(x, c.xa, nullptr, w.cross_ln_s, w.cross_ln_b, M, D, st));
  GemmJobs cq;
  cq.j[0] = gjob(w.cq_b, c.qb, EPI_BIAS_SCALE, nullptr, scale, w.cq_s);
  WM_TRY(gemm(c, c.x_xa, &mp.cq, &mp.cq, &mp.cq, 1, cq, l, D, D, D));
  const size_t ck = slot * B * H * DH * SE, cv = slot * B * SE * D;
  if (c.quant) {
    const size_t cs = slot * B * H * SE;
    WM_TRY(launch_pdl(cross_partial_kernel<int8_t>, dim3(c.nch, H, B), dim3(AT), 0, 0, st,
                      c.qb, static_cast<const int8_t*>(c.cross_k) + ck,
                      static_cast<const int8_t*>(c.cross_v) + cv, c.cross_k_s + cs,
                      c.cross_v_s + cs, c.part_o, c.part_ml, T, H, D, SE, c.cross_len,
                      c.nch));
  } else {
    WM_TRY(launch_pdl(cross_partial_kernel<bf16>, dim3(c.nch, H, B), dim3(AT), 0, 0, st,
                      c.qb, static_cast<const bf16*>(c.cross_k) + ck,
                      static_cast<const bf16*>(c.cross_v) + cv, (const float*)nullptr,
                      (const float*)nullptr, c.part_o, c.part_ml, T, H, D, SE, c.cross_len,
                      c.nch));
  }
  WM_TRY(launch_pdl(cross_combine_kernel, dim3(H, B), dim3(256), 0, 0, st, c.part_o,
                    c.part_ml, c.attn, T, H, D, c.nch));
  GemmJobs co;
  co.j[0] = gjob(w.co_b, x, EPI_BIAS_RESID, x, 1.0f, w.co_s);
  WM_TRY(gemm(c, c.x_attn, &mp.co, &mp.co, &mp.co, 1, co, l, D, D, D));
  // --- FFN
  WM_TRY(ln_rows(x, c.xa, nullptr, w.ffn_ln_s, w.ffn_ln_b, M, D, st));
  GemmJobs f1;
  f1.j[0] = gjob(w.fc1_b, c.hb, EPI_BIAS_GELU, nullptr, 1.0f, w.fc1_s);
  WM_TRY(gemm(c, c.x_xa, &mp.fc1, &mp.fc1, &mp.fc1, 1, f1, l, D, F, F));
  GemmJobs f2;
  f2.j[0] = gjob(w.fc2_b, x, EPI_BIAS_RESID, x, 1.0f, w.fc2_s);
  WM_TRY(gemm(c, c.x_h, &mp.fc2, &mp.fc2, &mp.fc2, 1, f2, l, F, D, D));
  return 0;
}

}  // namespace
}  // namespace wm

// Pointer table of wm_megastep_step (ops/megastep.py builds the same list).
enum MegastepPtr {
  P_X = 0,        // (M16, D) bf16 hidden: embedded chunk in, pre_norm out
  P_XA,           // (M16, D) bf16 scratch: layernorm output
  P_Q, P_K, P_V,  // (M16, D) bf16 scratch: projections
  P_ATTN,         // (M16, D) bf16 scratch: attention output
  P_H,            // (M16, F) bf16 scratch: fc1 output
  P_PART,         // f32 scratch: cross partials (B*H*T*nch*(64 + 2))
  P_SELF_K, P_SELF_V,    // (L', B, S, D) bf16 (int8) slabs, updated in place
  P_CROSS_K,             // (L', B, H, 64, Se) bf16 (int8)
  P_CROSS_V,             // (L', B, Se, D) bf16 (int8)
  P_OFFSETS,             // (B,) int32
  P_MASK,                // (T, T) uint8 chunk mask
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

// ints: L, B, T, D, H, F, S (self slab rows), Se (cross rows), cross_len.
// L' = L slab slots, or L + 1 in block mode (slot L is the block's).
// M16 = ceil(B * T / 16) * 16 rows are allocated in every row buffer.
extern "C" int wm_megastep_step(void** p, const int* ints, void* stream) {
  using namespace wm;
  const int L = ints[0], B = ints[1], T = ints[2], D = ints[3], H = ints[4];
  const int F = ints[5], S = ints[6], SE = ints[7], cross_len = ints[8];
  const int M = B * T;
  cudaStream_t st = (cudaStream_t)stream;
  if (T > MAXT || B > 8 || M > SK_MAX_ROWS || D != H * DH || D % 256 || F % 256 ||
      SE % 4)
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
  c.nch = (cross_len + CS - 1) / CS;
  c.quant = quant;
  c.self_smem = (size_t)T * (DH + S) * sizeof(float) + 16 + (size_t)S * DH * sizeof(bf16);
  if (c.self_smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (c.self_smem > 48 * 1024) {
    if (quant)
      cudaFuncSetAttribute(self_attn_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.self_smem);
    else
      cudaFuncSetAttribute(self_attn_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.self_smem);
  }
  gemm_set_smem(c.MT, quant);
  auto P = [&](int i) { return static_cast<bf16*>(p[i]); };
  bf16* x = P(P_X);
  c.xa = P(P_XA); c.qb = P(P_Q); c.kb = P(P_K); c.vb = P(P_V);
  c.attn = P(P_ATTN); c.hb = P(P_H);
  c.part_o = static_cast<float*>(p[P_PART]);
  c.part_ml = c.part_o + (size_t)B * H * T * c.nch * DH;
  c.self_k = p[P_SELF_K]; c.self_v = p[P_SELF_V];
  c.cross_k = p[P_CROSS_K]; c.cross_v = p[P_CROSS_V];
  c.cross_k_s = static_cast<const float*>(p[P_CROSS_K_S]);
  c.cross_v_s = static_cast<const float*>(p[P_CROSS_V_S]);
  c.self_s = P(P_SELF_S);
  c.offsets = static_cast<const int*>(p[P_OFFSETS]);
  c.mask = static_cast<const uint8_t*>(p[P_MASK]);
  c.st = st;
  // Tensor maps: the GEMMs' X operands, then the streamed weights of the
  // stack and of the block, each over its whole stack (the layer is a
  // coordinate).
  LayerMaps stack_maps, block_maps;
  WM_TRY(encode_x_map(&c.x_xa, c.xa, M, D, c.MT));
  WM_TRY(encode_x_map(&c.x_attn, c.attn, M, D, c.MT));
  WM_TRY(encode_x_map(&c.x_h, c.hb, M, F, c.MT));
  WM_TRY(encode_layer_maps(&stack_maps, p, P_SELF_LN_S, L, D, F, quant));
  if (block) WM_TRY(encode_layer_maps(&block_maps, p, P_B_W0, 1, D, F, quant));

  for (int l = 0; l < L; ++l)
    WM_TRY(layer_step(layer_weights(p, P_SELF_LN_S, P_Q_S, l, D, F, quant, &stack_maps), x,
                      l, c));
  // ln_post; in block mode also into the block's residual stream, which
  // starts from ln_post's output while x keeps the main stack's pre_norm.
  bf16* bx = block ? P(P_BLOCK_HIDDEN) : nullptr;
  WM_TRY(ln_rows(x, P(P_HIDDEN), bx, P(P_LN_POST_S), P(P_LN_POST_B), M, D, st));
  if (block)
    WM_TRY(layer_step(layer_weights(p, P_B_W0, P_B_S0, 0, D, F, quant, &block_maps), bx, L,
                      c));
  return (int)cudaGetLastError();
}
