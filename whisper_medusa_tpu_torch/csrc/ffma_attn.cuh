// The f32 attention body of K10's f32 modes (decode_ops.cu: wm_cross_decode_f32,
// wm_self_decode_f32, wm_cross_decode_w8a32) and of K2's W8A32 mode
// (megastep.cu: its self- and cross-attention), FFMA on the CUDA cores.
//
// One CTA (8 warps) per (key slice, head, example), the slices those of
// cd_split (from S alone: large-v2's 1500 cross keys 8 x 192, a 460-row
// self slab 3 x 160):
//   1. q (T <= 16 rows) staged in shared memory; thread j takes key j of the
//      slice and computes its 16 scores, a dot of 64 in order (cross K
//      head-major: a d-row of 192 consecutive keys is one coalesced read;
//      self K a 256-byte row read as float4), masked keys -inf;
//   2. warp w takes rows w and w + 8: the slice's max, p = exp(s - max) in
//      place, the sum of p (lane-strided, then a butterfly);
//   3. O = P V: thread (d, g) sums keys g, g + 4, ... of column d (V rows
//      read 256 bytes at a time), the four groups added in order;
// and writes (O, max, sum) of its slice to an f32 scratch (B, H, C, 16,
// 66); a combine kernel per (head, example) rescales the C slices to the
// global max and adds them in slice order, then divides by the sum.  Each
// (example, head)'s arithmetic and its order of sums depend on S only, so
// an example's bits do not depend on the batch.
//
// Q8 (W8A32: the int8 copy of an f32 model) reads int8 K/V, each value
// converted exactly to f32.  Cross mode: K (B, H, 64, S) and V (B, S, H *
// 64) int8 with f32 (B, H, S) scales ks / vs, each score times its key's
// scale before the mask and the max, each probability times its value's
// scale before the PV product, the sum of p unscaled
// (decode_ops.py::cross_attention_decode_plain).  Mask mode (K2's self-
// attention): history keys j < off[b] from the int8 slab (B, S, H * 64)
// with the bf16 scale slab ss (B, S, 2H), score times f32(k scale) and p
// times f32(v scale); the chunk's own keys off[b] + t from the fresh f32
// rows kn / vn ((B * T, H * 64), the projections' output), as the JAX
// kernel attends them (megastep.py:832-875); the CTA of slice 0 also
// commits the chunk's rows into the slabs: each 64-lane (position, head)
// row quantized with sc = max(amax, 1e-30) / 127 and round-half-even,
// clipped to +-127, bf16(sc) into ss (models/whisper.py quantize_self_rows;
// positions at or past S are not written).  The other CTAs read only rows
// j < off, which the commit does not touch.
#pragma once

#include "cluster_attn.cuh"
#include "common.cuh"

namespace wm {
namespace {

constexpr int DF_THREADS = 256;
constexpr int DF_ROW = CD_DH + 2;   // a slice's partial row: O (64), max, sum

struct DfArgs {
  const float* q;      // cross (B, H, T, 64); self (B, T, H, 64); pre-scaled
  const float* k;      // cross (B, H, 64, S); self (B, S, H * 64)  (f32 modes)
  const float* v;      // (B, S, H * 64)
  const int* off;      // self: (B,) int32 offsets
  const int* bits;     // self: (T, W) int32 chunk bits
  float* part;         // (B, H, C, 16, DF_ROW) f32 scratch
  float* out;          // q's layout
  // Q8: int8 K/V in the f32 layouts above; cross scales (B, H, S) f32; the
  // self slabs' bf16 scales (B, S, 2H) and the chunk's fresh f32 K/V rows
  // (B * T, H * 64).
  int8_t* k8;
  int8_t* v8;
  const float* ks;
  const float* vs;
  bf16* ss;
  const float* kn;
  const float* vn;
  long long q_b, q_h, q_t;
  int heads, t_len, t_chunk, s_len, kv_len, c, sc;
};

// Four K values of a self row at p as f32.
template <bool Q8>
__device__ __forceinline__ float4 df_k4(const DfArgs& a, size_t at) {
  if constexpr (Q8) {
    const char4 c = *reinterpret_cast<const char4*>(a.k8 + at);
    return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
  } else {
    return __ldg(reinterpret_cast<const float4*>(a.k + at));
  }
}

// The commit of the chunk's K/V rows of head h of example b (Q8 mask mode,
// the CTA of slice 0): warp w takes (row, K or V) tasks w, w + 8, ...;
// lanes hold elements l and l + 32 of the 64-lane row.
__device__ __forceinline__ void df_commit(const DfArgs& a, int b, int h, int off) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d_model = a.heads * CD_DH;
  for (int task = warp; task < 2 * a.t_len; task += DF_THREADS / 32) {
    const int t = task >> 1, is_v = task & 1;
    const int pos = off + t;
    if (pos >= a.s_len) continue;
    const float* src = (is_v ? a.vn : a.kn) + ((size_t)b * a.t_len + t) * d_model + h * CD_DH;
    const float x0 = src[lane], x1 = src[lane + 32];
    const float amax = warp_max(fmaxf(fabsf(x0), fabsf(x1)));
    const float sc = fmaxf(amax, 1e-30f) / 127.0f;
    int8_t* dst = (is_v ? a.v8 : a.k8) + ((size_t)b * a.s_len + pos) * d_model + h * CD_DH;
    dst[lane] = (int8_t)fminf(fmaxf(rintf(x0 / sc), -127.0f), 127.0f);
    dst[lane + 32] = (int8_t)fminf(fmaxf(rintf(x1 / sc), -127.0f), 127.0f);
    if (lane == 0)
      a.ss[((size_t)b * a.s_len + pos) * 2 * a.heads + is_v * a.heads + h] =
          __float2bfloat16_rn(sc);
  }
}

template <bool SELF, bool Q8 = false>
__global__ void __launch_bounds__(DF_THREADS) decode_attn_f32_kernel(const DfArgs a) {
  __shared__ __align__(16) float qs[CD_MAXT * CD_DH];
  __shared__ float ss[CD_MAXT * CD_MAXSLICE];              // scores, then p
  __shared__ float os[4 * CD_MAXT * CD_DH];                // the key groups' PV
  __shared__ float stat[2 * CD_MAXT];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int d_model = a.heads * CD_DH;
  const int j0 = c * a.sc, j1 = min(a.s_len, j0 + a.sc);
  const int off = SELF ? a.off[b] : 0;
  const int vis_end = SELF ? min(j1, off + a.t_chunk) : min(j1, a.kv_len);
  const int n = max(vis_end - j0, 0);
  const int words = (a.t_chunk + 31) / 32;
  const float* qb = a.q + b * a.q_b + h * a.q_h;
  if constexpr (SELF && Q8) {
    if (c == 0) df_commit(a, b, h, off);
  }
  for (int i = t; i < CD_MAXT * CD_DH; i += DF_THREADS) {
    const int r = i / CD_DH;
    qs[i] = r < a.t_len ? qb[r * a.q_t + i % CD_DH] : 0.0f;
  }
  __syncthreads();
  for (int jl = t; jl < n; jl += DF_THREADS) {
    const int j = j0 + jl;
    float s[CD_MAXT];
#pragma unroll
    for (int r = 0; r < CD_MAXT; ++r) s[r] = 0.0f;
    float kscale = 1.0f;
    if constexpr (SELF) {
      // Q8: history rows from the int8 slab, the chunk's rows fresh f32.
      const bool fresh = Q8 && j >= off;
      const size_t at = fresh ? ((size_t)b * a.t_chunk + (j - off)) * d_model + h * CD_DH
                              : ((size_t)b * a.s_len + j) * d_model + h * CD_DH;
      if constexpr (Q8) {
        if (!fresh) kscale = bf2f(a.ss[((size_t)b * a.s_len + j) * 2 * a.heads + h]);
      }
#pragma unroll 4
      for (int d4 = 0; d4 < CD_DH; d4 += 4) {
        const float4 kv = fresh ? __ldg(reinterpret_cast<const float4*>(a.kn + at + d4))
                                : df_k4<Q8>(a, at + d4);
#pragma unroll
        for (int r = 0; r < CD_MAXT; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + r * CD_DH + d4);
          s[r] = fmaf(qv.x, kv.x, s[r]);
          s[r] = fmaf(qv.y, kv.y, s[r]);
          s[r] = fmaf(qv.z, kv.z, s[r]);
          s[r] = fmaf(qv.w, kv.w, s[r]);
        }
      }
    } else {
      const size_t col = (size_t)(b * a.heads + h) * CD_DH * a.s_len + j;
      if constexpr (Q8) kscale = a.ks[(size_t)(b * a.heads + h) * a.s_len + j];
#pragma unroll 4
      for (int d = 0; d < CD_DH; ++d) {
        float kd;
        if constexpr (Q8)
          kd = (float)a.k8[col + (size_t)d * a.s_len];
        else
          kd = __ldg(a.k + col + (size_t)d * a.s_len);
#pragma unroll
        for (int r = 0; r < CD_MAXT; ++r) s[r] = fmaf(qs[r * CD_DH + d], kd, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < CD_MAXT; ++r) {
      bool vis = true;
      if constexpr (SELF) {
        const int rel = j - off;
        if (rel >= 0 && r < a.t_len)
          vis = (__ldg(a.bits + r * words + rel / 32) >> (rel % 32)) & 1;
      }
      if constexpr (Q8) s[r] *= kscale;
      ss[r * CD_MAXSLICE + jl] = vis ? s[r] : -INFINITY;
    }
  }
  __syncthreads();
  for (int r = warp; r < CD_MAXT; r += DF_THREADS / 32) {
    float mx = -INFINITY;
    for (int jl = lane; jl < n; jl += 32) mx = fmaxf(mx, ss[r * CD_MAXSLICE + jl]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int jl = lane; jl < n; jl += 32) {
      const float p = mx == -INFINITY ? 0.0f : expf(ss[r * CD_MAXSLICE + jl] - mx);
      sum += p;
      if constexpr (Q8) {
        // The value's scale rides the probability into the PV product.
        const int j = j0 + jl;
        float vsc = 1.0f;
        if (!SELF)
          vsc = a.vs[(size_t)(b * a.heads + h) * a.s_len + j];
        else if (j < off)
          vsc = bf2f(a.ss[((size_t)b * a.s_len + j) * 2 * a.heads + a.heads + h]);
        ss[r * CD_MAXSLICE + jl] = p * vsc;
      } else {
        ss[r * CD_MAXSLICE + jl] = p;
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      stat[r] = mx;
      stat[CD_MAXT + r] = sum;
    }
  }
  __syncthreads();
  {
    const int d = t & 63, g = t >> 6;
    float o[CD_MAXT];
#pragma unroll
    for (int r = 0; r < CD_MAXT; ++r) o[r] = 0.0f;
    const size_t vcol = ((size_t)b * a.s_len + j0) * d_model + h * CD_DH + d;
    for (int jl = g; jl < n; jl += 4) {
      float vv;
      if constexpr (Q8) {
        const int j = j0 + jl;
        if (SELF && j >= off)
          vv = a.vn[((size_t)b * a.t_chunk + (j - off)) * d_model + h * CD_DH + d];
        else
          vv = (float)a.v8[vcol + (size_t)jl * d_model];
      } else {
        vv = __ldg(a.v + vcol + (size_t)jl * d_model);
      }
#pragma unroll
      for (int r = 0; r < CD_MAXT; ++r) o[r] = fmaf(ss[r * CD_MAXSLICE + jl], vv, o[r]);
    }
#pragma unroll
    for (int r = 0; r < CD_MAXT; ++r) os[(g * CD_MAXT + r) * CD_DH + d] = o[r];
  }
  __syncthreads();
  float* part = a.part + (((size_t)b * a.heads + h) * a.c + c) * CD_MAXT * DF_ROW;
  for (int i = t; i < a.t_len * CD_DH; i += DF_THREADS) {
    const int r = i / CD_DH, d = i % CD_DH;
    float y = os[r * CD_DH + d];
#pragma unroll
    for (int g = 1; g < 4; ++g) y += os[(g * CD_MAXT + r) * CD_DH + d];
    part[r * DF_ROW + d] = y;
  }
  if (t < a.t_len) {
    part[t * DF_ROW + CD_DH] = stat[t];
    part[t * DF_ROW + CD_DH + 1] = stat[CD_MAXT + t];
  }
}

// One CTA per (head, example): the C slices rescaled to the global max and
// added in slice order, then divided by the sum.
__global__ void __launch_bounds__(DF_THREADS) decode_combine_f32_kernel(const DfArgs a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* part = a.part + ((size_t)b * a.heads + h) * a.c * CD_MAXT * DF_ROW;
  float* ob = a.out + b * a.q_b + h * a.q_h;
  for (int i = threadIdx.x; i < a.t_len * CD_DH; i += DF_THREADS) {
    const int r = i / CD_DH, d = i % CD_DH;
    float m = -INFINITY;
    for (int c = 0; c < a.c; ++c) m = fmaxf(m, part[(c * CD_MAXT + r) * DF_ROW + CD_DH]);
    float l = 0.0f, y = 0.0f;
    for (int c = 0; c < a.c; ++c) {
      const float* row = part + (c * CD_MAXT + r) * DF_ROW;
      const float mc = row[CD_DH];
      if (mc == -INFINITY) continue;      // a slice with no visible key
      const float w = expf(mc - m);
      l += row[CD_DH + 1] * w;
      y += row[d] * w;
    }
    ob[r * a.q_t + d] = l > 0.0f ? y / l : 0.0f;
  }
}

template <bool SELF, bool Q8 = false>
int k10_f32_launch(DfArgs a, int batch, cudaStream_t st) {
  if (!cd_split(a.s_len, &a.c, &a.sc)) return (int)cudaErrorInvalidValue;
  decode_attn_f32_kernel<SELF, Q8><<<dim3(a.c, a.heads, batch), DF_THREADS, 0, st>>>(a);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  decode_combine_f32_kernel<<<dim3(a.heads, batch), DF_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wm
