// The f32 building block of K4 / K5's f32 vocab stream (verify.cu,
// vocab_stream_f32_kernel): f32 products with f32 sums in FFMA on the CUDA
// cores.  Hopper's tensor cores take f32 operands only as TF32 (about three
// decimal digits), which is not the JAX package's f32, so it does not
// touch them.
//
// ffma_tile<MT, NT> is one CTA's (64 columns x 16 MT rows) product over a K
// range: 256 threads, thread t holding columns 4 (t % 16) .. + 3 and rows
// MT (t / 16) .. + MT - 1 in registers (4 MT f32 sums); K in chunks of
// FF_KC, each chunk of W (or E) and of the rows staged in shared memory
// (double-buffered: the next chunk's loads are issued into registers
// before this chunk's products), the rows and the NT operand transposed so
// that a step reads one float4 of columns and MT / 4 float4 of rows.  Each
// sum is one chain of fmaf over K in order, so a row's bits do not depend
// on the other rows, on M or on MT.  NT = false: W is (K, N) row-major (the
// weights' (in, out) layout), the CTA's 64 columns a slice of each row.
// NT = true: W is E (V, D) row-major, the CTA's columns 64 vocab entries
// (rows of E), those past `cols` read as zero.  ffma_tile<MT, NT, int8_t>
// reads an int8 W (or E: the W8A32 mode's embedding) and converts each
// value exactly to f32 as it is fetched, the rest of the tile unchanged.
// The f32 and W8A32 GEMMs (K11's f32 mode, the head rows, K4's stage A, the
// per-op step's f32 projections, K2's W8A32 mode) are ffma_gemm.cuh's
// weight stream.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace wm {
namespace {

constexpr int FF_THREADS = 256;
constexpr int FF_COLS = 64;       // output columns (or vocab entries) a CTA
constexpr int FF_KC = 16;         // K a staged chunk holds
constexpr int FF_MAX_MT = 8;      // 16-row groups a pass: up to 128 rows

// Floats of one staged chunk: the W / E chunk, then the rows' chunk.
template <int MT>
__host__ __device__ constexpr int ff_stage_floats() {
  return FF_KC * (FF_COLS + 16 * MT);
}

// The pass's 16-row groups: 1, 2, 4 or 8 (ops/decode_ops.py::f32_row_tiles).
inline int ff_mt(int rows) {
  const int g = (rows < 16 * FF_MAX_MT ? rows : 16 * FF_MAX_MT) + 15;
  const int need = g / 16;
  return need <= 1 ? 1 : (need <= 2 ? 2 : (need <= 4 ? 4 : 8));
}

__device__ __forceinline__ float4 ff_ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Four W values at p as f32: a float4, or four int8 converted exactly.
template <typename WT>
__device__ __forceinline__ float4 ff_ldw4(const WT* p) {
  if constexpr (std::is_same_v<WT, int8_t>) {
    const char4 c = __ldg(reinterpret_cast<const char4*>(p));
    return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
  } else {
    return ff_ld4(p);
  }
}

template <int MT, bool NT, typename WT = float>
__device__ __forceinline__ void ffma_tile(float (&acc)[MT][4], const float* __restrict__ x,
                                          int ldx, int rows, const WT* __restrict__ w,
                                          size_t ldw, int cols, int k0, int k1, float* sm) {
  constexpr int PR = 16 * MT;                                  // rows of the pass
  constexpr int XQ = PR * FF_KC / 4;                           // float4 of a rows chunk
  constexpr int XV = (XQ + FF_THREADS - 1) / FF_THREADS;       // ... a thread loads
  constexpr int STAGE = ff_stage_floats<MT>();
  const int t = threadIdx.x, tc = t & 15, tr = t >> 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const int chunks = (k1 - k0) / FF_KC;
  float4 wr, xr[XV];
  auto fetch = [&](int c) {
    const int kb = k0 + c * FF_KC;
    if constexpr (NT) {
      const int e = t & 63, kq = (t >> 6) * 4;
      wr = e < cols ? ff_ldw4(w + (size_t)e * ldw + kb + kq) : zero;
    } else {
      wr = ff_ldw4(w + (size_t)(kb + (t >> 4)) * ldw + 4 * (t & 15));
    }
#pragma unroll
    for (int h = 0; h < XV; ++h) {
      const int idx = t + h * FF_THREADS;
      if (XQ % FF_THREADS == 0 || idx < XQ) {
        const int r = idx % PR, kq = (idx / PR) * 4;
        xr[h] = r < rows ? ff_ld4(x + (size_t)r * ldx + kb + kq) : zero;
      }
    }
  };
  auto stash = [&](float* s) {
    float* ws = s;
    float* xs = s + FF_KC * FF_COLS;
    if constexpr (NT) {
      const int e = t & 63, kq = (t >> 6) * 4;
      ws[(kq + 0) * FF_COLS + e] = wr.x;
      ws[(kq + 1) * FF_COLS + e] = wr.y;
      ws[(kq + 2) * FF_COLS + e] = wr.z;
      ws[(kq + 3) * FF_COLS + e] = wr.w;
    } else {
      *reinterpret_cast<float4*>(ws + (t >> 4) * FF_COLS + 4 * (t & 15)) = wr;
    }
#pragma unroll
    for (int h = 0; h < XV; ++h) {
      const int idx = t + h * FF_THREADS;
      if (XQ % FF_THREADS == 0 || idx < XQ) {
        const int r = idx % PR, kq = (idx / PR) * 4;
        xs[(kq + 0) * PR + r] = xr[h].x;
        xs[(kq + 1) * PR + r] = xr[h].y;
        xs[(kq + 2) * PR + r] = xr[h].z;
        xs[(kq + 3) * PR + r] = xr[h].w;
      }
    }
  };
  if (chunks > 0) {
    fetch(0);
    stash(sm);
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const float* ws = sm + (c & 1) * STAGE;
    const float* xs = ws + FF_KC * FF_COLS;
    if (c + 1 < chunks) fetch(c + 1);
#pragma unroll
    for (int kk = 0; kk < FF_KC; ++kk) {
      const float4 wv = *reinterpret_cast<const float4*>(ws + kk * FF_COLS + 4 * tc);
      float xv[MT];
      const float* xp = xs + kk * PR + tr * MT;
      if constexpr (MT == 1) {
        xv[0] = xp[0];
      } else if constexpr (MT == 2) {
        const float2 v2 = *reinterpret_cast<const float2*>(xp);
        xv[0] = v2.x;
        xv[1] = v2.y;
      } else {
#pragma unroll
        for (int i = 0; i < MT; i += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(xp + i);
          xv[i] = v4.x;
          xv[i + 1] = v4.y;
          xv[i + 2] = v4.z;
          xv[i + 3] = v4.w;
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        acc[i][0] = fmaf(xv[i], wv.x, acc[i][0]);
        acc[i][1] = fmaf(xv[i], wv.y, acc[i][1]);
        acc[i][2] = fmaf(xv[i], wv.z, acc[i][2]);
        acc[i][3] = fmaf(xv[i], wv.w, acc[i][3]);
      }
    }
    if (c + 1 < chunks) stash(sm + ((c + 1) & 1) * STAGE);
    __syncthreads();
  }
}

}  // namespace
}  // namespace wm
