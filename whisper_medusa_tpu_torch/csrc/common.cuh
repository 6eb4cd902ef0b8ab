// Shared device code of the port's Hopper kernels (sm_90a).
//
// Two building blocks are used by more than one kernel:
//
//  * skinny_gemm_kernel: Y[M, N] = epilogue(A[M, K] @ W[K, N] + bias) for
//    M <= 128 rows (the decode chunk of up to 8 examples, or the
//    verification source rows), W stored (in, out) as in the JAX package.
//    One CTA of 16 warps per 16-column output tile; the K/16 steps of 16
//    are split over the warps as evenly as they go, in fixed contiguous
//    ranges (K % 64 == 0; at K % 256 == 0 every warp takes K/256 steps at
//    offset warp * K/16, and at K = 384 warps 0-7 take two steps, 8-15
//    one); each warp loads its weight fragments in batches of five, then
//    runs the tensor-core products of every 16-row tile of A against them,
//    so each weight element is read once per call whatever M is and a
//    whole weight matrix is in flight at once.  The 16 per-warp partial tiles of each row
//    tile are summed in a fixed order in shared memory, one row tile after
//    the other (deterministic, no atomics).  A row's arithmetic — its K split,
//    its product order and its reduction order — is the same for every M, so
//    an example's result does not depend on what it is batched with.  At
//    decode sizes this is bound by the weight stream.  W8A16 form (int8
//    serving): W is int8 with an f32 scale per output column; each warp
//    loads its 16x16 int8 fragments (8 bytes a lane), converts them exactly
//    to bf16 through a 512-byte shared tile of its own (WMMA has no
//    int8 x bf16 product and its fragment layout is opaque), runs the same
//    K split and reduction order, and multiplies the summed column by its
//    scale before the bias.
//
//  * vocab_tile: C[128, 64] = X[rows, D] @ E[v0 : v0 + 64, D]^T for the tied
//    embedding E (V, D), both staged through shared memory in 64-wide K
//    slices (zero-filled past the last row and the last vocab entry) and
//    multiplied with WMMA, f32 accumulation.  Bound by the embedding stream
//    (133 MB at large-v2) plus one L2 read of the rows per vocab tile.  An
//    int8 embedding is converted to bf16 as it is staged (66 MB stream).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace wm {
namespace {   // internal linkage: every .cu gets its own copy

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// Mask constants copied from the JAX package, one per site.
constexpr float NEG_SELF = -1e30f;                    // megastep.py NEG_SELF
constexpr float NEG_VERIFY = -3.4028234663852886e38f / 2.0f;  // verify.py NEG

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 f2bf(float x) { return __float2bfloat16(x); }
// Round a float to the nearest bf16 and back (the JAX ``.astype(bf16)``).
__device__ __forceinline__ float bfr(float x) { return bf2f(f2bf(x)); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// int8 -> bf16 (exact for |q| <= 127), little-endian byte order kept.
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return (float)(int8_t)(w >> (8 * i));
}
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint2 i8x4_to_bf16(uint32_t w) {
  return make_uint2(pack_bf2(i8_at(w, 0), i8_at(w, 1)), pack_bf2(i8_at(w, 2), i8_at(w, 3)));
}
__device__ __forceinline__ uint4 i8x8_to_bf16(uint2 w) {
  const uint2 lo = i8x4_to_bf16(w.x), hi = i8x4_to_bf16(w.y);
  return make_uint4(lo.x, lo.y, hi.x, hi.y);
}

// 4 / 8 consecutive elements of a bf16 or int8 array as bf16 (8- / 16-byte
// stores); p is 4-element (8-element) aligned.
__device__ __forceinline__ uint2 load4(const bf16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ uint2 load4(const int8_t* p) {
  return i8x4_to_bf16(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8(const int8_t* p) {
  return i8x8_to_bf16(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ bf16 to_bf(bf16 v) { return v; }
__device__ __forceinline__ bf16 to_bf(int8_t v) { return f2bf((float)v); }

// ---------------------------------------------------------------------------
// Skinny GEMM
// ---------------------------------------------------------------------------

enum Epi : int {
  EPI_BIAS = 0,          // out = bf16(acc + b)
  EPI_BIAS_SCALE = 1,    // out = bf16(bf16(acc + b) * scale)   (q projections)
  EPI_BIAS_GELU = 2,     // out = bf16(gelu(acc + b))            (fc1)
  EPI_BIAS_RESID = 3,    // out = bf16(res + bf16(acc + b))      (o, fc2; res may be out)
  EPI_SILU_RESID = 4,    // out = bf16(res + bf16(silu(acc + b))) (Medusa res block)
};

struct SkinnyJob {
  const void* w;      // (K, N) row-major: bf16, or int8 when wscale is set
  const float* wscale;  // (N,) f32 per-column scales (W8A16), or nullptr
  const bf16* bias;   // (N,) or nullptr
  const bf16* res;    // residual rows (ld = ldres) or nullptr
  bf16* out;          // output rows (ld = ldo)
  int epi;
  float scale;
};

struct SkinnyJobs {
  SkinnyJob j[3];
};

constexpr int SK_WARPS = 16;   // K's 16-wide steps are split over 16 warps
constexpr int SK_BATCH = 5;    // weight fragments loaded per batch
constexpr int SK_MAX_ROWS = 128;   // 8 row tiles of 16

// grid: (N / 16, njobs or batch).  With njobs == 1 the y index is a batch
// index that offsets W, its scales, bias and the output by the given strides
// (the per-head Medusa blocks; scales and bias share b_stride); otherwise it
// selects one of up to three jobs that share A (the q/k/v projections).
// MT = ceil(M / 16) row tiles; A must have MT * 16 rows allocated (rows >=
// m_rows are computed and dropped).  W8: every job's W is int8 with scales.
template <int MT, bool W8>
__global__ void __launch_bounds__(SK_WARPS * 32)
skinny_gemm_kernel(const bf16* __restrict__ a, int lda, int m_rows, int k_dim,
                   int n_dim, int ldo, int ldres, SkinnyJobs jobs, int njobs,
                   long long w_stride, long long b_stride, long long o_stride) {
  const int y = blockIdx.y;
  // Select without a dynamic index into the parameter array (which would
  // spill the jobs to local memory).
  const SkinnyJob jb = (njobs == 1 || y == 0) ? jobs.j[0] : (y == 1 ? jobs.j[1] : jobs.j[2]);
  const long long batch = njobs == 1 ? y : 0;
  const int n0 = blockIdx.x * 16;
  const int warp = threadIdx.x >> 5;
  // Warp w takes steps [w * base + min(w, extra), + base + (w < extra)) of
  // the K / 16: contiguous, fixed for a given K, and independent of M.
  const int ksteps = k_dim / 16;
  const int base = ksteps / SK_WARPS, extra = ksteps % SK_WARPS;
  const int kbeg = (warp * base + min(warp, extra)) * 16;
  const int nsteps = base + (warp < extra ? 1 : 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) wmma::fill_fragment(acc[mt], 0.0f);
  for (int s0 = 0; s0 < nsteps; s0 += SK_BATCH) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[SK_BATCH];
    if constexpr (W8) {
      // Lane l holds bytes [8 (l & 1), + 8) of fragment row l >> 1.
      __shared__ __align__(32) bf16 wst[SK_WARPS][16 * 16];
      const int8_t* w = static_cast<const int8_t*>(jb.w) + batch * w_stride;
      const int lane = threadIdx.x & 31;
      const int r = lane >> 1, c8 = (lane & 1) * 8;
      uint2 raw[SK_BATCH];
#pragma unroll
      for (int i = 0; i < SK_BATCH; ++i) {
        if (s0 + i < nsteps)
          raw[i] = *reinterpret_cast<const uint2*>(
              w + (size_t)(kbeg + (s0 + i) * 16 + r) * n_dim + n0 + c8);
      }
#pragma unroll
      for (int i = 0; i < SK_BATCH; ++i) {
        if (s0 + i < nsteps) {
          *reinterpret_cast<uint4*>(&wst[warp][r * 16 + c8]) = i8x8_to_bf16(raw[i]);
          __syncwarp();
          wmma::load_matrix_sync(fb[i], &wst[warp][0], 16);
          __syncwarp();
        }
      }
    } else {
      const bf16* w = static_cast<const bf16*>(jb.w) + batch * w_stride;
#pragma unroll
      for (int i = 0; i < SK_BATCH; ++i) {
        if (s0 + i < nsteps)
          wmma::load_matrix_sync(fb[i], w + (size_t)(kbeg + (s0 + i) * 16) * n_dim + n0,
                                 n_dim);
      }
    }
#pragma unroll
    for (int i = 0; i < SK_BATCH; ++i) {
      if (s0 + i < nsteps) {
        const int k = kbeg + (s0 + i) * 16;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, a + (size_t)mt * 16 * lda + k, lda);
          wmma::mma_sync(acc[mt], fa, fb[i], acc[mt]);
        }
      }
    }
  }

  __shared__ __align__(32) float red[SK_WARPS][256];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt > 0) __syncthreads();   // the previous tile's sums are read
    wmma::store_matrix_sync(red[warp], acc[mt], 16, wmma::mem_row_major);
    __syncthreads();
    const int m = mt * 16 + (threadIdx.x >> 4);
    if (threadIdx.x < 256 && m < m_rows) {
      const int n = n0 + (threadIdx.x & 15);
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < SK_WARPS; ++i) s += red[i][threadIdx.x];
      if constexpr (W8) s *= jb.wscale[batch * b_stride + n];
      if (jb.bias) s += bf2f(jb.bias[batch * b_stride + n]);
      float r;
      switch (jb.epi) {
        case EPI_BIAS_SCALE: r = bfr(s) * jb.scale; break;
        case EPI_BIAS_GELU: r = gelu_erf(s); break;
        case EPI_BIAS_RESID: r = bf2f(jb.res[(size_t)m * ldres + n]) + bfr(s); break;
        case EPI_SILU_RESID:
          r = bf2f(jb.res[(size_t)m * ldres + n]) + bfr(s / (1.0f + expf(-s)));
          break;
        default: r = s;
      }
      jb.out[batch * o_stride + (size_t)m * ldo + n] = f2bf(r);
    }
  }
}

// Launch helper: m_rows <= SK_MAX_ROWS; a has ceil(m_rows / 16) * 16 rows
// allocated (rows >= m_rows are ignored).  The first job's wscale selects
// the W8A16 form for all of them.
inline void skinny_gemm(const bf16* a, int lda, int m_rows, int k_dim, int n_dim,
                        int ldo, int ldres, const SkinnyJobs& jobs, int njobs,
                        int grid_y, long long w_stride, long long b_stride,
                        long long o_stride, cudaStream_t stream) {
  dim3 grid(n_dim / 16, grid_y);
  const bool w8 = jobs.j[0].wscale != nullptr;
#define WM_SKINNY(MT)                                                          \
  case MT:                                                                     \
    if (w8)                                                                    \
      skinny_gemm_kernel<MT, true><<<grid, SK_WARPS * 32, 0, stream>>>(        \
          a, lda, m_rows, k_dim, n_dim, ldo, ldres, jobs, njobs, w_stride,     \
          b_stride, o_stride);                                                 \
    else                                                                       \
      skinny_gemm_kernel<MT, false><<<grid, SK_WARPS * 32, 0, stream>>>(       \
          a, lda, m_rows, k_dim, n_dim, ldo, ldres, jobs, njobs, w_stride,     \
          b_stride, o_stride);                                                 \
    break;
  switch ((m_rows + 15) / 16) {
    WM_SKINNY(1) WM_SKINNY(2) WM_SKINNY(3) WM_SKINNY(4)
    WM_SKINNY(5) WM_SKINNY(6) WM_SKINNY(7) WM_SKINNY(8)
    default: break;   // callers check m_rows <= SK_MAX_ROWS
  }
#undef WM_SKINNY
}

inline SkinnyJob job(const void* w, const bf16* bias, bf16* out, int epi,
                     const bf16* res = nullptr, float scale = 1.0f,
                     const float* wscale = nullptr) {
  SkinnyJob j;
  j.w = w;
  j.wscale = wscale;
  j.bias = bias;
  j.res = res;
  j.out = out;
  j.epi = epi;
  j.scale = scale;
  return j;
}

// ---------------------------------------------------------------------------
// Vocab tile: rows x 64 embedding rows on the tensor cores
// ---------------------------------------------------------------------------

constexpr int VT = 64;          // vocab entries per CTA
constexpr int VKC = 64;         // K slice staged per step
constexpr int VRB = 128;        // rows per block (8 warps x 16)
constexpr int VLDS = VKC + 8;   // bf16 smem pitch (bank-conflict pad)
constexpr int VLDC = VT + 4;    // f32 smem pitch
constexpr int VTHREADS = 256;
constexpr int VOCAB_SMEM =
    VRB * VLDS * 2 + VT * VLDS * 2 + VRB * VLDC * 4;   // 62464 bytes

// Fills cs[VRB][VLDC] with rows [row0, row0 + 128) x vocab [v0, v0 + 64).
// Rows >= n_rows and vocab entries >= v_dim read as zero.  Ends synchronized.
// ET: bf16, or int8 (converted to bf16 as it is staged; the caller applies
// the per-entry scales).
template <typename ET>
__device__ __forceinline__ void vocab_tile(const bf16* __restrict__ x, int n_rows,
                                           int row0, const ET* __restrict__ e,
                                           int v_dim, int d_dim, int v0,
                                           char* smem) {
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + VRB * VLDS;
  float* cs = reinterpret_cast<float*>(bs + VT * VLDS);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const bool live = row0 + warp * 16 < n_rows;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[VT / 16];
#pragma unroll
  for (int j = 0; j < VT / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < d_dim; k0 += VKC) {
    for (int i = tid; i < VRB * (VKC / 8); i += VTHREADS) {
      const int r = i / (VKC / 8), c = (i % (VKC / 8)) * 8;
      uint4 val = zero;
      if (row0 + r < n_rows)
        val = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * d_dim + k0 + c);
      *reinterpret_cast<uint4*>(as + r * VLDS + c) = val;
    }
    for (int i = tid; i < VT * (VKC / 8); i += VTHREADS) {
      const int r = i / (VKC / 8), c = (i % (VKC / 8)) * 8;
      uint4 val = zero;
      if (v0 + r < v_dim) val = load8(e + (size_t)(v0 + r) * d_dim + k0 + c);
      *reinterpret_cast<uint4*>(bs + r * VLDS + c) = val;
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < VKC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, as + warp * 16 * VLDS + kk, VLDS);
#pragma unroll
        for (int j = 0; j < VT / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, bs + j * 16 * VLDS + kk, VLDS);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < VT / 16; ++j)
    wmma::store_matrix_sync(cs + warp * 16 * VLDC + j * 16, acc[j], VLDC,
                            wmma::mem_row_major);
  __syncthreads();
}

}  // namespace
}  // namespace wm
