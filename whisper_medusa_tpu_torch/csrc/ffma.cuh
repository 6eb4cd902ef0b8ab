// The f32 building blocks of the port's f32 modes: f32 products with f32
// sums in FFMA on the CUDA cores.  Hopper's tensor cores take f32 operands
// only as TF32 (about three decimal digits), which is not the JAX package's
// f32, so none of these touches them.
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
// (rows of E), those past `cols` read as zero.  K4 / K5's f32 vocab stream
// (verify.cu) runs on the NT tile.  The f32 GEMM (K11's f32 mode, the f32
// head rows, the per-op step's f32 projections) is ffma_gemm.cuh's weight
// stream.
//
// W8A32 (the int8 copy of an f32 model): ffma_tile<MT, NT, int8_t> reads an
// int8 W (or E) and converts each value exactly to f32 as it is fetched,
// the rest of the tile unchanged; ffma_gemm8_kernel + ffma_combine8_kernel
// are the GEMM over int8 weights, up to three jobs on one X (K2's q / k /
// v) or a stack of heads: a CTA per (64 columns, K slice, output, row
// pass), its partial sums to an (nz, slices, M, N) f32 scratch, then the
// combine adds the slices in slice order and applies the column's f32
// scale to their sum before the bias and the epilogue (the JAX kernels'
// ``mm``: the sum times the scale, then the bias).  The K slices come from
// (K, N) alone (ff_gemm_slice, mirrored by ops/decode_ops.py::
// w8a32_gemm_plan), so a row's result does not depend on M.  Bound on H100:
// bytes at the decode step's M (large-v2's int8 fc2, 6.6 MB, 2.0 us at
// 3.35 TB/s), operations at the 67 TFLOP/s of the CUDA cores past M ~ 16.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace wm {
namespace {

constexpr int FF_THREADS = 256;
constexpr int FF_COLS = 64;       // output columns (or vocab entries) a CTA
constexpr int FF_KC = 16;         // K a staged chunk holds
constexpr int FF_MAX_MT = 8;      // 16-row groups a pass: up to 128 rows
constexpr int FF_WAVE = 264;      // CTAs a GEMM's K slices aim at: two an SM

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

// The K slice of a (K, N) GEMM, from (K, N) alone: enough slices for
// FF_WAVE CTAs over the N / 64 column tiles, each a multiple of FF_KC deep.
inline int ff_gemm_slice(int k, int n) {
  const int tiles = n / FF_COLS;
  const int want = (FF_WAVE + tiles - 1) / tiles;
  const int len = (k + want - 1) / want;
  const int slice = (len + FF_KC - 1) / FF_KC * FF_KC;
  return slice < k ? slice : k;
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

// ---------------------------------------------------------------------------
// The W8A32 GEMM: out = epi(x (M, K) @ (q (K, N) * s) + b) in f32.

// One job: an int8 (K, N) weight and its f32 column scales, the bias (may be
// null), the residual of EPI_BIAS_RESID / EPI_SILU_RESID ((M, N), may be
// out itself), the (M, N) output and EPI_BIAS_SCALE's factor.
struct Ff8Job {
  const int8_t* w;
  const float* s;
  const float* b;
  const float* resid;
  float* out;
  float post;
  int epi;
};

// Grid z runs over nz outputs: z < njobs takes job z; past it, job njobs -
// 1's stack (heads: w (nz, K, N), s and b (nz, N), out (nz, M, N)) at
// layer z - (njobs - 1).
struct FfGemm8 {
  const float* x;
  Ff8Job j[3];
  int njobs;
  float* part;          // (nz, slices, M, N) f32 scratch
  int m, k, n, slice, slices, passes;
};

__device__ __forceinline__ int ff8_job(const FfGemm8& g, int z, int* layer) {
  const int jz = z < g.njobs ? z : g.njobs - 1;
  *layer = z - jz;
  return jz;
}

template <int MT>
__global__ void __launch_bounds__(FF_THREADS) ffma_gemm8_kernel(const FfGemm8 g) {
  __shared__ __align__(16) float sm[2 * ff_stage_floats<MT>()];
  const int tile = blockIdx.x / g.passes, pass = blockIdx.x % g.passes;
  const int s = blockIdx.y, z = blockIdx.z;
  int layer;
  const int jz = ff8_job(g, z, &layer);
  const int n0 = tile * FF_COLS, r0 = pass * 16 * MT;
  const int k0 = s * g.slice, k1 = min(g.k, k0 + g.slice);
  const int rows = min(16 * MT, g.m - r0);
  float acc[MT][4];
  ffma_tile<MT, false, int8_t>(acc, g.x + (size_t)r0 * g.k, g.k, rows,
                               g.j[jz].w + (size_t)layer * g.k * g.n + n0, g.n, FF_COLS, k0,
                               k1, sm);
  const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
  float* p = g.part + ((size_t)z * g.slices + s) * g.m * g.n + n0 + 4 * tc;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = tr * MT + i;
    if (r < rows)
      *reinterpret_cast<float4*>(p + (size_t)(r0 + r) * g.n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// out[r][c] = epi((part[0][r][c] + ... + part[S-1][r][c]) * s[c] + b[c]),
// the slices added in order.
__global__ void __launch_bounds__(256) ffma_combine8_kernel(const FfGemm8 g, int nz) {
  const size_t mn = (size_t)g.m * g.n;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)nz * mn) return;
  const int z = (int)(i / mn);
  const size_t rc = i % mn;
  const int c = (int)(rc % g.n);
  int layer;
  const Ff8Job& jb = g.j[ff8_job(g, z, &layer)];
  const float* p = g.part + (size_t)z * g.slices * mn + rc;
  float y = p[0];
  for (int s = 1; s < g.slices; ++s) y += p[s * mn];
  y *= jb.s[(size_t)layer * g.n + c];
  if (jb.b != nullptr) y += jb.b[(size_t)layer * g.n + c];
  switch (jb.epi) {
    case EPI_BIAS_SCALE: y *= jb.post; break;
    case EPI_BIAS_GELU: y = gelu_erf(y); break;
    case EPI_BIAS_RESID: y = jb.resid[rc] + y; break;
    case EPI_SILU_RESID: y = jb.resid[rc] + y / (1.0f + expf(-y)); break;
    default: break;
  }
  jb.out[(size_t)layer * mn + rc] = y;
}

template <int MT = 1>
int ff_gemm8_launch(int mt, const FfGemm8& g, int nz, cudaStream_t st) {
  if (mt == MT) {
    ffma_gemm8_kernel<MT><<<dim3(g.n / FF_COLS * g.passes, g.slices, nz), FF_THREADS, 0, st>>>(g);
    return (int)cudaGetLastError();
  }
  if constexpr (MT < FF_MAX_MT) return ff_gemm8_launch<MT * 2>(mt, g, nz, st);
  return (int)cudaErrorInvalidValue;
}

// nz outputs of x (M, K) through the njobs jobs (njobs <= 3, nz >= njobs);
// part: the (nz, slices, M, N) scratch (ops/decode_ops.py::w8a32_gemm_plan
// with nh = nz sizes it).  K % 16 == 0, N % 64 == 0, x 16-byte and w
// 4-byte aligned.
inline int ff_gemm8(const float* x, const Ff8Job* jobs, int njobs, int nz, float* part, int m,
                    int k, int n, cudaStream_t st) {
  if (m < 1 || k < FF_KC || k % FF_KC || n < FF_COLS || n % FF_COLS || njobs < 1 ||
      njobs > 3 || nz < njobs)
    return (int)cudaErrorInvalidValue;
  FfGemm8 g;
  g.x = x;
  for (int i = 0; i < 3; ++i) g.j[i] = jobs[i < njobs ? i : njobs - 1];
  g.njobs = njobs;
  g.part = part;
  g.m = m;
  g.k = k;
  g.n = n;
  g.slice = ff_gemm_slice(k, n);
  g.slices = (k + g.slice - 1) / g.slice;
  const int mt = ff_mt(m);
  g.passes = (m + 16 * mt - 1) / (16 * mt);
  int err = ff_gemm8_launch(mt, g, nz, st);
  if (err != 0) return err;
  const size_t total = (size_t)nz * m * n;
  ffma_combine8_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(g, nz);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wm
