// K6 — Y[M, N] = (bf16(X[M, K]) @ bf16(Wq[K, N])) * s[N], f32 out, and
// K7 — Y[M, V] = (bf16(X[M, D]) @ bf16(Eq[V, D])^T) * s[V], f32 out: the int8
// weight-only (W8A16) products of int8 serving.
//
// K6 replaces whisper_medusa_tpu/ops/qmm.py::_qmm_kernel (TPU, launched by
// qmm), which keeps all of x in VMEM and streams 512-column weight blocks,
// converting them to bf16 in VMEM.  Here one CTA (8 warps) computes one
// 64 x 64 output tile: per 64-wide K slice it stages the bf16 x tile and the
// int8 weight tile, converted exactly to bf16 on the way into shared memory,
// and each warp runs WMMA on one 16-row tile x two 16-column tiles with f32
// accumulation; the epilogue writes acc * s[n].  On the decode path it
// projects each example's encoder output (1500 x 1280) into the cross K and V
// of every layer (init_cache).  Bound on H100 at (1500, 1280, 1280): the 4.9
// GFLOP of products (5 us at 989 TFLOP/s) over its 13.2 MB (4 us at 3.35
// TB/s); this first version stages without a copy pipeline.
//
// K7 replaces whisper_medusa_tpu/ops/qmm.py::_qmm_nt_kernel (TPU, launched
// by qmm_nt), the int8 tied-embedding projection: K3's kernel with an int8
// loader — one CTA per 64 vocab rows (common.cuh::vocab_tile<int8_t>), rows
// in blocks of 128, the ragged last tile (51865 = 810 x 64 + 25) zero-filled
// on load and masked on store.  Bound on H100: bytes, the 66 MB int8
// embedding plus M x 207 KB of f32 output.
#include "common.cuh"

namespace wm {
namespace {

constexpr int QT = 64;          // output tile rows and columns; K slice
constexpr int QLD = QT + 8;     // bf16 smem pitch
constexpr int QLDC = QT + 4;    // f32 smem pitch

__global__ void __launch_bounds__(256)
qmm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
           const float* __restrict__ s, float* __restrict__ y, int m, int k, int n) {
  __shared__ __align__(128) bf16 xs[QT * QLD];
  __shared__ __align__(128) bf16 ws[QT * QLD];
  __shared__ __align__(128) float cs[QT * QLDC];
  const int n0 = blockIdx.x * QT, m0 = blockIdx.y * QT;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp >> 1;          // row tile
  const int wc = (warp & 1) * 2;     // first of two column tiles
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < k; k0 += QT) {
    for (int i = tid; i < QT * (QT / 8); i += 256) {
      const int r = i / (QT / 8), c = (i % (QT / 8)) * 8;
      uint4 val = zero;
      if (m0 + r < m) val = load8(x + (size_t)(m0 + r) * k + k0 + c);
      *reinterpret_cast<uint4*>(xs + r * QLD + c) = val;
      *reinterpret_cast<uint4*>(ws + r * QLD + c) =
          load8(wq + (size_t)(k0 + r) * n + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, xs + wr * 16 * QLD + kk, QLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, ws + kk * QLD + (wc + j) * 16, QLD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(cs + wr * 16 * QLDC + (wc + j) * 16, acc[j], QLDC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < QT * QT; i += 256) {
    const int r = i / QT, c = i % QT;
    if (m0 + r < m) y[(size_t)(m0 + r) * n + n0 + c] = cs[r * QLDC + c] * s[n0 + c];
  }
}

__global__ void __launch_bounds__(VTHREADS)
qmm_nt_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ e,
              const float* __restrict__ s, float* __restrict__ y, int m_rows, int v_dim,
              int d_dim) {
  extern __shared__ __align__(128) char smem[];
  const float* cs = reinterpret_cast<const float*>(smem + VRB * VLDS * 2 + VT * VLDS * 2);
  const int v0 = blockIdx.x * VT;
  for (int row0 = 0; row0 < m_rows; row0 += VRB) {
    vocab_tile(x, m_rows, row0, e, v_dim, d_dim, v0, smem);
    for (int i = threadIdx.x; i < VRB * VT; i += VTHREADS) {
      const int r = i / VT, c = i % VT;
      if (row0 + r < m_rows && v0 + c < v_dim)
        y[(size_t)(row0 + r) * v_dim + v0 + c] = cs[r * VLDC + c] * s[v0 + c];
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace wm

// x (m, k) bf16, wq (k, n) int8, s (n,) f32 -> y (m, n) f32; k, n % 64 == 0.
extern "C" int wm_qmm(const void* x, const void* wq, const void* s, void* y, int m,
                      int k, int n, void* stream) {
  using namespace wm;
  if (m < 1 || k % QT || n % QT) return (int)cudaErrorInvalidValue;
  qmm_kernel<<<dim3(n / QT, (m + QT - 1) / QT), 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const int8_t*)wq, (const float*)s, (float*)y, m, k, n);
  return (int)cudaGetLastError();
}

// x (m, d) bf16, e (v, d) int8, s (v,) f32 -> y (m, v) f32; d % 64 == 0.
extern "C" int wm_qmm_nt(const void* x, const void* e, const void* s, void* y, int m,
                         int v, int d, void* stream) {
  using namespace wm;
  if (m < 1 || d % VKC) return (int)cudaErrorInvalidValue;
  // Per launch: the attribute belongs to the current device's context.
  cudaFuncSetAttribute(qmm_nt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       VOCAB_SMEM);
  qmm_nt_kernel<<<(v + VT - 1) / VT, VTHREADS, VOCAB_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const int8_t*)e, (const float*)s, (float*)y, m, v, d);
  return (int)cudaGetLastError();
}
