// K1 — full-sequence attention forward in (B, H, S, Dh=64) layout.
//
// Replaces whisper_medusa_tpu/ops/attention.py::_attention_kernel (TPU,
// launched by _attention_pallas).  The TPU kernel keeps a head's whole K/V
// resident and runs a one-pass softmax; on Hopper 1536 x 64 bf16 K plus V
// (384 KB) exceeds an SM's 227 KB of shared memory, so this is a flash-style
// forward instead:
//
//  * one CTA (4 warps) per (batch, head, 64-query block); each warp owns 16
//    query rows, whose Q fragments stay in registers;
//  * K/V stream through shared memory in 64-key tiles; S = QK^T and the
//    P.V product run on the tensor cores (WMMA m16n16k16, bf16 in, f32 out);
//  * online softmax in f32: each lane keeps the running max, sum and two
//    output columns of every row of its warp;
//  * masks: key < kv_len, plus key <= query when causal; key tiles past the
//    last visible key are skipped; the ragged sequence edge is zero-filled on
//    load and never stored.
//
// Bound on H100: tensor-core throughput plus the softmax's exp/shuffle work, not
// bytes: one encoder layer (20 heads of 1500 x 1500 x 64) is 11.5 GFLOP
// against 15 MB of q/k/v/out.
#include "common.cuh"

namespace wm {
namespace {

constexpr int AQ = 64;        // queries per CTA
constexpr int AK = 64;        // keys per tile
constexpr int ADH = 64;       // head dim
constexpr int ALD = ADH + 8;  // bf16 smem pitch
constexpr int ALDS = AK + 4;  // f32 smem pitch
constexpr int ATTN_SMEM = 3 * AQ * ALD * 2 + AQ * ALDS * 4 + AQ * ALD * 2;

__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int n_rows) {
  // 64 rows x 64 bf16 = 512 uint4, 128 threads.
  for (int i = threadIdx.x; i < 64 * 8; i += 128) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ADH + c);
    *reinterpret_cast<uint4*>(dst + r * ALD + c) = v;
  }
}

__global__ void __launch_bounds__(128)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int n_heads,
                 int sq, int skv, int kv_len, int causal) {
  extern __shared__ __align__(128) char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + AQ * ALD;
  bf16* vs = ks + AK * ALD;
  float* ss = reinterpret_cast<float*>(vs + AK * ALD);
  bf16* ps = reinterpret_cast<bf16*>(ss + AQ * ALDS);

  const int q0 = blockIdx.x * AQ;
  const size_t bh = (size_t)blockIdx.z * n_heads + blockIdx.y;
  const bf16* qh = q + bh * sq * ADH;
  const bf16* kh = k + bh * skv * ADH;
  const bf16* vh = v + bh * skv * ADH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = warp * 16;

  load_tile(qs, qh, q0, sq);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[ADH / 16];
#pragma unroll
  for (int kk = 0; kk < ADH / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], qs + wrow * ALD + kk * 16, ALD);

  float m_run[16], l_run[16], acc0[16], acc1[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.0f;
    acc0[r] = 0.0f;
    acc1[r] = 0.0f;
  }

  const int kend = causal ? min(kv_len, q0 + AQ) : kv_len;
  for (int k0 = 0; k0 < kend; k0 += AK) {
    load_tile(ks, kh, k0, skv);
    load_tile(vs, vh, k0, skv);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
#pragma unroll
    for (int j = 0; j < AK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < ADH / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, ks + j * 16 * ALD + kk * 16, ALD);
        wmma::mma_sync(sacc, qa[kk], kb, sacc);
      }
      wmma::store_matrix_sync(ss + wrow * ALDS + j * 16, sacc, ALDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax; lane holds key columns lane and lane + 32.
    const int j0 = k0 + lane, j1 = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qi = q0 + wrow + r;
      const bool ok0 = j0 < kv_len && (!causal || j0 <= qi);
      const bool ok1 = j1 < kv_len && (!causal || j1 <= qi);
      const float s0 = ss[(wrow + r) * ALDS + lane];
      const float s1 = ss[(wrow + r) * ALDS + lane + 32];
      const float tmax = warp_max(fmaxf(ok0 ? s0 : -INFINITY, ok1 ? s1 : -INFINITY));
      const float m_new = fmaxf(m_run[r], tmax);
      float p0 = 0.0f, p1 = 0.0f, alpha = 1.0f;
      if (m_new != -INFINITY) {
        p0 = ok0 ? __expf(s0 - m_new) : 0.0f;
        p1 = ok1 ? __expf(s1 - m_new) : 0.0f;
        alpha = m_run[r] == -INFINITY ? 0.0f : __expf(m_run[r] - m_new);
      }
      l_run[r] = l_run[r] * alpha + warp_sum(p0 + p1);
      m_run[r] = m_new;
      acc0[r] *= alpha;
      acc1[r] *= alpha;
      ps[(wrow + r) * ALD + lane] = f2bf(p0);
      ps[(wrow + r) * ALD + lane + 32] = f2bf(p1);
    }
    __syncwarp();

    // O += P V for this warp's rows (partial tile staged through ss).
#pragma unroll
    for (int j = 0; j < ADH / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::fill_fragment(oacc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < AK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, ps + wrow * ALD + kk * 16, ALD);
        wmma::load_matrix_sync(vb, vs + kk * 16 * ALD + j * 16, ALD);
        wmma::mma_sync(oacc, pa, vb, oacc);
      }
      wmma::store_matrix_sync(ss + wrow * ALDS + j * 16, oacc, ALDS,
                              wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      acc0[r] += ss[(wrow + r) * ALDS + lane];
      acc1[r] += ss[(wrow + r) * ALDS + lane + 32];
    }
    __syncthreads();
  }

  bf16* oh = o + bh * sq * ADH;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + wrow + r;
    if (qi < sq) {
      const float inv = l_run[r] > 0.0f ? 1.0f / l_run[r] : 0.0f;
      oh[(size_t)qi * ADH + lane] = f2bf(acc0[r] * inv);
      oh[(size_t)qi * ADH + lane + 32] = f2bf(acc1[r] * inv);
    }
  }
}

}  // namespace
}  // namespace wm

extern "C" int wm_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, int b, int h, int sq, int skv, int dh,
                                int kv_len, int causal, void* stream) {
  using namespace wm;
  if (dh != ADH) return (int)cudaErrorInvalidValue;
  // Per launch: the attribute belongs to the current device's context.
  cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       ATTN_SMEM);
  dim3 grid((sq + AQ - 1) / AQ, h, b);
  attention_kernel<<<grid, 128, ATTN_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, h, sq, skv,
      kv_len, causal);
  return (int)cudaGetLastError();
}
