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

// ---------------------------------------------------------------------------
// K9 — the attention backward: dQ, dK, dV of K1 (training).
//
// Replaces whisper_medusa_tpu/ops/attention.py::_attention_bwd_kernel (TPU,
// launched by _attention_bwd_pallas).  The TPU kernel keeps a head's whole K,
// V and dO resident, recomputes a (512, 1536) f32 score block per grid step
// and accumulates dK/dV in f32 VMEM scratch across the sequential q-blocks.
// One such block is 3 MB against an SM's 227 KB, and a CUDA grid has no
// sequential axis to accumulate across, so the work is split in three
// kernels, each of 4 warps over 64-row tiles, WMMA bf16 in / f32 out:
//
//  (a) bwd_stats_kernel, one CTA per (b, h, 64 queries): streams the key
//      tiles, S = Q K^T and dP = dO V^T, and keeps per row the running max m,
//      sum l and u = sum e^(s - m) dP with the same rescaling; it writes m,
//      1 / l and dsum = u / l (the TPU kernel's sum P * dP in f32);
//  (b) bwd_dkdv_kernel, one CTA per (b, h, 64 keys): loops over the query
//      tiles, recomputes S, dP and P = e^(s - m) / l, and accumulates
//      dV += bf16(P)^T dO and dK += dS^T Q, dS = bf16(P (dP - dsum));
//  (c) bwd_dq_kernel, one CTA per (b, h, 64 queries): loops over the key
//      tiles, recomputes dS and accumulates dQ += dS K.
//
// Each output is written once, with no atomics, so the result is
// deterministic.  The casts are the TPU kernel's: dS to bf16 before both of
// its products, P to bf16 for dV, every product accumulated in f32.  Masks
// (key < kv_len, causality, the ragged edges of both sequences) are applied
// in-kernel; dK and dV rows at keys >= kv_len come out exactly 0.
//
// Bound on H100: at the cross-attention's 224 x 1500 and the decoder's
// 224 x 224 by bytes (q, k, v, dO read once, dq, dk, dv written once), at
// the encoder's 1500 x 1500 by tensor-core operations (5 products of
// 2 Sq Skv Dh per head).  This design does 9 products of that size (S and
// dP three times), about 1.8x the minimum, and stages every product through
// shared memory; wgmma, TMA and a single pass are later work.
// ---------------------------------------------------------------------------

constexpr int BWD_SMEM_STATS = 4 * AQ * ALD * 2 + 2 * AQ * ALDS * 4;
constexpr int BWD_SMEM_DKDV = 6 * AQ * ALD * 2 + 2 * AQ * ALDS * 4;
constexpr int BWD_SMEM_DQ = 5 * AQ * ALD * 2 + 2 * AQ * ALDS * 4;

__device__ __forceinline__ bool visible(int qi, int kj, int sq, int kv_len,
                                        int causal) {
  return qi < sq && kj < kv_len && (!causal || kj <= qi);
}

// c[16][64] (f32, pitch ALDS) = a[16][64] . b[64][64]^T for this warp: a is
// the warp's first row of a bf16 tile, b a whole bf16 tile (pitch ALD).
__device__ __forceinline__ void warp_abt(const bf16* a, const bf16* b, float* c) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[ADH / 16];
#pragma unroll
  for (int kk = 0; kk < ADH / 16; ++kk) wmma::load_matrix_sync(fa[kk], a + kk * 16, ALD);
#pragma unroll
  for (int j = 0; j < AK / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < ADH / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + j * 16 * ALD + kk * 16, ALD);
      wmma::mma_sync(acc, fa[kk], fb, acc);
    }
    wmma::store_matrix_sync(c + j * 16, acc, ALDS, wmma::mem_row_major);
  }
}

// Row statistics of the query tile at q0 into st (m, 1/l, dsum; 64 each),
// zero for rows past sq.
__device__ __forceinline__ void load_stats(float* st, const float* stats, size_t bh,
                                           size_t plane, int q0, int sq) {
  if (threadIdx.x < AQ) {
    const int qi = q0 + threadIdx.x;
    const bool in = qi < sq;
    const size_t at = bh * sq + qi;
    st[threadIdx.x] = in ? stats[at] : 0.0f;
    st[AQ + threadIdx.x] = in ? stats[plane + at] : 0.0f;
    st[2 * AQ + threadIdx.x] = in ? stats[2 * plane + at] : 0.0f;
  }
}

// P and dS of this warp's 16 rows from its rows of the S and dP tiles; pb
// may be null (the dQ kernel needs dS only).
__device__ __forceinline__ void p_ds_rows(const float* ss, const float* dps,
                                          const float* st, bf16* pb, bf16* dsb,
                                          int wrow, int lane, int q0, int k0, int sq,
                                          int kv_len, int causal) {
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int row = wrow + r, qi = q0 + row;
    const float m = st[row], li = st[AQ + row], dsum = st[2 * AQ + row];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c = lane + 32 * h2;
      const float p = visible(qi, k0 + c, sq, kv_len, causal)
                          ? __expf(ss[row * ALDS + c] - m) * li : 0.0f;
      dsb[row * ALD + c] = f2bf(p * (dps[row * ALDS + c] - dsum));
      if (pb) pb[row * ALD + c] = f2bf(p);
    }
  }
}

// Store this warp's four 16x16 accumulators (16 rows x 64) through cs and
// write the rows below n_rows to out (bf16, row pitch ADH).
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[ADH / 16], float* cs,
    bf16* out, int row0, int n_rows, int wrow, int lane) {
#pragma unroll
  for (int j = 0; j < ADH / 16; ++j)
    wmma::store_matrix_sync(cs + wrow * ALDS + j * 16, acc[j], ALDS, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int ri = row0 + wrow + r;
    if (ri < n_rows) {
      out[(size_t)ri * ADH + lane] = f2bf(cs[(wrow + r) * ALDS + lane]);
      out[(size_t)ri * ADH + lane + 32] = f2bf(cs[(wrow + r) * ALDS + lane + 32]);
    }
  }
}

__global__ void __launch_bounds__(128)
bwd_stats_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ g,
                 float* __restrict__ stats, int n_heads, int sq, int skv, int kv_len,
                 int causal, size_t plane) {
  extern __shared__ __align__(128) char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + AQ * ALD;
  bf16* ks = gs + AQ * ALD;
  bf16* vs = ks + AK * ALD;
  float* ss = reinterpret_cast<float*>(vs + AK * ALD);
  float* dps = ss + AQ * ALDS;

  const int q0 = blockIdx.x * AQ;
  const size_t bh = (size_t)blockIdx.z * n_heads + blockIdx.y;
  const bf16* kh = k + bh * skv * ADH;
  const bf16* vh = v + bh * skv * ADH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = warp * 16;

  load_tile(qs, q + bh * sq * ADH, q0, sq);
  load_tile(gs, g + bh * sq * ADH, q0, sq);

  float m_run[16], l_run[16], u_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.0f;
    u_run[r] = 0.0f;
  }
  const int kend = causal ? min(kv_len, q0 + AQ) : kv_len;
  for (int k0 = 0; k0 < kend; k0 += AK) {
    load_tile(ks, kh, k0, skv);
    load_tile(vs, vh, k0, skv);
    __syncthreads();
    warp_abt(qs + wrow * ALD, ks, ss + wrow * ALDS);
    warp_abt(gs + wrow * ALD, vs, dps + wrow * ALDS);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = wrow + r, qi = q0 + row;
      const bool ok0 = visible(qi, k0 + lane, sq, kv_len, causal);
      const bool ok1 = visible(qi, k0 + lane + 32, sq, kv_len, causal);
      const float s0 = ss[row * ALDS + lane], s1 = ss[row * ALDS + lane + 32];
      const float tmax = warp_max(fmaxf(ok0 ? s0 : -INFINITY, ok1 ? s1 : -INFINITY));
      const float m_new = fmaxf(m_run[r], tmax);
      if (m_new == -INFINITY) continue;      // warp-uniform: no visible key yet
      const float p0 = ok0 ? __expf(s0 - m_new) : 0.0f;
      const float p1 = ok1 ? __expf(s1 - m_new) : 0.0f;
      const float alpha = m_run[r] == -INFINITY ? 0.0f : __expf(m_run[r] - m_new);
      const float pd = p0 * dps[row * ALDS + lane] + p1 * dps[row * ALDS + lane + 32];
      l_run[r] = l_run[r] * alpha + warp_sum(p0 + p1);
      u_run[r] = u_run[r] * alpha + warp_sum(pd);
      m_run[r] = m_new;
    }
    __syncthreads();
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qi = q0 + wrow + r;
      if (qi < sq) {
        const size_t at = bh * sq + qi;
        const float li = l_run[r] > 0.0f ? 1.0f / l_run[r] : 0.0f;
        stats[at] = m_run[r];
        stats[plane + at] = li;
        stats[2 * plane + at] = u_run[r] * li;
      }
    }
  }
}

__global__ void __launch_bounds__(128)
bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ g,
                const float* __restrict__ stats, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int n_heads, int sq, int skv, int kv_len,
                int causal, size_t plane) {
  extern __shared__ __align__(128) char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + AK * ALD;
  bf16* qs = vs + AK * ALD;
  bf16* gs = qs + AQ * ALD;
  bf16* pb = gs + AQ * ALD;
  bf16* dsb = pb + AQ * ALD;
  float* ss = reinterpret_cast<float*>(dsb + AQ * ALD);
  float* dps = ss + AQ * ALDS;
  __shared__ float st[3 * AQ];

  const int k0 = blockIdx.x * AK;
  const size_t bh = (size_t)blockIdx.z * n_heads + blockIdx.y;
  const bf16* qh = q + bh * sq * ADH;
  const bf16* gh = g + bh * sq * ADH;
  bf16* dkh = dk + bh * skv * ADH;
  bf16* dvh = dv + bh * skv * ADH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = warp * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dk[ADH / 16], acc_dv[ADH / 16];
#pragma unroll
  for (int j = 0; j < ADH / 16; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.0f);
    wmma::fill_fragment(acc_dv[j], 0.0f);
  }
  if (k0 < kv_len) {     // block-uniform; keys >= kv_len get exact zeros
    load_tile(ks, k + bh * skv * ADH, k0, skv);
    load_tile(vs, v + bh * skv * ADH, k0, skv);
    for (int q0 = causal ? k0 : 0; q0 < sq; q0 += AQ) {
      load_tile(qs, qh, q0, sq);
      load_tile(gs, gh, q0, sq);
      load_stats(st, stats, bh, plane, q0, sq);
      __syncthreads();
      warp_abt(qs + wrow * ALD, ks, ss + wrow * ALDS);
      warp_abt(gs + wrow * ALD, vs, dps + wrow * ALDS);
      __syncwarp();
      p_ds_rows(ss, dps, st, pb, dsb, wrow, lane, q0, k0, sq, kv_len, causal);
      __syncthreads();
      // This warp's 16 keys: dV += P^T dO, dK += dS^T Q over the 64 queries.
#pragma unroll
      for (int kk = 0; kk < AQ / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pt, dst;
        wmma::load_matrix_sync(pt, pb + kk * 16 * ALD + wrow, ALD);
        wmma::load_matrix_sync(dst, dsb + kk * 16 * ALD + wrow, ALD);
#pragma unroll
        for (int j = 0; j < ADH / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> gb, qb;
          wmma::load_matrix_sync(gb, gs + kk * 16 * ALD + j * 16, ALD);
          wmma::mma_sync(acc_dv[j], pt, gb, acc_dv[j]);
          wmma::load_matrix_sync(qb, qs + kk * 16 * ALD + j * 16, ALD);
          wmma::mma_sync(acc_dk[j], dst, qb, acc_dk[j]);
        }
      }
      __syncthreads();
    }
  }
  store_rows(acc_dv, ss, dvh, k0, skv, wrow, lane);
  store_rows(acc_dk, dps, dkh, k0, skv, wrow, lane);
}

__global__ void __launch_bounds__(128)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ g,
              const float* __restrict__ stats, bf16* __restrict__ dq, int n_heads,
              int sq, int skv, int kv_len, int causal, size_t plane) {
  extern __shared__ __align__(128) char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + AQ * ALD;
  bf16* ks = gs + AQ * ALD;
  bf16* vs = ks + AK * ALD;
  bf16* dsb = vs + AK * ALD;
  float* ss = reinterpret_cast<float*>(dsb + AQ * ALD);
  float* dps = ss + AQ * ALDS;
  __shared__ float st[3 * AQ];

  const int q0 = blockIdx.x * AQ;
  const size_t bh = (size_t)blockIdx.z * n_heads + blockIdx.y;
  const bf16* kh = k + bh * skv * ADH;
  const bf16* vh = v + bh * skv * ADH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = warp * 16;

  load_tile(qs, q + bh * sq * ADH, q0, sq);
  load_tile(gs, g + bh * sq * ADH, q0, sq);
  load_stats(st, stats, bh, plane, q0, sq);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[ADH / 16];
#pragma unroll
  for (int j = 0; j < ADH / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  const int kend = causal ? min(kv_len, q0 + AQ) : kv_len;
  for (int k0 = 0; k0 < kend; k0 += AK) {
    load_tile(ks, kh, k0, skv);
    load_tile(vs, vh, k0, skv);
    __syncthreads();
    warp_abt(qs + wrow * ALD, ks, ss + wrow * ALDS);
    warp_abt(gs + wrow * ALD, vs, dps + wrow * ALDS);
    __syncwarp();
    p_ds_rows(ss, dps, st, nullptr, dsb, wrow, lane, q0, k0, sq, kv_len, causal);
    __syncwarp();
    // dQ += dS K for this warp's 16 queries.
#pragma unroll
    for (int kk = 0; kk < AK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> da;
      wmma::load_matrix_sync(da, dsb + wrow * ALD + kk * 16, ALD);
#pragma unroll
      for (int j = 0; j < ADH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kb;
        wmma::load_matrix_sync(kb, ks + kk * 16 * ALD + j * 16, ALD);
        wmma::mma_sync(acc[j], da, kb, acc[j]);
      }
    }
    __syncthreads();
  }
  store_rows(acc, ss, dq + bh * sq * ADH, q0, sq, wrow, lane);
}

}  // namespace
}  // namespace wm

extern "C" int wm_attention_bwd(const void* q, const void* k, const void* v,
                                const void* g, void* dq, void* dk, void* dv,
                                void* stats, int b, int h, int sq, int skv, int dh,
                                int kv_len, int causal, void* stream) {
  using namespace wm;
  if (dh != ADH || kv_len < 1 || kv_len > skv) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t plane = (size_t)b * h * sq;
  const dim3 grid_q((sq + AQ - 1) / AQ, h, b), grid_k((skv + AK - 1) / AK, h, b);
  const bf16 *q_ = (const bf16*)q, *k_ = (const bf16*)k, *v_ = (const bf16*)v,
             *g_ = (const bf16*)g;
  float* s_ = (float*)stats;
  cudaFuncSetAttribute(bwd_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       BWD_SMEM_STATS);
  cudaFuncSetAttribute(bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       BWD_SMEM_DKDV);
  cudaFuncSetAttribute(bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       BWD_SMEM_DQ);
  bwd_stats_kernel<<<grid_q, 128, BWD_SMEM_STATS, st>>>(q_, k_, v_, g_, s_, h, sq, skv,
                                                        kv_len, causal, plane);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_kernel<<<grid_k, 128, BWD_SMEM_DKDV, st>>>(q_, k_, v_, g_, s_, (bf16*)dk,
                                                       (bf16*)dv, h, sq, skv, kv_len,
                                                       causal, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_kernel<<<grid_q, 128, BWD_SMEM_DQ, st>>>(q_, k_, v_, g_, s_, (bf16*)dq, h, sq,
                                                  skv, kv_len, causal, plane);
  return (int)cudaGetLastError();
}

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
