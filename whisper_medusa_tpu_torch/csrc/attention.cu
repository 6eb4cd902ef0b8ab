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
//    load and never stored;
//  * where ``lse`` is not null (training), each query row below Sq also
//    writes its f32 log-sum-exp m + log(l) from the online softmax's running
//    max m and sum l, which K9 reads instead of recomputing the softmax.
//    Serving passes null and runs the same arithmetic as before.
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
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int n_heads, int sq, int skv, int kv_len,
                 int causal) {
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
      // m_run and l_run are warp-uniform (warp_max / warp_sum).
      if (lse != nullptr && lane == 0) lse[bh * sq + qi] = m_run[r] + logf(l_run[r]);
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
// sequential axis, so on Hopper it is one pass over the key blocks that
// starts from the forward's statistics (K1 writes each row's log-sum-exp):
//
//  (a) bwd_rows_kernel: Dsum[row] = sum_d dO * O in f32 from the forward's
//      bf16 output O (the identity sum_k P * dP = dO . O; no tensor core),
//      and zeroes the f32 dQ accumulator;
//  (b) bwd_main_kernel, one CTA (8 warps) per (b, h, 128 keys), each warp
//      owning 16 keys.  K and V of the block are held in registers (as
//      mma A fragments) and in shared memory for the whole loop; the query
//      tiles the masks leave visible (causal: from the key block's first
//      key on) stream through a two-stage cp.async ring of Q, dO, LSE and
//      Dsum, the next tile's copy in flight during this tile's products.
//      Per 64-query tile, five products on mma.sync m16n8k16 (bf16 in, f32
//      accumulate), operands from ldmatrix on padded shared tiles:
//        S^T = K Q^T;  P^T = exp(S^T - LSE), masked to 0;
//        dV += bf16(P^T) dO;  dP^T = V dO^T;  dS^T = bf16(P^T (dP^T - Dsum));
//        dK += dS^T Q;  dQ += dS K.
//      S^T and dP^T come out in accumulator layout and become P^T and dS^T
//      in registers, which feed dV and dK as A operands; only dS^T goes to
//      shared memory, once per tile, for dQ: each warp sums 16 queries x 32
//      head columns over the block's 128 keys and adds them into the f32
//      accumulator with float4 atomicAdd (vector reductions).  The dQ
//      atomics, not the products, take most of this kernel's time, hence
//      128 keys a CTA (one read-modify-write of dQ per 128 keys) and four
//      floats an atomic.  dK and dV stay in registers for the whole loop
//      and are written once;
//  (c) bwd_cast_kernel: dQ f32 -> bf16.
//
// The casts are the TPU kernel's: dS to bf16 before both of its products, P
// to bf16 for dV, every product accumulated in f32.  Masks (key < kv_len,
// causality, the ragged edges of both sequences) are applied in-kernel; dK
// and dV rows at keys >= kv_len come out exactly 0, and key blocks wholly
// past kv_len write zeros and compute nothing.  Determinism: dK and dV are
// written once each and are bitwise the same from run to run; dQ is summed
// with atomics in an order that changes from run to run, so its last bits
// may differ between two runs on the same inputs.
//
// Bound on H100: at the cross-attention's 224 x 1500 and the decoder's
// 224 x 224 by bytes (q, k, v, dO, O and the log-sum-exp read once, dq, dk,
// dv written once), at
// the encoder's 1500 x 1500 by tensor-core operations (5 products of
// 2 Sq Skv Dh per head).  Next, for K1 and K9 together: wgmma on 64-row
// warpgroup tiles and a TMA ring with mbarriers in place of mma.sync and
// cp.async.
// ---------------------------------------------------------------------------

constexpr int BNW = 8;                  // warps per CTA, 16 keys each
constexpr int BTHREADS = 32 * BNW;
constexpr int BKB = 16 * BNW;           // keys per CTA
constexpr int BQT = 64;                 // queries per tile
constexpr int BLD = ADH + 8;            // bf16 smem pitch: ldmatrix rows hit 8 banks
constexpr int BTILE = 64 * BLD;         // one 64-row bf16 tile, in elements
// K, V and dS^T (BKB rows each), two stages of Q and dO (bf16); two stages
// of LSE and Dsum (f32).
constexpr int BWD_SMEM = (3 * BKB * BLD + 4 * BTILE) * 2 + 4 * BQT * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ROWS x 64 bf16 (rows row0.. of a (n_rows, 64) array) into a padded shared
// tile by cp.async, rows past n_rows zero-filled.
template <int ROWS>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, int row0,
                                           int n_rows) {
#pragma unroll
  for (int j = 0; j < ROWS * 8 / BTHREADS; ++j) {
    const int i = threadIdx.x + BTHREADS * j, r = i >> 3, c = (i & 7) * 8;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * BLD + c, src + (size_t)(in ? row0 + r : 0) * ADH + c, in);
  }
}

// 64 f32 row values (LSE or Dsum) from row0, zero past n_rows.
__device__ __forceinline__ void rows_async(float* dst, const float* src, int row0,
                                           int n_rows) {
  if (threadIdx.x < BQT) {
    const int r = row0 + (int)threadIdx.x;
    cp_async4(dst + threadIdx.x, src + (r < n_rows ? r : 0), r < n_rows);
  }
}

// Sixteen rows of a 64-column product for this warp: acc[j] (16 x 8, tile j
// of the 64 columns) += a (16 x 64, four A fragments) . b^T, b the 64 x 64
// shared tile whose rows are the columns (ldmatrix without .trans).
__device__ __forceinline__ void warp_abt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                         const bf16* b, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; kk += 2) {
      uint32_t f[4];
      ldsm_x4(f, b + (8 * j + (lane & 7)) * BLD + kk * 16 + (lane >> 3) * 8);
      mma16816(acc[j], a[kk], f[0], f[1]);
      mma16816(acc[j], a[kk + 1], f[2], f[3]);
    }
  }
}

// acc[n] (16 x 8, tile n of 64 columns) += a (16 x 64, four A fragments) .
// b, b the 64 x 64 shared tile stored (k, n) row-major (ldmatrix .trans).
__device__ __forceinline__ void warp_ab(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                        const bf16* b, int lane) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t f[4];
      ldsm_x4_t(f, b + (16 * c + (lane & 7) + ((lane >> 3) & 1) * 8) * BLD + 8 * n +
                       (lane >> 4) * 8);
      mma16816(acc[n], a[c], f[0], f[1]);
      mma16816(acc[n + 1], a[c], f[2], f[3]);
    }
  }
}

// Accumulators of a 16 x 64 product (8 tiles of 16 x 8) as four bf16 A
// fragments of 16 x 16 (the m16n8k16 C layout is the A layout, two tiles
// per fragment).
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&acc)[8][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a[c][0] = pack_bf2(acc[2 * c][0], acc[2 * c][1]);
    a[c][1] = pack_bf2(acc[2 * c][2], acc[2 * c][3]);
    a[c][2] = pack_bf2(acc[2 * c + 1][0], acc[2 * c + 1][1]);
    a[c][3] = pack_bf2(acc[2 * c + 1][2], acc[2 * c + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
}

// (a) Dsum = sum_d dO * O per row (8 lanes a row), and dq_acc rows zeroed.
__global__ void __launch_bounds__(256)
bwd_rows_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g,
                float* __restrict__ dsum, float* __restrict__ dq_acc, int rows) {
  const int row = blockIdx.x * 32 + (threadIdx.x >> 3), part = threadIdx.x & 7;
  float s = 0.0f;
  if (row < rows) {
    const size_t at = (size_t)row * ADH + part * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + at);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + at);
    const bf16* ob = reinterpret_cast<const bf16*>(&ov);
    const bf16* gb = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += bf2f(ob[i]) * bf2f(gb[i]);
    float4* z = reinterpret_cast<float4*>(dq_acc + at);
    z[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    z[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && part == 0) dsum[row] = s;
}

// (b) one CTA per (b, h, BKB keys).
__global__ void __launch_bounds__(BTHREADS)
bwd_main_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ g,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                int n_heads, int sq, int skv, int kv_len, int causal) {
  extern __shared__ __align__(128) char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BKB * BLD;
  bf16* dst = vs + BKB * BLD;         // dS^T (keys x queries)
  bf16* qs = dst + BKB * BLD;         // two stages
  bf16* gs = qs + 2 * BTILE;          // two stages
  float* ls = reinterpret_cast<float*>(gs + 2 * BTILE);   // two stages of LSE
  float* dss = ls + 2 * BQT;                          // two stages of Dsum

  const int k0 = blockIdx.x * BKB;
  const size_t bh = (size_t)blockIdx.z * n_heads + blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;     // accumulator row group, column pair
  const int kr0 = k0 + 16 * warp + gq, kr1 = kr0 + 8;   // this lane's two keys

  float acc_dk[8][4], acc_dv[8][4];
  zero(acc_dk);
  zero(acc_dv);
  const int q_begin = causal ? k0 : 0;
  const int ntiles = k0 < kv_len ? max(0, (sq - q_begin + BQT - 1) / BQT) : 0;
  if (ntiles > 0) {     // block-uniform; keys >= kv_len get exact zeros
    const bf16* qh = q + bh * sq * ADH;
    const bf16* gh = g + bh * sq * ADH;
    const float* lh = lse + bh * sq;
    const float* dh = dsum + bh * sq;
    tile_async<BKB>(ks, k + bh * skv * ADH, k0, skv);
    tile_async<BKB>(vs, v + bh * skv * ADH, k0, skv);
    tile_async<BQT>(qs, qh, q_begin, sq);
    tile_async<BQT>(gs, gh, q_begin, sq);
    rows_async(ls, lh, q_begin, sq);
    rows_async(dss, dh, q_begin, sq);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // This warp's 16 keys of K and V as A fragments, held for the loop.
    uint32_t kf[4][4], vf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int r = 16 * warp + (lane & 15), c = kk * 16 + (lane >> 4) * 8;
      ldsm_x4(kf[kk], ks + r * BLD + c);
      ldsm_x4(vf[kk], vs + r * BLD + c);
    }
    float* dqh = dq_acc + bh * sq * ADH;

    for (int it = 0; it < ntiles; ++it) {
      const int q0 = q_begin + it * BQT, st = it & 1;
      if (it + 1 < ntiles) {      // the next tile's copy overlaps this tile's work
        const int nx = st ^ 1;
        tile_async<BQT>(qs + nx * BTILE, qh, q0 + BQT, sq);
        tile_async<BQT>(gs + nx * BTILE, gh, q0 + BQT, sq);
        rows_async(ls + nx * BQT, lh, q0 + BQT, sq);
        rows_async(dss + nx * BQT, dh, q0 + BQT, sq);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* qt = qs + st * BTILE;
      const bf16* gt = gs + st * BTILE;
      const float* lt = ls + st * BQT;
      const float* dt = dss + st * BQT;

      // S^T = K Q^T, then P^T = exp(S^T - LSE) where visible, else 0.
      float p[8][4];
      zero(p);
      warp_abt(p, kf, qt, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tq + (e & 1), qi = q0 + col;
          const int kj = e < 2 ? kr0 : kr1;
          const bool ok = qi < sq && kj < kv_len && (!causal || kj <= qi);
          p[j][e] = ok ? __expf(p[j][e] - lt[col]) : 0.0f;
        }
      }
      uint32_t fa[4][4];
      to_a(fa, p);                           // bf16(P^T)
      warp_ab(acc_dv, fa, gt, lane);         // dV += P^T dO

      // dP^T = V dO^T, then dS^T = bf16(P^T (dP^T - Dsum)).
      float dp[8][4];
      zero(dp);
      warp_abt(dp, vf, gt, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = p[j][e] * (dp[j][e] - dt[8 * j + 2 * tq + (e & 1)]);
      to_a(fa, dp);                          // bf16(dS^T)
      warp_ab(acc_dk, fa, qt, lane);         // dK += dS^T Q

      // dS^T to shared memory (this warp's 16 key rows), then dQ += dS K: warp
      // w takes queries 16 (w % 4).. and NT n-tiles of 8 head columns over
      // all BKB keys, and adds them into the f32 accumulator four floats a
      // lane (lane pairs swap halves so that each holds 4 adjacent columns).
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bf16* r0p = dst + (16 * warp + gq) * BLD + 16 * c + 2 * tq;
        *reinterpret_cast<uint32_t*>(r0p) = fa[c][0];
        *reinterpret_cast<uint32_t*>(r0p + 8 * BLD) = fa[c][1];
        *reinterpret_cast<uint32_t*>(r0p + 8) = fa[c][2];
        *reinterpret_cast<uint32_t*>(r0p + 8 * BLD + 8) = fa[c][3];
      }
      __syncthreads();
      constexpr int NT = 8 * 4 / BNW;
      const int qg = warp & 3, c0 = (warp >> 2) * 8 * NT;
      float dq[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < BKB / 16; ++kc) {
        uint32_t da[4];
        const int mi = lane >> 3;
        ldsm_x4_t(da, dst + (16 * kc + (lane & 7) + (mi >> 1) * 8) * BLD + 16 * qg +
                          (mi & 1) * 8);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t f[4];
          ldsm_x4_t(f, ks + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) * BLD + c0 +
                           8 * n + (lane >> 4) * 8);
          mma16816(dq[n], da, f[0], f[1]);
          mma16816(dq[n + 1], da, f[2], f[3]);
        }
      }
      const int qa = q0 + 16 * qg + gq, qb = qa + 8;
      const bool odd = tq & 1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? dq[n][0] : dq[n][2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? dq[n][1] : dq[n][3], 1);
        const int row = odd ? qb : qa;
        const int col = c0 + 8 * n + 2 * (tq & 2);
        const float4 val = odd ? make_float4(r0, r1, dq[n][2], dq[n][3])
                               : make_float4(dq[n][0], dq[n][1], r0, r1);
        if (row < sq) atomicAdd(reinterpret_cast<float4*>(dqh + (size_t)row * ADH + col), val);
      }
      __syncthreads();     // this stage and dS^T are free for the next tiles
    }
  }
  bf16* dkh = dk + bh * skv * ADH;
  bf16* dvh = dv + bh * skv * ADH;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * tq;
    if (kr0 < skv) {
      *reinterpret_cast<uint32_t*>(dkh + (size_t)kr0 * ADH + col) =
          pack_bf2(acc_dk[n][0], acc_dk[n][1]);
      *reinterpret_cast<uint32_t*>(dvh + (size_t)kr0 * ADH + col) =
          pack_bf2(acc_dv[n][0], acc_dv[n][1]);
    }
    if (kr1 < skv) {
      *reinterpret_cast<uint32_t*>(dkh + (size_t)kr1 * ADH + col) =
          pack_bf2(acc_dk[n][2], acc_dk[n][3]);
      *reinterpret_cast<uint32_t*>(dvh + (size_t)kr1 * ADH + col) =
          pack_bf2(acc_dv[n][2], acc_dv[n][3]);
    }
  }
}

// (c) dQ f32 -> bf16, four values a thread.
__global__ void __launch_bounds__(256)
bwd_cast_kernel(const float* __restrict__ src, bf16* __restrict__ out, int n4) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n4) {
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    reinterpret_cast<uint2*>(out)[i] = make_uint2(pack_bf2(x.x, x.y), pack_bf2(x.z, x.w));
  }
}

}  // namespace
}  // namespace wm

// q, g, o, dq (B, H, Sq, 64) and k, v, dk, dv (B, H, Skv, 64) bf16; lse (B, H,
// Sq) f32 from K1; scratch dsum (B, H, Sq) and dq_acc (B, H, Sq, 64) f32.
extern "C" int wm_attention_bwd(const void* q, const void* k, const void* v,
                                const void* o, const void* lse, const void* g, void* dq,
                                void* dk, void* dv, void* dsum, void* dq_acc, int b, int h,
                                int sq, int skv, int dh, int kv_len, int causal,
                                void* stream) {
  using namespace wm;
  if (dh != ADH || kv_len < 1 || kv_len > skv || sq < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = b * h * sq;
  bwd_rows_kernel<<<(rows + 31) / 32, 256, 0, st>>>((const bf16*)o, (const bf16*)g,
                                                   (float*)dsum, (float*)dq_acc, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Per launch: the attribute belongs to the current device's context.
  cudaFuncSetAttribute(bwd_main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       BWD_SMEM);
  bwd_main_kernel<<<dim3((skv + BKB - 1) / BKB, h, b), BTHREADS, BWD_SMEM, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)lse,
      (const float*)dsum, (float*)dq_acc, (bf16*)dk, (bf16*)dv, h, sq, skv, kv_len, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n4 = rows * (ADH / 4);
  bwd_cast_kernel<<<(n4 + 255) / 256, 256, 0, st>>>((const float*)dq_acc, (bf16*)dq, n4);
  return (int)cudaGetLastError();
}

// lse: (B, H, Sq) f32, or null (serving).
extern "C" int wm_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int b, int h, int sq, int skv,
                                int dh, int kv_len, int causal, void* stream) {
  using namespace wm;
  if (dh != ADH) return (int)cudaErrorInvalidValue;
  // Per launch: the attribute belongs to the current device's context.
  cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       ATTN_SMEM);
  dim3 grid((sq + AQ - 1) / AQ, h, b);
  attention_kernel<<<grid, 128, ATTN_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, h, sq,
      skv, kv_len, causal);
  return (int)cudaGetLastError();
}
