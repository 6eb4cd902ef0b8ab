// K1 — full-sequence attention forward in (B, H, S, Dh=64) layout.
//
// Replaces whisper_medusa_tpu/ops/attention.py::_attention_kernel (TPU,
// launched by _attention_pallas).  The TPU kernel keeps a head's whole K/V
// resident and runs a one-pass softmax; on Hopper 1536 x 64 bf16 K plus V
// (384 KB) exceeds an SM's 227 KB of shared memory, so this is a flash-style
// forward on wgmma fed by a TMA ring (hopper.cuh), close to FlashAttention-3's:
//
//  * one CTA per (batch, head, 128-query block): two consumer warpgroups of
//    64 query rows each (warps 0-7) and one producer warp (warp 8);
//  * the producer issues TMA loads from 3-D tensor maps over (B*H, S, 64),
//    so rows past S read as zeros and never as the next head's rows: the
//    CTA's 128 Q rows once, then 64-key tiles of K and V through a ring of
//    A_STAGES stages, each stage a "full" mbarrier (TMA bytes) and an "empty"
//    one (one arrival per consumer warp once its products have read it);
//  * per key tile a consumer warpgroup runs S = Q K^T as wgmma m64n64k16
//    with both operands in shared memory (128-byte swizzle, K K-major), the
//    online softmax in f32 on the accumulator registers (a row lives in the
//    4 lanes of a quad: 2 shuffles for its max; the row sums stay per lane
//    until the end), P rounded to bf16 in registers as the A operand of
//    O += P V (wgmma with V from shared memory, MN-major);
//  * masks: key < kv_len, plus key <= query when causal; key tiles past the
//    last visible key are not loaded, and a warpgroup skips the tiles past
//    its own last query;
//  * O is normalised by 1/l, rounded to bf16 and stored from registers,
//    rows past Sq dropped; where ``lse`` is not null (training), each row
//    also writes its f32 log-sum-exp m + log(l), which K9 reads.
//
// A (b, h, query block)'s arithmetic does not depend on B or on any other
// block: no split over keys, no atomics, so two runs give the same bits and
// example i of a batch gets its batch-of-one output.
//
// Waves: at (1, 20, 1500, 64) 12 x 20 = 240 CTAs; two fit on an SM (288
// threads at <= 112 registers, 83 KB of shared memory each), so the grid is
// one wave of 264 slots on 132 SMs; at B = 8, 1920 CTAs in 7.3 waves.
//
// Bound on H100: tensor-core operations, not bytes: one encoder layer (20
// heads of 1500 x 1500 x 64, QK^T and PV) is 11.5 GFLOP against 15 MB of
// q/k/v/out.
#include "common.cuh"
#include "hopper.cuh"

namespace wm {
namespace {

constexpr int AQ = 128;                  // queries per CTA (2 warpgroups x 64)
constexpr int AK = 64;                   // keys per tile
constexpr int ADH = 64;                  // head dim: one 128-byte row
constexpr int A_STAGES = 4;              // K/V ring depth
constexpr int A_THREADS = 288;           // 8 consumer warps + 1 producer warp
constexpr int A_TILE = 64 * ADH * 2;     // one 64-row bf16 tile, bytes
constexpr int ATTN_SMEM = 1024 + 2 * A_TILE + A_STAGES * 2 * A_TILE + 8 * (2 * A_STAGES + 1);
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(A_THREADS, 2)
attention_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                 float* __restrict__ lse, int sq, int kv_len, int causal) {
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* qs = smem;                               // 128 rows: 2 x A_TILE
  char* kv = smem + 2 * A_TILE;                  // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(kv + A_STAGES * 2 * A_TILE);
  uint64_t* empty = full + A_STAGES;
  uint64_t* qbar = empty + A_STAGES;

  const int q0 = blockIdx.x * AQ;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int kend = causal ? min(kv_len, q0 + AQ) : kv_len;
  const int ntiles = (kend + AK - 1) / AK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < A_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {   // producer
    if (lane == 0) {
      mbar_arrive_tx(qbar, 2 * A_TILE);
      tma_load_3d(qs, &mq, qbar, 0, q0, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % A_STAGES;
        if (t >= A_STAGES) mbar_wait(&empty[st], ((t / A_STAGES) & 1) ^ 1);
        char* kt = kv + st * 2 * A_TILE;
        mbar_arrive_tx(&full[st], 2 * A_TILE);
        tma_load_3d(kt, &mk, &full[st], 0, t * AK, bh);
        tma_load_3d(kt + A_TILE, &mv, &full[st], 0, t * AK, bh);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns queries qw .. qw + 63; this lane holds rows
  // r0 and r1 = r0 + 8 of them, and columns 8 j + 2 (lane % 4) (+ 1).
  const int wg = warp >> 2;
  const int qw = q0 + 64 * wg;
  const int r0 = qw + 16 * (warp & 3) + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  float oacc[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  const uint64_t qdesc = sw128_desc(smem_addr(qs + wg * A_TILE));

  mbar_wait(qbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % A_STAGES, k0 = t * AK;
    mbar_wait(&full[st], (t / A_STAGES) & 1);
    if (!causal || k0 <= qw + 63) {     // warpgroup-uniform
      const uint32_t kaddr = smem_addr(kv + st * 2 * A_TILE);
      const uint64_t kdesc = sw128_desc(kaddr), vdesc = sw128_desc(kaddr + A_TILE);
      // S = Q K^T: four k16 steps of 32 bytes along the swizzled rows.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ADH / 16; ++kk)
        wgmma_ss<0, 0>(s, qdesc + 2 * kk, kdesc + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);

      if (k0 + AK > kv_len || (causal && k0 + AK - 1 > qw)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
          const int row = (i & 2) ? r1 : r0;
          if (key >= kv_len || (causal && key > row)) s[i] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, s[i]);
        else mx0 = fmaxf(mx0, s[i]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // A row with no visible key yet keeps m = -inf, p = 0 and alpha = 1.
      const float b0 = mn0 == -INFINITY ? 0.0f : mn0 * LOG2E;
      const float b1 = mn1 == -INFINITY ? 0.0f : mn1 * LOG2E;
      const float a0 = mn0 == -INFINITY ? 1.0f : ex2(m0 * LOG2E - b0);
      const float a1 = mn1 == -INFINITY ? 1.0f : ex2(m1 * LOG2E - b1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) {
          s[i] = ex2(fmaf(s[i], LOG2E, -b1));
          ps1 += s[i];
        } else {
          s[i] = ex2(fmaf(s[i], LOG2E, -b0));
          ps0 += s[i];
        }
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
      reg_fence(oacc);
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[i] *= (i & 2) ? a1 : a0;

      // O += P V: P as bf16 A fragments, keys 16 c .. 16 c + 15 per step;
      // V rows advance 16 x 128 bytes per step.
      uint32_t pa[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pa[c][0] = pack_bf2(s[8 * c + 0], s[8 * c + 1]);
        pa[c][1] = pack_bf2(s[8 * c + 2], s[8 * c + 3]);
        pa[c][2] = pack_bf2(s[8 * c + 4], s[8 * c + 5]);
        pa[c][3] = pack_bf2(s[8 * c + 6], s[8 * c + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) wgmma_rs<1>(oacc, pa[c], vdesc + 128 * c, 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(oacc);
    }
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // Row sums across the quad, then the normalised output.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  bf16* oh = o + (size_t)bh * sq * ADH;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + cq;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r0 * ADH + col) =
          pack_bf2(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r1 * ADH + col) =
          pack_bf2(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
  }
  if (lse != nullptr && (lane & 3) == 0) {
    if (r0 < sq) lse[(size_t)bh * sq + r0] = m0 + logf(l0);
    if (r1 < sq) lse[(size_t)bh * sq + r1] = m1 + logf(l1);
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
//      head columns over the block's 128 keys and stores them, four floats
//      a lane, as this key block's f32 dQ partial (one slot per 128-key
//      block: (Skv / 128, B, H, Sq, 64) f32 of scratch, 184 MB at the
//      encoder's (2, 20, 1500^2)).  dK and dV stay in registers for the
//      whole loop and are written once;
//  (c) bwd_cast_kernel: dQ = the partials of the key blocks that reach the
//      row (below kv_len, and at or below the row when causal) added in
//      key-block order, then rounded to bf16.
//
// The casts are the TPU kernel's: dS to bf16 before both of its products, P
// to bf16 for dV, every product accumulated in f32.  Masks (key < kv_len,
// causality, the ragged edges of both sequences) are applied in-kernel; dK
// and dV rows at keys >= kv_len come out exactly 0, and key blocks wholly
// past kv_len write zeros and compute nothing.  Determinism: dK and dV are
// written once each, and dQ is one fixed-order sum of partials each written
// once, so all three are bitwise the same from run to run (the JAX kernel
// writes dQ once per query block); no atomics.
//
// Bound on H100: at the cross-attention's 224 x 1500 and the decoder's
// 224 x 224 by bytes (q, k, v, dO, O and the log-sum-exp read once, dq, dk,
// dv written once), at
// the encoder's 1500 x 1500 by tensor-core operations (5 products of
// 2 Sq Skv Dh per head).  Next: K1's pieces (hopper.cuh: wgmma on 64-row
// warpgroup tiles, a TMA ring with mbarriers) in place of mma.sync and
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
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
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
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

// (a) Dsum = sum_d dO * O per row (8 lanes a row).
__global__ void __launch_bounds__(256)
bwd_rows_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g,
                float* __restrict__ dsum, int rows) {
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
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && part == 0) dsum[row] = s;
}

// (b) one CTA per (b, h, BKB keys); dq_part (Skv / BKB, B, H, Sq, 64) f32.
__global__ void __launch_bounds__(BTHREADS)
bwd_main_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ g,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                float* __restrict__ dq_part, bf16* __restrict__ dk, bf16* __restrict__ dv,
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
    // This key block's dQ partial of head bh.
    float* dqh = dq_part + ((size_t)blockIdx.x * gridDim.z * n_heads + bh) * sq * ADH;

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

      // dS^T to shared memory (this warp's 16 key rows), then dQ = dS K: warp
      // w takes queries 16 (w % 4).. and NT n-tiles of 8 head columns over
      // all BKB keys, and stores them into the block's partial four floats a
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
        if (row < sq) *reinterpret_cast<float4*>(dqh + (size_t)row * ADH + col) = val;
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

// (c) dQ = the key blocks' partials in key-block order, f32 -> bf16, four
// values a thread.  Row r (query r % sq) has partials from the blocks below
// kv_len, and when causal from those at or below the query; every other
// slot was never written.
__global__ void __launch_bounds__(256)
bwd_cast_kernel(const float* __restrict__ part, bf16* __restrict__ out, int n4, int sq,
                int kv_len, int causal) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n4) {
    const int qi = (i / (ADH / 4)) % sq;
    int nb = (kv_len + BKB - 1) / BKB;
    if (causal) nb = min(nb, qi / BKB + 1);
    const float4* p = reinterpret_cast<const float4*>(part);
    float4 x = p[i];
    for (int kb = 1; kb < nb; ++kb) {
      const float4 y = p[(size_t)kb * n4 + i];
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    reinterpret_cast<uint2*>(out)[i] = make_uint2(pack_bf2(x.x, x.y), pack_bf2(x.z, x.w));
  }
}

}  // namespace
}  // namespace wm

// q, g, o, dq (B, H, Sq, 64) and k, v, dk, dv (B, H, Skv, 64) bf16; lse (B, H,
// Sq) f32 from K1; scratch dsum (B, H, Sq) and dq_part (ceil(Skv / 128), B, H,
// Sq, 64) f32.
extern "C" int wm_attention_bwd(const void* q, const void* k, const void* v,
                                const void* o, const void* lse, const void* g, void* dq,
                                void* dk, void* dv, void* dsum, void* dq_part, int b, int h,
                                int sq, int skv, int dh, int kv_len, int causal,
                                void* stream) {
  using namespace wm;
  if (dh != ADH || kv_len < 1 || kv_len > skv || sq < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = b * h * sq;
  bwd_rows_kernel<<<(rows + 31) / 32, 256, 0, st>>>((const bf16*)o, (const bf16*)g,
                                                   (float*)dsum, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Per launch: the attribute belongs to the current device's context.
  cudaFuncSetAttribute(bwd_main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       BWD_SMEM);
  bwd_main_kernel<<<dim3((skv + BKB - 1) / BKB, h, b), BTHREADS, BWD_SMEM, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)lse,
      (const float*)dsum, (float*)dq_part, (bf16*)dk, (bf16*)dv, h, sq, skv, kv_len, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n4 = rows * (ADH / 4);
  bwd_cast_kernel<<<(n4 + 255) / 256, 256, 0, st>>>((const float*)dq_part, (bf16*)dq, n4, sq,
                                                    kv_len, causal);
  return (int)cudaGetLastError();
}


// lse: (B, H, Sq) f32, or null (serving).  q (B, H, Sq, 64), k and v (B, H,
// Skv, 64) bf16, each 16-byte aligned (the tensor-map encoder refuses
// another address: the entry then returns TENSOR_MAP_ERROR + its error).
extern "C" int wm_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int b, int h, int sq, int skv,
                                int dh, int kv_len, int causal, void* stream) {
  using namespace wm;
  if (dh != ADH || sq < 1 || kv_len < 1 || kv_len > skv) return (int)cudaErrorInvalidValue;
  const cuuint64_t row = ADH * sizeof(bf16);
  const cuuint64_t qdims[3] = {(cuuint64_t)ADH, (cuuint64_t)sq, (cuuint64_t)b * h};
  const cuuint64_t kdims[3] = {(cuuint64_t)ADH, (cuuint64_t)skv, (cuuint64_t)b * h};
  const cuuint64_t qstrides[2] = {row, row * sq}, kstrides[2] = {row, row * skv};
  const cuuint32_t qbox[3] = {ADH, AQ, 1}, kbox[3] = {ADH, AK, 1};
  CUtensorMap mq, mk, mv;
  int err = encode_map(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, q, qdims, qstrides, qbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_map(&mk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, kdims, kstrides, kbox,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_map(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, kdims, kstrides, kbox,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  // Per launch: the attribute belongs to the current device's context.
  cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       ATTN_SMEM);
  dim3 grid((sq + AQ - 1) / AQ, h, b);
  attention_kernel<<<grid, A_THREADS, ATTN_SMEM, (cudaStream_t)stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, sq, kv_len, causal);
  return (int)cudaGetLastError();
}
