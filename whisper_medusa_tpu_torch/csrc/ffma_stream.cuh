// The f32 weight stream over a tied embedding: the sums S[M, V] = X[M, D]
// @ E[V, D]^T with f32 E (or int8 E converted exactly to f32), f32
// products and f32 sums in FFMA on the CUDA cores (the tensor cores take f32
// only as TF32), handed item by item to what the stream does with them.
// K3's f32 mode (logits.cu, wm_logits_f32) stores them (FsStore); K4 and
// K5's f32 and W8A32 modes (verify.cu, score_rows_f32) score them into the
// vocab statistics' partials (FsScore).  It is the f32 counterpart of
// ntstream.cuh.
//
// Bound on H100: bytes at the drafts' rows (large-v2's 51865 x 1280 f32 E is
// 265.6 MB, 79 us at 3.35 TB/s; int8 66.4 MB, 20 us), the 2 M V D products
// at the CUDA cores' 67 TFLOP/s (1.98 us a row) past M ~ 40 (~10 at int8).
// What the design does about it:
//
//  * a persistent grid of FS_CTAS CTAs an SM walks the work items, each a
//    (64-entry vocab tile, pass of up to 64 rows), a tile's passes adjacent
//    so that its E chunks come from L2 after the first pass's;
//  * one producer warp keeps a ring of mbarrier stages in flight through
//    TMA (96 KB a CTA, less what the epilogue's staged sums take of two
//    CTAs' room on an SM: 80 KB at 64 rows a pass): each stage the
//    E chunk and the pass's rows of x over the same D slice (8 TR rows,
//    rows past M zero-filled), x with the 128-byte swizzle, so that the
//    consumers' float4 reads of eight rows fall in eight distinct bank
//    quads.  An f32 E chunk is 64 entries x 32 floats (8 KB, 128-byte
//    swizzle); an int8 one 64 entries x 64 values (4 KB, 64-byte rows with
//    the 64-byte swizzle, x then two 32-float boxes), read as one 16-byte
//    word of 16 values an entry and converted by common.cuh's i8x4_to_f32
//    (exact, no I2F);
//  * four consumer warps run FFMA from shared memory on register tiles of
//    4 entries x TR rows a thread (warp w: entries 32 (w & 1) + lane % 8 +
//    8 e, pass rows 4 (w >> 1) + lane / 8 + 8 i): a 4-deep step reads 4 + TR
//    float4 (one wavefront each) for 16 TR FFMA, so past TR = 4 shared
//    memory is not what bounds the products;
//  * TR (1..8) and the passes come from M alone: passes = ceil(M / 64),
//    TR = ceil(ceil(M / passes) / 8) (10 rows: one pass of 16; 80: two of
//    40, nothing computed on zero rows);
//  * the ragged last tile (51865 = 810 x 64 + 25) is zero-filled by TMA;
//    the epilogue masks it.
//
// Each sum is one fmaf chain over D in order starting from 0, so a row's
// bits do not depend on M, on the pass or on the grid.  The plans are
// mirrored by ops/logits.py::f32_stream_plan and ops/verify.py::
// f32_vocab_plan.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace wm {
namespace {   // internal linkage: every .cu gets its own copy

constexpr int FS_VT = 64;               // vocab entries a tile
constexpr int FS_KC = 32;               // floats of D an f32 stage holds (one 128-byte row)
constexpr int FS_QKC = 64;              // int8 values of D an int8 stage holds (a 64-byte row)
constexpr int FS_MAX_TR = 8;            // rows a thread: passes of up to 64 rows
constexpr int FS_THREADS = 160;         // 4 consumer warps + 1 producer warp
constexpr int FS_CTAS = 2;              // CTAs an SM
constexpr int FS_RING = 98304;          // ring bytes a CTA at most
constexpr int FS_MAX_STAGES = 10;
constexpr int FS_SM_SMEM = 233472;      // shared memory of an SM (H100), bytes

// Bytes of one stage: the E chunk, then 8 TR rows of x over the same D
// (one 32-float box, or two for an int8 chunk's 64 values).
__host__ __device__ constexpr int fs_stage_bytes(int tr, bool q = false) {
  return q ? FS_VT * FS_QKC + 2 * 8 * tr * FS_KC * 4 : FS_VT * FS_KC * 4 + 8 * tr * FS_KC * 4;
}

// Ring bytes a CTA beside ``staged`` bytes of the epilogue's: FS_RING, or
// what FS_CTAS CTAs an SM leave (a CTA's 1 KB the system reserves, its
// 1 KB of alignment slack, the staged sums and the barriers).
__host__ __device__ constexpr int fs_ring(int staged) {
  return FS_SM_SMEM / FS_CTAS - 2048 - staged - 16 * FS_MAX_STAGES < FS_RING
             ? FS_SM_SMEM / FS_CTAS - 2048 - staged - 16 * FS_MAX_STAGES
             : FS_RING;
}

__host__ __device__ constexpr int fs_stages(int tr, bool q, int staged) {
  return fs_ring(staged) / fs_stage_bytes(tr, q) < FS_MAX_STAGES
             ? fs_ring(staged) / fs_stage_bytes(tr, q)
             : FS_MAX_STAGES;
}

// Dynamic shared memory of a CTA: 1024 bytes of alignment slack, the ring,
// the epilogue's staged sums, the full and empty barriers.
template <class Epi>
inline int fs_smem(int tr, bool q) {
  const int s = fs_stages(tr, q, Epi::staged(tr));
  return 1024 + s * fs_stage_bytes(tr, q) + Epi::staged(tr) + 16 * s;
}

// The passes over M rows and the rows a thread takes in each.
inline int fs_passes(int m) { return (m + 8 * FS_MAX_TR - 1) / (8 * FS_MAX_TR); }
inline int fs_tr(int m) {
  const int per = (m + fs_passes(m) - 1) / fs_passes(m);
  return (per + 7) / 8;
}

// The products of one ring stage into a thread's 4 entries x TR rows; es
// the thread's first entry's row of the E chunk, xs its first row of x.
// f32: a 4-deep step reads one float4 an entry and a row (the 128-byte
// swizzle: 16-byte chunk kc of row r at kc ^ (r % 8)).
template <int TR>
__device__ __forceinline__ void fs_products(float (&acc)[4][TR], const float* es,
                                            const float* xs, int eg, int rg) {
#pragma unroll
  for (int kc = 0; kc < FS_KC / 4; ++kc) {
    float4 ev[4], xv[TR];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ev[e] = *reinterpret_cast<const float4*>(es + 8 * e * FS_KC + ((kc ^ eg) << 2));
#pragma unroll
    for (int i = 0; i < TR; ++i)
      xv[i] = *reinterpret_cast<const float4*>(xs + 8 * i * FS_KC + ((kc ^ rg) << 2));
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        acc[e][i] = fmaf(xv[i].x, ev[e].x, acc[e][i]);
        acc[e][i] = fmaf(xv[i].y, ev[e].y, acc[e][i]);
        acc[e][i] = fmaf(xv[i].z, ev[e].z, acc[e][i]);
        acc[e][i] = fmaf(xv[i].w, ev[e].w, acc[e][i]);
      }
  }
}

// int8 E: a 16-deep step reads one 16-byte word an entry (the 64-byte
// swizzle: 16-byte chunk h of row r at (h ^ (r / 2)) % 4) and converts it a
// 4-deep step at a time; x's chunk is two 32-float boxes of 8 TR rows.
template <int TR>
__device__ __forceinline__ void fs_products(float (&acc)[4][TR], const int8_t* es,
                                            const float* xs, int eg, int rg) {
#pragma unroll
  for (int h = 0; h < FS_QKC / 16; ++h) {
    uint4 ew[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ew[e] = *reinterpret_cast<const uint4*>(es + 8 * e * FS_QKC + (((h ^ (eg >> 1)) & 3) << 4));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = 4 * h + j;     // the 4-deep step of the chunk
      const float* xh = xs + (kc >> 3) * 8 * TR * FS_KC;
      float4 ev[4], xv[TR];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ev[e] = i8x4_to_f32(j == 0 ? ew[e].x : j == 1 ? ew[e].y : j == 2 ? ew[e].z : ew[e].w);
#pragma unroll
      for (int i = 0; i < TR; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xh + 8 * i * FS_KC + (((kc & 7) ^ rg) << 2));
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          acc[e][i] = fmaf(xv[i].x, ev[e].x, acc[e][i]);
          acc[e][i] = fmaf(xv[i].y, ev[e].y, acc[e][i]);
          acc[e][i] = fmaf(xv[i].z, ev[e].z, acc[e][i]);
          acc[e][i] = fmaf(xv[i].w, ev[e].w, acc[e][i]);
        }
    }
  }
}

// Persistent grid: CTA b takes items b, b + grid, ... (item = tile * passes
// + pass); for each, the D chunks in order.  At an item's last chunk the
// consumers hand their sums to epi.item<TR>(acc, tile, pass, staged, we,
// eg, rg): thread (we, eg, rg) holds entries tile * 64 + 32 we + eg + 8 e,
// pass rows rg + 8 i.  Q: E int8 (box 64 x 64, 64-byte swizzle), x read as
// two 32-float boxes a stage.
template <int TR, bool Q, class Epi>
__global__ void __launch_bounds__(FS_THREADS, FS_CTAS)
ffma_stream_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap me,
                   const Epi epi, int chunks, int passes, int items) {
  constexpr int S = fs_stages(TR, Q, Epi::staged(TR));
  constexpr int SB = fs_stage_bytes(TR, Q);
  constexpr int R = 8 * TR;
  constexpr int EB = Q ? FS_VT * FS_QKC : FS_VT * FS_KC * 4;   // bytes of the E chunk
  constexpr int XB = R * FS_KC * 4;                           // bytes of one x box
  extern __shared__ char smem_raw[];
  char* ring = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* staged = reinterpret_cast<float*>(ring + S * SB);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * SB + Epi::staged(TR));
  uint64_t* empty = full + S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Stage st of the ring and the parity ph of its current phase, advanced
  // alike by the producer and the consumers.
  int st = 0;
  uint32_t ph = 0;
  if (warp == 4) {   // producer
    if (lane == 0) {
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x)
        for (int c = 0; c < chunks; ++c, ++n) {
          if (n >= S) mbar_wait(&empty[st], ph ^ 1);
          mbar_arrive_tx(&full[st], SB);
          char* dst = ring + st * SB;
          tma_load_2d(dst, &me, &full[st], c * (Q ? FS_QKC : FS_KC), (item / passes) * FS_VT);
          tma_load_2d(dst + EB, &mx, &full[st], c * (Q ? FS_QKC : FS_KC), (item % passes) * R);
          if constexpr (Q)
            tma_load_2d(dst + EB + XB, &mx, &full[st], c * FS_QKC + FS_KC, (item % passes) * R);
          if (++st == S) {
            st = 0;
            ph ^= 1;
          }
        }
    }
    return;
  }

  // Entries 32 we + eg + 8 e (row % 8 == eg), pass rows rg + 8 i (row % 8 == rg).
  const int we = warp & 1, eg = lane & 7, rg = 4 * (warp >> 1) + (lane >> 3);
  using ET = std::conditional_t<Q, int8_t, float>;
  constexpr int ERow = Q ? FS_QKC : FS_KC;      // E values a row of the chunk
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    float acc[4][TR];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < TR; ++i) acc[e][i] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&full[st], ph);
      fs_products<TR>(acc, reinterpret_cast<const ET*>(ring + st * SB) + (32 * we + eg) * ERow,
                      reinterpret_cast<const float*>(ring + st * SB + EB) + rg * FS_KC, eg, rg);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == S) {
        st = 0;
        ph ^= 1;
      }
    }
    epi.template item<TR>(acc, item / passes, item % passes, staged, we, eg, rg);
  }
}

// K3 f32's epilogue: the item's sums are its logits; write them (rows past
// M and entries past V are not stored).
struct FsStore {
  float* y;
  int m, v;
  __host__ __device__ static constexpr int staged(int) { return 0; }
  template <int TR>
  __device__ __forceinline__ void item(const float (&acc)[4][TR], int tile, int pass, float*,
                                       int we, int eg, int rg) const {
    const int v0 = tile * FS_VT + 32 * we + eg, r0 = pass * 8 * TR + rg;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = r0 + 8 * i;
      if (row >= m) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (v0 + 8 * e < v) y[(size_t)row * v + v0 + 8 * e] = acc[e][i];
    }
  }
};

// Launches the stream of x (m, d) f32 against e (v, d), f32 or (Q) int8,
// with epilogue epi; d % 32 == 0 (Q: d % 64 == 0); x and e 16-byte aligned
// (the tensor-map encoder refuses another address: the call then returns
// TENSOR_MAP_ERROR + its error).
template <bool Q, class Epi>
inline int fs_launch(const float* x, const void* e, const Epi& epi, int m, int v, int d,
                     cudaStream_t stream) {
  constexpr int KC = Q ? FS_QKC : FS_KC;
  if (m < 1 || v < 1 || d < KC || d % KC) return (int)cudaErrorInvalidValue;
  const int passes = fs_passes(m), tr = fs_tr(m);
  const int items = (v + FS_VT - 1) / FS_VT * passes;
  const cuuint64_t xdims[2] = {(cuuint64_t)d, (cuuint64_t)m};
  const cuuint64_t edims[2] = {(cuuint64_t)d, (cuuint64_t)v};
  const cuuint64_t xstrides[1] = {(cuuint64_t)d * sizeof(float)};
  const cuuint64_t estrides[1] = {(cuuint64_t)d * (Q ? 1 : sizeof(float))};
  const cuuint32_t xbox[2] = {FS_KC, (cuuint32_t)(8 * tr)};
  const cuuint32_t ebox[2] = {KC, FS_VT};
  CUtensorMap mx, me;
  int err = encode_map(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, x, xdims, xstrides, xbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_map_cached(
        &me, Q ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, e, edims,
        estrides, ebox, Q ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = items < FS_CTAS * sms ? items : FS_CTAS * sms;
  const int smem = fs_smem<Epi>(tr, Q);
  // Per launch: the attribute belongs to the current device's context.
#define WM_FS(TR)                                                                          \
  case TR:                                                                                 \
    cudaFuncSetAttribute(ffma_stream_kernel<TR, Q, Epi>,                                   \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);               \
    ffma_stream_kernel<TR, Q, Epi><<<grid, FS_THREADS, smem, stream>>>(                    \
        mx, me, epi, d / KC, passes, items);                                               \
    break;
  switch (tr) {
    WM_FS(1) WM_FS(2) WM_FS(3) WM_FS(4) WM_FS(5) WM_FS(6) WM_FS(7) WM_FS(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WM_FS
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wm
