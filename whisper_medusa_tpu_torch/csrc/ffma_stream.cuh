// The f32 tied-embedding projection as a weight stream: Y[M, V] = X[M, D]
// @ E[V, D]^T with f32 E, f32 products and f32 sums in FFMA on the CUDA
// cores (the tensor cores take f32 only as TF32).  K3's f32 mode
// (logits.cu, wm_logits_f32) runs on it; it is the f32 counterpart of
// ntstream.cuh.
//
// Bound on H100: bytes at the drafts' rows (large-v2's 51865 x 1280 f32 E is
// 265 MB, 79 us at 3.35 TB/s), the 2 M V D products at the CUDA cores' 67
// TFLOP/s past M ~ 160.  What the design does about it:
//
//  * a persistent grid of FS_CTAS CTAs an SM walks the work items, each a
//    (64-entry vocab tile, pass of up to 64 rows), a tile's passes adjacent
//    so that its E chunks come from L2 after the first pass's;
//  * one producer warp keeps a ring of mbarrier stages in flight through
//    TMA (about 96 KB a CTA, so ~190 KB an SM): each stage the E chunk (64
//    entries x 32 floats, 8 KB) and the pass's rows of x over the same 32
//    floats (8 TR rows, rows past M zero-filled), both with the 128-byte
//    swizzle, so that the consumers' float4 reads of eight rows fall in
//    eight distinct bank quads;
//  * four consumer warps run FFMA from shared memory on register tiles of
//    4 entries x TR rows a thread (warp w: entries 32 (w & 1) + lane % 8 +
//    8 e, pass rows 4 (w >> 1) + lane / 8 + 8 i): a 4-deep step reads 4 + TR
//    float4 (one wavefront each) for 16 TR FFMA, so past TR = 4 shared
//    memory is not what bounds the products;
//  * TR (1..8) and the passes come from M alone: passes = ceil(M / 64),
//    TR = ceil(ceil(M / passes) / 8) (10 rows: one pass of 16; 80: two of
//    40, nothing computed on zero rows);
//  * the ragged last tile (51865 = 810 x 64 + 25) is zero-filled by TMA and
//    masked on store.
//
// Each logit is one fmaf chain over D in order starting from 0 (csrc/
// ffma.cuh's order), so a row's bits do not depend on M, on the pass or on
// the grid, and equal ffma_tile's.  The plan is mirrored by
// ops/logits.py::f32_stream_plan.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace wm {
namespace {   // internal linkage: every .cu gets its own copy

constexpr int FS_VT = 64;               // vocab entries a tile
constexpr int FS_KC = 32;               // floats of D a stage holds (one 128-byte row)
constexpr int FS_MAX_TR = 8;            // rows a thread: passes of up to 64 rows
constexpr int FS_THREADS = 160;         // 4 consumer warps + 1 producer warp
constexpr int FS_CTAS = 2;              // CTAs an SM
constexpr int FS_RING = 98304;          // ring bytes a CTA
constexpr int FS_MAX_STAGES = 10;

// Bytes of one stage: the E chunk, then 8 TR rows of x.
__host__ __device__ constexpr int fs_stage_bytes(int tr) {
  return FS_VT * FS_KC * 4 + 8 * tr * FS_KC * 4;
}

__host__ __device__ constexpr int fs_stages(int tr) {
  return FS_RING / fs_stage_bytes(tr) < FS_MAX_STAGES ? FS_RING / fs_stage_bytes(tr)
                                                      : FS_MAX_STAGES;
}

// Dynamic shared memory of a CTA: 1024 bytes of alignment slack, the ring,
// the full and empty barriers.
inline int fs_smem(int tr) {
  return 1024 + fs_stages(tr) * fs_stage_bytes(tr) + 16 * fs_stages(tr);
}

// The passes over M rows and the rows a thread takes in each.
inline int fs_passes(int m) { return (m + 8 * FS_MAX_TR - 1) / (8 * FS_MAX_TR); }
inline int fs_tr(int m) {
  const int per = (m + fs_passes(m) - 1) / fs_passes(m);
  return (per + 7) / 8;
}

template <int TR>
__global__ void __launch_bounds__(FS_THREADS, FS_CTAS)
ffma_stream_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap me,
                   float* __restrict__ y, int m, int v, int chunks, int passes, int items) {
  constexpr int S = fs_stages(TR);
  constexpr int SB = fs_stage_bytes(TR);
  constexpr int R = 8 * TR;
  constexpr int EB = FS_VT * FS_KC * 4;   // bytes of the E chunk
  extern __shared__ char smem_raw[];
  char* ring = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * SB);
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
          tma_load_2d(dst, &me, &full[st], c * FS_KC, (item / passes) * FS_VT);
          tma_load_2d(dst + EB, &mx, &full[st], c * FS_KC, (item % passes) * R);
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
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    float acc[4][TR];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < TR; ++i) acc[e][i] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&full[st], ph);
      const float* es = reinterpret_cast<const float*>(ring + st * SB) + (32 * we + eg) * FS_KC;
      const float* xs = reinterpret_cast<const float*>(ring + st * SB + EB) + rg * FS_KC;
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
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == S) {
        st = 0;
        ph ^= 1;
      }
    }
    // The item's sums are complete: write them.
    const int v0 = (item / passes) * FS_VT + 32 * we + eg, r0 = (item % passes) * R + rg;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = r0 + 8 * i;
      if (row >= m) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (v0 + 8 * e < v) y[(size_t)row * v + v0 + 8 * e] = acc[e][i];
    }
  }
}

// x (m, d) f32, e (v, d) f32 -> y (m, v) f32; d % 32 == 0; x and e 16-byte
// aligned (the tensor-map encoder refuses another address: the entry then
// returns TENSOR_MAP_ERROR + its error).
inline int fs_launch(const float* x, const float* e, float* y, int m, int v, int d,
                     cudaStream_t stream) {
  if (m < 1 || v < 1 || d < FS_KC || d % FS_KC) return (int)cudaErrorInvalidValue;
  const int passes = fs_passes(m), tr = fs_tr(m);
  const int items = (v + FS_VT - 1) / FS_VT * passes;
  const cuuint64_t xdims[2] = {(cuuint64_t)d, (cuuint64_t)m};
  const cuuint64_t edims[2] = {(cuuint64_t)d, (cuuint64_t)v};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(float)};
  const cuuint32_t xbox[2] = {FS_KC, (cuuint32_t)(8 * tr)};
  const cuuint32_t ebox[2] = {FS_KC, FS_VT};
  CUtensorMap mx, me;
  int err = encode_map(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, x, xdims, strides, xbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_map_cached(&me, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, e, edims, strides, ebox,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = items < FS_CTAS * sms ? items : FS_CTAS * sms;
  const int smem = fs_smem(tr);
  // Per launch: the attribute belongs to the current device's context.
#define WM_FS(TR)                                                                          \
  case TR:                                                                                 \
    cudaFuncSetAttribute(ffma_stream_kernel<TR>,                                           \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);               \
    ffma_stream_kernel<TR><<<grid, FS_THREADS, smem, stream>>>(                            \
        mx, me, y, m, v, d / FS_KC, passes, items);                                        \
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
