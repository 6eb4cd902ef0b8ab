// The f32 GEMM of the f32 and W8A32 modes as a weight stream in one launch:
// out (nh, M, N) = epi(X (M, K) @ W (nh, K, N) + b (nh, N)) with f32
// products and f32 sums in FFMA on the CUDA cores (the tensor cores take
// f32 only as TF32, which is not the JAX package's f32).  K11's fc1 and fc2
// (decode_ops.cu, wm_ffn_decode_f32), the Medusa heads' rows of K4's stage
// A (verify.cu, wm_verify_hidden_f32) and of wm_head_rows (wm_gemm_f32,
// EPI_SILU_RESID), and every f32 projection of the per-op decoder step
// (wm_gemm_f32, EPI_BIAS) run on it.  It is the f32 counterpart of
// wgemm.cuh, whose design it follows.
//
// Its int8-weight mode (W8 = true) is the W8A32 GEMM (the int8 copy of an
// f32 model): epi((X @ f32(q (K, N))) * s[c] + b[c]) as ops/megastep.py::
// mm_w8 and the JAX kernels' ``mm`` compute it, the int8 values converted
// exactly to f32, f32 products and sums, the column's scale on the sum,
// then the bias, then the epilogue (EPI_BIAS_SCALE's factor, the exact-erf
// GELU, the residual, or the residual plus SiLU).  K2's W8A32 projections
// and FFN (megastep.cu: up to three jobs on one X, q / k / v as grid z, the
// weights' (L, K, N) stacks as one map each, the layer a row offset), the
// int8 head rows (wm_gemm_w8a32) and K4 W8A32's stage A run on it.  The
// same stream as the f32 mode at a quarter of its weight bytes: a stage's
// W chunk is 32 K x 64 int8 columns (2 KB, one TMA box of 64-byte rows
// with the 64-byte swizzle), and a product warp reads each of its W rows
// as one 32-bit word of four columns and converts it with common.cuh's
// i8x4_to_f32 (bit-exact, no I2F).
//
// Bound on H100: bytes at the decode step's M (a 1280 x 1280 f32 weight is
// 6.6 MB, 2.0 us at 3.35 TB/s; int8 1.6 MB, 0.5 us; large-v2's fc1 or fc2
// 26.2 MB f32, 7.8 us, 6.6 MB int8, 2.0 us), the 2 M K N products at the
// CUDA cores' 67 TFLOP/s past M ~ 64 rows (f32; ~16 at int8).  A
// shared-memory float4 read costs a warp up to four wavefronts, so at the
// decode step's M the reads, not the products, are what a thread waits on.
// What the design does about it:
//
//  * a CTA takes 64 W columns over one K slice and a group of up to
//    FG_MAX_PG passes of up to 32 rows; the slices of a column tile come
//    from (K, N) alone (fg_slices: enough for 132 CTAs, at most 4: larger
//    clusters measured slower past the decode step's M, with f32 weights
//    and with int8 ones) and form one thread-block cluster;
//  * a ring of mbarrier stages (60 KB a CTA) kept full through TMA: at up
//    to 16 rows a pass (the decode step's M) by a producer warp beside the
//    eight product warps; past it by thread 0 and, for each later item, the
//    last warp done with its stage (a producer warp's registers would cost
//    the second CTA an SM there).  Each stage a W chunk (32 K x 64 columns:
//    f32 8 KB as two 32-column halves with the 128-byte swizzle; int8 2 KB)
//    and the pass's rows of X over the same 32 K (rows past M zero-filled,
//    the 128-byte swizzle); a group's later passes stream the slice again
//    (from L2);
//  * eight product warps run FFMA from shared memory: thread (kg, cq, rh)
//    takes k = 4 kg .. + 3 of every chunk (kg < 8) for columns 4 cq .. + 3
//    (cq < 16) and the pass's rows [R/2 rh, + R/2) (rh < 2), so that a W
//    value is read from shared memory by two threads, not by one a row
//    group: per chunk 4 + R/2 float4 (a quarter-warp reads one 128-byte W
//    row, or one X quad for all its lanes; int8: four 32-bit words) for 8 R
//    FFMA; past 16 rows a pass at most 128 registers a thread, so that two
//    CTAs (four product warps a scheduler) fit an SM;
//  * R (4 .. 32 in steps of 4) and the passes come from M alone: passes =
//    ceil(M / 32), R = 4 ceil(ceil(M / passes) / 4); a CTA takes a group
//    of up to FG_MAX_PG passes, fewer where that brings the launch towards
//    FG_WAVE CTAs (fg_pg), a tile's groups adjacent in the grid;
//  * at the end of a pass the eight k groups' sums are added in a fixed
//    tree, ((kg0 + kg1) + (kg2 + kg3)) + ((kg4 + kg5) + (kg6 + kg7)) (two
//    butterfly shuffles in a warp, then the two warps of a (column half,
//    row half) through shared memory), into the pass's slice sums; after
//    the group, one cluster barrier, and rank r adds the slices' sums for
//    its share of the group's rows in rank order through distributed shared
//    memory and runs the epilogue (int8: the column's scale; bias; the
//    epilogue): one launch, no partials scratch, no combine kernel;
//  * programmatic dependent launch (wgemm.cuh's launch_pdl): the loading
//    thread issues the first ring of W loads before griddepcontrol.wait, so
//    the weights stream while the kernel before finishes (K11's fc2 behind
//    fc1; each of K2 W8A32's GEMMs behind the kernel before it).  Before the
//    wait a kernel reads only weights and writes only its own shared memory.
//
// Each k group's sum is one fmaf chain over its k of the slice's chunks in
// order starting from 0; the k groups are added in the tree above and the
// slices in rank order, so a row's bits do not depend on M, on the rows it
// is batched with, on its pass or group, on the jobs or on the heads of the
// launch (P3).  The plan is mirrored by ops/decode_ops.py::f32_gemm_plan
// (``w8`` for the int8 mode).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wgemm.cuh"

namespace wm {
namespace {   // internal linkage: every .cu gets its own copy

constexpr int FG_COLS = 64;            // W columns a CTA
constexpr int FG_KC = 32;              // K a stage holds: one 128-byte row of X
constexpr int FG_HALF = 32;            // W columns of one swizzled 128-byte row
constexpr int FG_MAX_RQ = 8;           // 4-row groups a pass: up to 32 rows
constexpr int FG_MAX_PG = 4;           // passes a CTA takes: up to 128 rows
constexpr int FG_KG = 8;               // k groups: 4 consecutive k of a chunk each
static_assert(FG_KG * 4 == FG_KC, "a k group takes one float4 of a chunk");
constexpr int FG_WARPS = 8;            // product warps: (k half, column half, row half)
constexpr int FG_PRODUCER_RQ = 4;      // up to 16 rows a pass: one more warp issues the loads
constexpr int FG_CTAS = 132;           // CTAs the K slices aim for (the H100's SMs)
constexpr int FG_WAVE = 264;           // CTAs the pass groups aim for: two an SM
constexpr int FG_MAX_SLICES = 4;       // K slices: the CTAs of one cluster
constexpr int FG_RING = 61440;         // ring bytes a CTA
constexpr int FG_RP = FG_COLS + 4;     // f32 pitch of the sums' rows in shared memory
constexpr int FG_MAX_JOBS = 3;         // X operands' jobs: K2's q / k / v

// Bytes of one stage: the W chunk (f32, or int8 with w8), then 4 RQ rows
// of X (padded to a 1024-byte swizzle atom).
__host__ __device__ constexpr int fg_stage_bytes(int rq, bool w8 = false) {
  return FG_KC * FG_COLS * (w8 ? 1 : 4) + (4 * rq + 7) / 8 * 8 * FG_KC * 4;
}

__host__ __device__ constexpr int fg_stages(int rq, bool w8 = false) {
  return FG_RING / fg_stage_bytes(rq, w8);
}

// Threads of a CTA: at up to 16 rows a pass (the decode step's M) a
// producer warp beside the eight product warps keeps the ring full; past
// it thread 0 and the last warp done with a stage issue the loads, so that
// two CTAs of up to 128 registers a thread fit an SM.
__host__ __device__ constexpr int fg_threads(int rq) {
  return 32 * (FG_WARPS + (rq <= FG_PRODUCER_RQ ? 1 : 0));
}

// Dynamic shared memory of a CTA: 1024 bytes of alignment slack, the ring,
// the upper k groups' sums of a pass, the pg passes' slice sums, the full
// barriers and the empty barriers (or the stages' done counts).
inline int fg_smem(int rq, int pg, bool w8 = false) {
  return 1024 + fg_stages(rq, w8) * fg_stage_bytes(rq, w8) + (1 + pg) * 4 * rq * FG_RP * 4 +
         16 * fg_stages(rq, w8);
}

// The K slices of a (K, N) weight, from (K, N) alone: enough for FG_CTAS
// CTAs over the N / 64 column tiles, at most FG_MAX_SLICES, each a run of
// whole 32-deep chunks (wgemm.cuh's gemm_slice_begin cuts them).
inline int fg_slices(int k, int n) {
  const int chunks = k / FG_KC, tiles = n / FG_COLS;
  int want = (FG_CTAS + tiles - 1) / tiles;
  if (want > FG_MAX_SLICES) want = FG_MAX_SLICES;
  if (want > chunks) want = chunks;
  return want < 1 ? 1 : want;
}

// The passes over M rows, the 4-row groups of each, the CTAs' groups of
// passes and the passes a group takes (the last may take fewer).
inline int fg_passes(int m) { return (m + 4 * FG_MAX_RQ - 1) / (4 * FG_MAX_RQ); }
inline int fg_rq(int m) {
  const int per = (m + fg_passes(m) - 1) / fg_passes(m);
  return (per + 3) / 4;
}
// The passes a CTA takes: at most FG_MAX_PG, and fewer where that brings
// the launch towards FG_WAVE CTAs (``ctas``, the CTAs of one group: column
// tiles x slices x heads); then the groups of that many passes.
inline int fg_pg(int m, int ctas) {
  const int passes = fg_passes(m);
  int g = (passes + FG_MAX_PG - 1) / FG_MAX_PG;
  const int fill = (FG_WAVE + ctas - 1) / ctas;
  if (g < fill) g = fill < passes ? fill : passes;
  return (passes + g - 1) / g;
}
inline int fg_groups(int m, int pg) { return (fg_passes(m) + pg - 1) / pg; }

// A W chunk (32 K rows x 64 columns) as two 32-column halves with the
// 128-byte swizzle: half h at dst + 4 KB h.
__device__ __forceinline__ void fg_load_w(char* dst, const CUtensorMap* mw, uint64_t* bar, int n0,
                                          int row) {
  tma_load_2d(dst, mw, bar, n0, row);
  tma_load_2d(dst + FG_KC * FG_HALF * 4, mw, bar, n0 + FG_HALF, row);
}

// One output of the launch.  Grid z runs over the jobs and then over the
// last job's stack: z < njobs takes job z at layer 0; past it, job njobs -
// 1 at layer z - (njobs - 1) (the heads: W (nh, K, N), s and b (nh, N),
// out (nh, M, N) offset by the layer).
struct FgJob {
  const float* b;       // (N,) per layer, or null
  const float* s;       // int8 W: the columns' f32 scales, (N,) per layer
  const float* resid;   // (M, N): EPI_BIAS_RESID's / EPI_SILU_RESID's residual rows (may be out)
  float* out;           // (M, N) per layer
  float post;           // EPI_BIAS_SCALE's factor
  int epi;
  int wrow;             // the job's first W row (layer 0) in its map
};

struct FgArgs {
  FgJob j[FG_MAX_JOBS];
  int njobs, m, k, n, passes, groups, pg;
};

// y = the slices' sum of one element: times the column's scale (int8 W),
// plus the bias, then the epilogue.
__device__ __forceinline__ float fg_epi(float y, const FgJob& jb, float s, float b, float r) {
  if (jb.s != nullptr) y *= s;
  if (jb.b != nullptr) y += b;
  switch (jb.epi) {
    case EPI_BIAS_SCALE: return y * jb.post;
    case EPI_BIAS_GELU: return gelu_erf(y);
    case EPI_BIAS_RESID: return r + y;
    case EPI_SILU_RESID: return r + y / (1.0f + expf(-y));
    default: return y;
  }
}

// The 64-byte swizzle of an int8 W chunk: byte c of W row r (64-byte rows)
// lies at r * 64 + (((c >> 4) ^ ((r >> 1) & 3)) << 4) + (c & 15).
__device__ __forceinline__ int fg_sw64(int r, int c) {
  return r * 64 + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15);
}

// Grid (slices, N / 64 * groups, nz), clusters of (slices, 1, 1): the CTA
// of rank r computes W columns [64 (y / groups), + 64) of output z (FgJob)
// over K slice r for the passes of group y % groups (4 RQ rows each, a
// consumer thread 2 RQ of them), then rank r adds the slices' sums, in
// rank order, for its share of the group's rows.  mx: X (M rows, K) f32,
// box (32, 4 RQ), the 128-byte swizzle; mw0..2: the jobs' W as (rows, N),
// f32 box (32, 32) with the 128-byte swizzle or int8 (W8) box (64, 32)
// with the 64-byte swizzle.
template <int RQ, bool W8>
__global__ void __launch_bounds__(fg_threads(RQ), RQ <= FG_PRODUCER_RQ ? 1 : 2)
ffma_gemm_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw0,
                 const __grid_constant__ CUtensorMap mw1, const __grid_constant__ CUtensorMap mw2,
                 const __grid_constant__ FgArgs a) {
  constexpr bool PRODUCER = RQ <= FG_PRODUCER_RQ;
  constexpr int S = fg_stages(RQ, W8);
  constexpr int SB = fg_stage_bytes(RQ, W8);
  constexpr int R = 4 * RQ;
  constexpr int RH = R / 2;                          // rows a thread takes
  constexpr int WB = FG_KC * FG_COLS * (W8 ? 1 : 4); // bytes of the W chunk
  constexpr int TX = WB + R * FG_KC * 4;             // bytes TMA writes to a stage
  griddep_launch();
  cg::cluster_group cluster = cg::this_cluster();
  const int slices = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int grp = blockIdx.y % a.groups, n0 = (blockIdx.y / a.groups) * FG_COLS;
  const int z = blockIdx.z, p0 = grp * a.pg;
  const int jz = z < a.njobs ? z : a.njobs - 1, layer = z - jz;
  const FgJob& jb = a.j[jz];
  const CUtensorMap* mw = jz == 0 ? &mw0 : (jz == 1 ? &mw1 : &mw2);
  const int np = a.passes - p0 < a.pg ? a.passes - p0 : a.pg;
  const int chunks = a.k / FG_KC;
  const int c_first = gemm_slice_begin(chunks, slices, rank);
  const int nch = gemm_slice_begin(chunks, slices, rank + 1) - c_first;
  // The slice's first W row in the map.
  const int wrow = jb.wrow + layer * a.k + c_first * FG_KC;
  const int items = np * nch;                    // (pass, chunk) stages of the group

  extern __shared__ char smem_raw[];
  char* ring = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* hs = reinterpret_cast<float*>(ring + S * SB);   // (R, 64): kg 4..7 of a pass
  float* red = hs + R * FG_RP;                           // (pg, R, 64): the slice's sums
  uint64_t* full = reinterpret_cast<uint64_t*>(red + a.pg * R * FG_RP);
  uint64_t* empty = full + S;                                // PRODUCER: warps done
  int* done = reinterpret_cast<int*>(full + S);              // else: their count
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      if constexpr (PRODUCER) mbar_init(&empty[i], FG_WARPS);
      else done[i] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();
  // Item it (pass it / nch, chunk it % nch) into stage it % S: the W chunk
  // and the pass's rows of X.
  auto load_w = [&](int it) {
    const int st = it % S;
    mbar_arrive_tx(&full[st], TX);
    if constexpr (W8)
      tma_load_2d(ring + st * SB, mw, &full[st], n0, wrow + (it % nch) * FG_KC);
    else
      fg_load_w(ring + st * SB, mw, &full[st], n0, wrow + (it % nch) * FG_KC);
  };
  auto load_x = [&](int it) {
    const int st = it % S, r0 = (p0 + it / nch) * R;
    tma_load_2d(ring + st * SB + WB, &mx, &full[st], (c_first + it % nch) * FG_KC, r0);
  };
  const int pre = items < S ? items : S;
  const bool loader = threadIdx.x == (PRODUCER ? 32 * FG_WARPS : 0);
  if (loader)   // the weights of the first stages: no wait
    for (int it = 0; it < pre; ++it) load_w(it);
  griddep_wait();
  if (loader)
    for (int it = 0; it < pre; ++it) load_x(it);
  if (PRODUCER && warp == FG_WARPS) {   // the producer warp
    if (loader)
      for (int it = pre; it < items; ++it) {
        mbar_wait(&empty[it % S], ((it / S) & 1) ^ 1);
        load_w(it);
        load_x(it);
      }
  } else {
    // Columns 4 cq .. + 3 (in W half warp & 1), k = 4 kg .. + 3 of each
    // chunk, pass rows [RH rh, + RH).
    const int cq = (lane & 7) + 8 * (warp & 1), kg = (lane >> 3) + 4 * ((warp >> 1) & 1);
    const int rh = warp >> 2;
    for (int p = 0; p < np; ++p) {
      float acc[RH][4];
#pragma unroll
      for (int i = 0; i < RH; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int c = 0; c < nch; ++c) {
        const int it = p * nch + c, st = it % S;
        mbar_wait(&full[st], (it / S) & 1);
        float4 wv[4];
        if constexpr (W8) {
          // W rows 4 kg + j, bytes 4 cq .. + 3: four int8 columns a word.
          const char* wb = ring + st * SB;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = i8x4_to_f32(
                *reinterpret_cast<const uint32_t*>(wb + fg_sw64(4 * kg + j, 4 * cq)));
        } else {
          // W rows 4 kg + j (row % 8 == 4 (kg & 1) + j), chunk lane % 8 of the half.
          const float* ws =
              reinterpret_cast<const float*>(ring + st * SB + (warp & 1) * (WB / 2)) +
              4 * kg * FG_HALF;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = *reinterpret_cast<const float4*>(
                ws + j * FG_HALF + (((lane & 7) ^ (4 * (kg & 1) + j)) << 2));
        }
        const float* xs = reinterpret_cast<const float*>(ring + st * SB + WB) + RH * rh * FG_KC;
#pragma unroll
        for (int i = 0; i < RH; ++i) {
          const int row = RH * rh + i;
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + i * FG_KC + ((kg ^ (row & 7)) << 2));
          const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][0] = fmaf(xk[j], wv[j].x, acc[i][0]);
            acc[i][1] = fmaf(xk[j], wv[j].y, acc[i][1]);
            acc[i][2] = fmaf(xk[j], wv[j].z, acc[i][2]);
            acc[i][3] = fmaf(xk[j], wv[j].w, acc[i][3]);
          }
        }
        // The stage goes back to the producer, or the last warp done with it
        // refills it with item it + S: each warp's reads of it have retired
        // (its products used them), and the warps' counts of the stage are
        // totally ordered.
        __syncwarp();
        if constexpr (PRODUCER) {
          if (lane == 0) mbar_arrive(&empty[st]);
        } else if (lane == 0 && (atomicAdd(&done[st], 1) + 1) % FG_WARPS == 0 &&
                   it + S < items) {
          load_w(it + S);
          load_x(it + S);
        }
      }
      // The k groups of a warp (lane bits 3 and 4): (kg0 + kg1) + (kg2 + kg3),
      // the same bits in each of the four lanes.
#pragma unroll
      for (int i = 0; i < RH; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 8);
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
        }
      named_sync(1, 32 * FG_WARPS);   // the previous pass's upper sums have been read
      const bool upper = (warp >> 1) & 1;  // k groups 4..7
      float* hrow = hs + RH * rh * FG_RP + 4 * cq;
      if (upper && lane < 8) {
#pragma unroll
        for (int i = 0; i < RH; ++i)
          *reinterpret_cast<float4*>(hrow + i * FG_RP) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      named_sync(1, 32 * FG_WARPS);
      if (!upper && lane < 8) {
        float* rrow = red + (p * R + RH * rh) * FG_RP + 4 * cq;
#pragma unroll
        for (int i = 0; i < RH; ++i) {
          const float4 hv = *reinterpret_cast<const float4*>(hrow + i * FG_RP);
          *reinterpret_cast<float4*>(rrow + i * FG_RP) =
              make_float4(acc[i][0] + hv.x, acc[i][1] + hv.y, acc[i][2] + hv.z,
                          acc[i][3] + hv.w);
        }
      }
    }
  }
  cluster.sync();    // every rank's sums are visible
  // Rank r: the group's rows [r * per, + per); the slices added in rank
  // order, every rank's value read before the first add.
  const int gr0 = p0 * R;
  const int valid = a.m - gr0 < np * R ? a.m - gr0 : np * R;
  const int per = (valid + slices - 1) / slices, q0 = rank * per;
  const int q1 = q0 + per < valid ? q0 + per : valid;
  constexpr int MS = FG_MAX_SLICES;
  const float* part[MS];
#pragma unroll
  for (int q = 0; q < MS; ++q)
    part[q] = cluster.map_shared_rank(red, q < slices ? q : 0);
  const size_t lcol = (size_t)layer * a.n + n0;   // the layer's columns of s and b
  float* out = jb.out + (size_t)layer * a.m * a.n;
  for (int e = threadIdx.x; e < (q1 - q0) * (FG_COLS / 4); e += fg_threads(RQ)) {
    const int row = q0 + e / (FG_COLS / 4), c4 = 4 * (e % (FG_COLS / 4));
    float4 v[MS];
#pragma unroll
    for (int q = 0; q < MS; ++q)
      if (q < slices) v[q] = *reinterpret_cast<const float4*>(part[q] + row * FG_RP + c4);
    float4 y = v[0];
#pragma unroll
    for (int q = 1; q < MS; ++q)
      if (q < slices) {
        y.x += v[q].x;
        y.y += v[q].y;
        y.z += v[q].z;
        y.w += v[q].w;
      }
    const size_t m = (size_t)gr0 + row;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 sv = jb.s != nullptr ? *reinterpret_cast<const float4*>(jb.s + lcol + c4) : zero;
    const float4 bv = jb.b != nullptr ? *reinterpret_cast<const float4*>(jb.b + lcol + c4) : zero;
    const float4 rv = (jb.epi == EPI_SILU_RESID || jb.epi == EPI_BIAS_RESID)
                          ? *reinterpret_cast<const float4*>(jb.resid + m * a.n + n0 + c4)
                          : zero;
    y = make_float4(fg_epi(y.x, jb, sv.x, bv.x, rv.x), fg_epi(y.y, jb, sv.y, bv.y, rv.y),
                    fg_epi(y.z, jb, sv.z, bv.z, rv.z), fg_epi(y.w, jb, sv.w, bv.w, rv.w));
    *reinterpret_cast<float4*>(out + m * a.n + n0 + c4) = y;
  }
  cluster.sync();    // every rank's sums stay until the others have read them
}

// The plan of one launch over M rows of X (K columns) through (K, N)
// weights, nz outputs: its K slices, the rows a pass, the passes a CTA, the
// groups and the shared memory (ops/decode_ops.py::f32_gemm_plan).
struct FgPlan {
  int slices, rq, pg, groups, smem;
};

inline FgPlan fg_plan(int m, int k, int n, int nz, bool w8) {
  FgPlan p;
  p.slices = fg_slices(k, n);
  p.rq = fg_rq(m);
  p.pg = fg_pg(m, n / FG_COLS * p.slices * nz);
  p.groups = fg_groups(m, p.pg);
  p.smem = fg_smem(p.rq, p.pg, w8);
  return p;
}

// X's map: M rows of K f32, boxes of 32 K x 4 RQ rows (rows past M zero).
inline int fg_x_map(CUtensorMap* mx, const float* x, int m, int k, int rq) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(float)};
  const cuuint32_t box[2] = {FG_KC, (cuuint32_t)(4 * rq)};
  return encode_map(mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, x, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// A weight's map over ``rows`` rows of N columns (a (nh or L, K, N) stack as
// nh K rows), f32 or int8; kept after the first call (a weight outlives it).
inline int fg_w_map(CUtensorMap* mw, const void* w, int rows, int n, bool w8) {
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n * (w8 ? 1 : sizeof(float))};
  const cuuint32_t box[2] = {w8 ? (cuuint32_t)FG_COLS : (cuuint32_t)FG_HALF, FG_KC};
  return encode_map_cached(mw, w8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                           2, w, dims, strides, box,
                           w8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

// Sets the launch's shared memory on its instantiation (above 48 KB it
// needs the attribute, which belongs to the current device's context).
inline int fg_set_smem(int rq, bool w8, int smem) {
#define WM_FG_SET(RQ)                                                                       \
  case RQ:                                                                                  \
    return (int)(w8 ? cudaFuncSetAttribute(ffma_gemm_kernel<RQ, true>,                      \
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) \
                    : cudaFuncSetAttribute(ffma_gemm_kernel<RQ, false>,                     \
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  switch (rq) {
    WM_FG_SET(1) WM_FG_SET(2) WM_FG_SET(3) WM_FG_SET(4) WM_FG_SET(5) WM_FG_SET(6)
    WM_FG_SET(7) WM_FG_SET(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WM_FG_SET
}

// One launch under programmatic dependent launch on maps already encoded
// (fg_x_map over M rows with the plan's rq, fg_w_map), nz outputs of the
// jobs in ``a`` (a.j, a.njobs set; the rest from m, k, n and the plan); the
// shared memory already set (fg_set_smem).
inline int fg_launch_maps(const CUtensorMap& mx, const CUtensorMap* mw, int nmaps, FgArgs a,
                          const FgPlan& p, int m, int k, int n, int nz, bool w8,
                          cudaStream_t st) {
  if ((long long)(n / FG_COLS) * p.groups > 65535 || nz > 65535 || a.njobs < 1 ||
      a.njobs > FG_MAX_JOBS || nz < a.njobs || nmaps < a.njobs)
    return (int)cudaErrorInvalidValue;
  a.m = m;
  a.k = k;
  a.n = n;
  a.passes = fg_passes(m);
  a.groups = p.groups;
  a.pg = p.pg;
  const CUtensorMap& w0 = mw[0];
  const CUtensorMap& w1 = mw[nmaps > 1 ? 1 : 0];
  const CUtensorMap& w2 = mw[nmaps > 2 ? 2 : 0];
  const dim3 grid(p.slices, n / FG_COLS * p.groups, nz);
  int err;
#define WM_FG(RQ)                                                                             \
  case RQ:                                                                                    \
    err = w8 ? launch_pdl(ffma_gemm_kernel<RQ, true>, grid, dim3(fg_threads(RQ)), p.smem,    \
                          p.slices, st, mx, w0, w1, w2, a)                                    \
             : launch_pdl(ffma_gemm_kernel<RQ, false>, grid, dim3(fg_threads(RQ)), p.smem,   \
                          p.slices, st, mx, w0, w1, w2, a);                                   \
    break;
  switch (p.rq) {
    WM_FG(1) WM_FG(2) WM_FG(3) WM_FG(4) WM_FG(5) WM_FG(6) WM_FG(7) WM_FG(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WM_FG
  return err != 0 ? err : (int)cudaGetLastError();
}

// out (nh, M, N) = epi(x (M, K) @ w (nh, K, N) (times s (nh, N) for an int8
// w, when s is given) + b (nh, N)) in one launch under programmatic
// dependent launch; b may be null, resid (M, N) for EPI_SILU_RESID.  K % 32
// == 0, N % 64 == 0, x, w, b, s, resid and out 16-byte aligned (the
// tensor-map encoder refuses another address: the entry then returns
// TENSOR_MAP_ERROR + its error).
inline int fg_launch(const float* x, const void* w, const float* s, const float* b,
                     const float* resid, float* out, int m, int k, int n, int nh, int epi,
                     cudaStream_t st) {
  const bool w8 = s != nullptr;
  if (m < 1 || k < FG_KC || k % FG_KC || n < FG_COLS || n % FG_COLS || nh < 1 ||
      (epi != EPI_BIAS && epi != EPI_BIAS_GELU && epi != EPI_SILU_RESID) ||
      (epi == EPI_SILU_RESID && resid == nullptr))
    return (int)cudaErrorInvalidValue;
  const FgPlan p = fg_plan(m, k, n, nh, w8);
  CUtensorMap mx, mw;
  int err = fg_x_map(&mx, x, m, k, p.rq);
  if (err == 0) err = fg_w_map(&mw, w, nh * k, n, w8);
  if (err != 0) return err;
  FgArgs a = {};
  a.j[0] = FgJob{b, s, resid, out, 1.0f, epi, 0};
  a.njobs = 1;
  // Per launch: the attribute belongs to the current device's context.
  err = fg_set_smem(p.rq, w8, p.smem);
  return err != 0 ? err : fg_launch_maps(mx, &mw, 1, a, p, m, k, n, nh, w8, st);
}

}  // namespace
}  // namespace wm
