// The weight-streaming GEMM on wgmma, shared by K2's six projections
// (megastep.cu) and K11's fc1 and fc2 (decode_ops.cu): Y (M, N) =
// epilogue(X (M, K) @ W (K, N)) for M <= 192 rows, computed as
// Y^T = W^T X^T so that the weight gives wgmma's 64-row side and the rows
// its N side.  At decode sizes it is bound by the weight stream.
//
//  * a CTA takes 64 W columns (wgmma's 64-row A side, MN-major, 128-byte
//    swizzle) over one K slice; one producer warp streams the W tiles (64 K
//    x 64 columns, bf16 as TMA writes them, int8 raw and converted exactly
//    to bf16 in shared memory) and the matching X tiles (ceil(M / 16) * 16
//    rows x 64 K, rows past M zero-filled by TMA, from L2) through a ring
//    of mbarrier stages; one consumer warpgroup runs one m64nNk16 product
//    per 16-deep step, N = ceil(M / 16) * 16 (WgmmaN, up to 192); a row's
//    products are one chain in K order whatever M is (on the H100 an
//    element of wgmma does not depend on N: chip_smoke.py holds K2's B = 8
//    bitwise B = 1 and K11's M = 176 rows bitwise an M = 11 call);
//  * K is cut into slices from (K, N, jobs) alone (gemm_slices), enough for
//    132 CTAs and at most 8.  The slices of a column tile are one
//    thread-block cluster; each CTA leaves its f32 partial in shared memory
//    and rank r adds the slices for its share of the rows in rank order
//    through distributed shared memory, then runs the epilogue (bias, the
//    q scale, exact-erf GELU or the residual, rounded where the plain
//    version rounds).  One fixed order, no atomics, no scratch: a row's
//    bits do not depend on M or on what it is batched with;
//  * the weights come from 3-D tensor maps over (L, K, N) stacks (the layer
//    is a coordinate; one weight is L = 1 at layer 0).
//
// Every launch uses programmatic dependent launch (launch_pdl): the kernel
// lets the next one launch at its start (griddepcontrol.launch_dependents)
// and waits for the previous one (griddepcontrol.wait) before it touches
// what that one writes.  Before its wait it reads only weights and writes
// only its own shared memory, and its producer issues the first ring of
// weight loads there, so the weights stream while the kernel before it
// finishes.
#pragma once

#include <cooperative_groups.h>

#include <utility>

#include "common.cuh"
#include "hopper.cuh"

namespace wm {
namespace {   // internal linkage: every .cu gets its own copy

namespace cg = cooperative_groups;

constexpr int G_TILE = 64;             // W columns per CTA (wgmma's M side), K chunk
constexpr int G_RING = 96 * 1024;      // ring bytes a K2 CTA may hold at M <= 32
constexpr int G_RING_STAGES = 4;       // K2's ring stages past 32 rows
constexpr int G_THREADS = 160;         // 4 consumer warps + 1 producer warp
constexpr int G_WTILE = G_TILE * G_TILE * 2;   // bf16 W tile (64 K x 64 N), bytes
constexpr int G_WRAW = G_TILE * G_TILE;        // int8 W tile, bytes
constexpr int G_XT = 16 * G_TILE * 2;          // one 16-row X tile (64 K), bytes
constexpr int G_WBUF = 3;              // converted bf16 W tiles (int8)
constexpr int G_CTAS = 132;            // CTAs a projection aims for (the H100's SMs)
constexpr int G_MAX_SLICES = 8;        // K slices: the CTAs of one portable cluster
constexpr int G_RP = G_TILE + 4;       // f32 pitch of a CTA's partial in shared memory
constexpr int G_MAX_MT = 12;           // 16-row X tiles a launch takes (WgmmaN's N <= 192)

// The K slices of a projection: their number from (K, N, jobs) alone, never
// from M (ops/megastep.py::gemm_slices is the same rule).
__host__ __device__ inline int gemm_slices(int k, int n, int jobs) {
  const int chunks = k / G_TILE, tiles = jobs * (n / G_TILE);
  int want = (G_CTAS + tiles - 1) / tiles;
  if (want > G_MAX_SLICES) want = G_MAX_SLICES;
  if (want > chunks) want = chunks;
  return want < 1 ? 1 : want;
}
// Slice i covers 64-wide chunks [begin, end): fixed contiguous ranges.
__host__ __device__ inline int gemm_slice_begin(int chunks, int slices, int i) {
  const int base = chunks / slices, extra = chunks % slices;
  return i * base + (i < extra ? i : extra);
}

// The deepest ring a K2 CTA may hold at mt row tiles: G_RING bytes at up to
// two row tiles (a B = 1 chunk), G_RING_STAGES stages past them, where a
// deeper ring measured slower (fewer CTAs of the next kernels fit beside
// the running one, so less of their weights is in flight early).
inline int gemm_max_stages(int mt, bool w8) {
  return mt <= 2 ? G_RING / (mt * G_XT + (w8 ? G_WRAW : G_WTILE)) : G_RING_STAGES;
}

// Ring stages of a K2 projection: room for its longest K slice (so a CTA can
// hold all its weights before its wait), within gemm_max_stages, at least 2.
inline int gemm_stages(int k, int n, int jobs, int mt, bool w8) {
  const int slices = gemm_slices(k, n, jobs), chunks = k / G_TILE;
  const int longest = (chunks + slices - 1) / slices;
  const int fit = gemm_max_stages(mt, w8);
  const int s = longest < fit ? longest : fit;
  return s < 2 ? 2 : s;
}

// Dynamic shared memory of a CTA: the ring, the converted int8 tiles, the
// barriers and, with ``resid``, the residual rows of EPI_BIAS_RESID.
inline int gemm_smem(int mt, bool w8, int stages, bool resid = true) {
  return 1024 + stages * (mt * G_XT + (w8 ? G_WRAW : G_WTILE)) + (w8 ? G_WBUF * G_WTILE : 0) +
         16 * stages + (resid ? 16 * mt * G_TILE * 2 : 0);
}

// One output of a GEMM launch (up to three share X: q/k/v).
struct GemmJob {
  const bf16* bias;      // (N,) or null
  const float* wscale;   // (N,) f32 per-column scales (int8 W), or null
  const bf16* res;       // residual rows (ld = ldres) or null; may be out
  bf16* out;             // output rows (ld = ldo)
  int epi;
  float scale;
};
struct GemmJobs {
  GemmJob j[3];
};

inline GemmJob gjob(const bf16* bias, bf16* out, int epi, const bf16* res = nullptr,
                    float scale = 1.0f, const float* wscale = nullptr) {
  GemmJob j;
  j.bias = bias;
  j.wscale = wscale;
  j.res = res;
  j.out = out;
  j.epi = epi;
  j.scale = scale;
  return j;
}

// grid (slices, N / 64, jobs), clusters of (slices, 1, 1): the cluster's
// CTA of rank r computes W columns [64 y, + 64) of job z over K slice r;
// then rank r adds the slices' partials, in rank order, for its share of
// the rows and runs the epilogue.  The W tile is wgmma's A side (64 columns
// x 16 K, MN-major, 128-byte swizzle as TMA writes it: the bf16 tile
// directly, an int8 tile after an exact conversion in shared memory); the
// X tile (16 MT rows, K-major) its N side, one m64nNk16 product a 16-deep
// step.  mx: X (M rows, K) bf16, box (64, 16 MT), rows past M zero-filled;
// mw0..2: the jobs' W stacks (L, K, N), box (64, 64, 1), at layer ``layer``.
// The residual rows (EPI_BIAS_RESID only) are staged past the barriers.
//
// Programmatic dependent launch: before griddep_wait a kernel reads only
// weights and writes only its own shared memory.  The producer issues its
// first ring of W loads before the wait, so the weights stream while the
// previous kernel finishes; X, biases, residuals and outputs come after.
template <int MT, bool W8>
__global__ void __launch_bounds__(G_THREADS)
wgemm_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw0,
             const __grid_constant__ CUtensorMap mw1, const __grid_constant__ CUtensorMap mw2,
             const GemmJobs jobs, int layer, int m_rows, int chunks, int stages, int ldo,
             int ldres) {
  griddep_launch();
  cg::cluster_group cluster = cg::this_cluster();
  const int slices = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int z = blockIdx.z, n0 = blockIdx.y * G_TILE;
  const CUtensorMap* mw = z == 0 ? &mw0 : (z == 1 ? &mw1 : &mw2);
  const GemmJob jb = z == 0 ? jobs.j[0] : (z == 1 ? jobs.j[1] : jobs.j[2]);
  const int c_first = gemm_slice_begin(chunks, slices, rank);
  const int nch = gemm_slice_begin(chunks, slices, rank + 1) - c_first;
  constexpr int WB = W8 ? G_WRAW : G_WTILE;   // W bytes a stage

  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* xs = smem;                                   // stages x MT X tiles
  char* ws = xs + stages * MT * G_XT;                // stages W tiles (raw at int8)
  char* wb = ws + stages * WB;                       // G_WBUF converted tiles (int8)
  uint64_t* full = reinterpret_cast<uint64_t*>(wb + (W8 ? G_WBUF * G_WTILE : 0));
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // The epilogue's per-column operands (weights: loaded before the wait)
  // and this rank's residual rows (after it).
  __shared__ float col_bias[G_TILE], col_scale[G_TILE];
  bf16* res_rows = reinterpret_cast<bf16*>(empty + stages);   // <= 16 MT rows x 64
  const int per = (m_rows + slices - 1) / slices, r0 = rank * per;
  const int r1 = r0 + per < m_rows ? r0 + per : m_rows;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int pre = nch < stages ? nch : stages;
  if (warp == 4 && lane == 0) {   // the weights of the first stages: no wait
    for (int it = 0; it < pre; ++it) {
      mbar_arrive_tx(&full[it], WB + MT * G_XT);
      tma_load_3d(ws + it * WB, mw, &full[it], n0, (c_first + it) * G_TILE, layer);
    }
  }
  if (threadIdx.x < G_TILE) {
    col_bias[threadIdx.x] = jb.bias ? bf2f(jb.bias[n0 + threadIdx.x]) : 0.0f;
    col_scale[threadIdx.x] = W8 ? jb.wscale[n0 + threadIdx.x] : 1.0f;
  }
  griddep_wait();

  float acc[MT * 8];
  if (warp == 4) {   // producer; lanes 1-31 stage the residual rows meanwhile
    if (lane != 0 && jb.epi == EPI_BIAS_RESID) {
      for (int i = lane - 1; i < (r1 - r0) * (G_TILE / 8); i += 31) {
        const int m = r0 + i / (G_TILE / 8), c8 = (i % (G_TILE / 8)) * 8;
        *reinterpret_cast<uint4*>(&res_rows[(m - r0) * G_TILE + c8]) =
            *reinterpret_cast<const uint4*>(jb.res + (size_t)m * ldres + n0 + c8);
      }
    }
    if (lane == 0) {
      for (int it = 0; it < pre; ++it)
        tma_load_2d(xs + it * MT * G_XT, &mx, &full[it], (c_first + it) * G_TILE, 0);
      for (int it = pre; it < nch; ++it) {
        const int st = it % stages, c = c_first + it;
        mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
        mbar_arrive_tx(&full[st], WB + MT * G_XT);
        tma_load_3d(ws + st * WB, mw, &full[st], n0, c * G_TILE, layer);
        tma_load_2d(xs + st * MT * G_XT, &mx, &full[st], c * G_TILE, 0);
      }
    }
  } else {
    int pend = -1;
    for (int it = 0; it < nch; ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      char* wt = ws + st * WB;
      if constexpr (W8) {
        // int8 (k, n) rows of 64 bytes -> bf16 rows of 128 bytes, chunk j of
        // row k stored at chunk j ^ (k % 8) (the 128-byte swizzle).
        char* cv = wb + (it % G_WBUF) * G_WTILE;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int idx = threadIdx.x + 128 * h, kr = idx >> 2, q = idx & 3;
          const uint4 raw = *reinterpret_cast<const uint4*>(wt + kr * 64 + q * 16);
          char* rowp = cv + kr * 128;
          *reinterpret_cast<uint4*>(rowp + (((2 * q) ^ (kr & 7)) * 16)) =
              i8x8_to_bf16(make_uint2(raw.x, raw.y));
          *reinterpret_cast<uint4*>(rowp + (((2 * q + 1) ^ (kr & 7)) * 16)) =
              i8x8_to_bf16(make_uint2(raw.z, raw.w));
        }
        fence_proxy_async();
        named_sync(1, 128);
        wt = cv;
      }
      const uint64_t adesc = sw128_desc(smem_addr(wt));
      const uint64_t bdesc = sw128_desc(smem_addr(xs + st * MT * G_XT));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G_TILE / 16; ++kk)
        WgmmaN<MT, 1, 0>::run(acc, adesc + 128 * kk, bdesc + 2 * kk, it > 0 || kk > 0);
      wgmma_commit();
      // The previous chunk's products are done: its stage goes back to the
      // producer (at int8 the raw tile was read by the conversion already).
      wgmma_wait<1>();
      if (lane == 0 && pend >= 0) mbar_arrive(&empty[pend]);
      pend = st;
    }
    wgmma_wait<0>();
    reg_fence(acc);
  }
  __syncthreads();   // every product has read its tiles: the ring is free

  // This slice's partial (X rows x 64 W columns, f32) over the ring.
  float* red = reinterpret_cast<float*>(smem);
  if (warp < 4) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = 16 * t + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        red[row * G_RP + 16 * warp + (lane >> 2) + ((i & 2) ? 8 : 0)] = acc[8 * t + i];
      }
  }
  cluster.sync();    // the partials, and the staged residual rows, are visible
  // Rank r: rows [r * per, + per); the slices added in rank order, every
  // rank's value read before the first add.
  const float* part[G_MAX_SLICES];
#pragma unroll
  for (int q = 0; q < G_MAX_SLICES; ++q)
    part[q] = cluster.map_shared_rank(red, q < slices ? q : 0);
  for (int e = threadIdx.x; e < (r1 - r0) * G_TILE; e += G_THREADS) {
    const int m = r0 + e / G_TILE, col = e % G_TILE;
    float v[G_MAX_SLICES];
#pragma unroll
    for (int q = 0; q < G_MAX_SLICES; ++q) v[q] = q < slices ? part[q][m * G_RP + col] : 0.0f;
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < G_MAX_SLICES; ++q)
      if (q < slices) sum += v[q];
    if constexpr (W8) sum *= col_scale[col];
    if (jb.bias) sum += col_bias[col];
    float r;
    switch (jb.epi) {
      case EPI_BIAS_SCALE: r = bfr(sum) * jb.scale; break;
      case EPI_BIAS_GELU: r = gelu_erf(sum); break;
      case EPI_BIAS_RESID: r = bf2f(res_rows[(m - r0) * G_TILE + col]) + bfr(sum); break;
      default: r = sum;
    }
    jb.out[(size_t)m * ldo + n0 + col] = f2bf(r);
  }
  cluster.sync();    // every rank's partial stays until the others have read it
}

// Launches one kernel after the previous one in the stream with
// programmatic stream serialization (its CTAs may start early and run up to
// their griddep_wait), in clusters of ``cluster`` CTAs along x when > 0.
template <typename... KArgs, typename... Args>
int launch_pdl(void (*kern)(KArgs...), dim3 grid, dim3 block, size_t smem, int cluster,
               cudaStream_t st, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  int n = 1;
  if (cluster > 0) {
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = cluster;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = 1;
    n = 2;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return (int)cudaLaunchKernelEx(&cfg, kern, std::forward<Args>(args)...);
}

// The X operand of a GEMM: M rows of k bf16 columns, 16 MT-row boxes (rows
// past M read as zero).
inline int encode_x_map(CUtensorMap* map, const bf16* x, int m, int k, int mt) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(bf16)};
  const cuuint32_t box[2] = {G_TILE, (cuuint32_t)(16 * mt)};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// One projection: Y (M, N) = epilogue(X (M, K) @ W[layer]) for ``njobs``
// jobs sharing X, as wgemm_kernel<mt, W8> with mt in [MT, MAXMT]; ``stages``
// ring stages and ``smem`` bytes (gemm_smem), the K slices from gemm_slices.
template <int MAXMT, bool W8, int MT = 1>
int wgemm_launch(int mt, int stages, size_t smem, cudaStream_t st, const CUtensorMap& mx,
                 const CUtensorMap& w0, const CUtensorMap& w1, const CUtensorMap& w2,
                 int njobs, const GemmJobs& jobs, int layer, int m, int k, int n, int ldo,
                 int ldres) {
  static_assert(MAXMT <= G_MAX_MT, "WgmmaN takes N <= 192");
  if (mt == MT) {
    const int slices = gemm_slices(k, n, njobs);
    return launch_pdl(wgemm_kernel<MT, W8>, dim3(slices, n / G_TILE, njobs), dim3(G_THREADS),
                      smem, slices, st, mx, w0, w1, w2, jobs, layer, m, k / G_TILE, stages,
                      ldo, ldres);
  }
  if constexpr (MT < MAXMT)
    return wgemm_launch<MAXMT, W8, MT + 1>(mt, stages, smem, st, mx, w0, w1, w2, njobs, jobs,
                                           layer, m, k, n, ldo, ldres);
  return (int)cudaErrorInvalidValue;
}

// Shared memory above 48 KB for wgemm_kernel<mt, W8>, mt in [MT, MAXMT]
// (per call: the attribute belongs to the current device's context).
template <int MAXMT, bool W8, int MT = 1>
void wgemm_set_smem(int mt, int smem) {
  if (mt == MT) {
    cudaFuncSetAttribute(wgemm_kernel<MT, W8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    return;
  }
  if constexpr (MT < MAXMT) wgemm_set_smem<MAXMT, W8, MT + 1>(mt, smem);
}

}  // namespace
}  // namespace wm
