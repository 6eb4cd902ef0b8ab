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
//    is a coordinate; one weight is L = 1 at layer 0);
//  * LN mode (K2's q/k/v, cross q and fc1): X is the raw residual stream
//    and the kernel applies the layer norm before it (replacing a kernel
//    launch per norm).  The slices of a column tile span K, so each CTA
//    takes two passes in f32 over its own slice of each row (from L2: at
//    B = 8 the ring does not hold the slice), leaves the slice's (mean, M2)
//    in shared memory, and after one cluster barrier every rank combines the
//    slices' partials in rank order (Chan's pairwise formula) into the row's
//    mean and rstd = rsqrt(M2 / K + 1e-5).  The consumers then rewrite each
//    X tile's rows m < M in place, bf16((x - mean) * rstd * s[k] + b[k]),
//    before its products.  A row's statistics depend on the row and (K, N,
//    jobs) alone, never on M; no extra launch, no scratch.
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
constexpr int G_LN_LANES = 8;          // LN mode: lanes that sum one row's slice
constexpr int G_LN_MAXP = 10;          // LN mode: 16-byte pieces a lane holds (K slice <= 640)

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

// LN mode's arithmetic on a 16-byte piece of 8 bf16: their sum as a
// pairwise tree ((e0 + e1) + (e2 + e3)) + ((e4 + e5) + (e6 + e7)), the same
// tree over their squared deviations from ``mean``, and the norm
// bf16((x - mean) * rstd * s + b) in ln_rows's order of operations.
__device__ __forceinline__ float tree8(const float (&e)[8]) {
  return ((e[0] + e[1]) + (e[2] + e[3])) + ((e[4] + e[5]) + (e[6] + e[7]));
}
__device__ __forceinline__ void unpack8_bf16(uint4 v, float (&e)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    e[2 * i] = f.x;
    e[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float sum8_bf16(uint4 v) {
  float e[8];
  unpack8_bf16(v, e);
  return tree8(e);
}
__device__ __forceinline__ float sqdev8_bf16(uint4 v, float mean) {
  float e[8];
  unpack8_bf16(v, e);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = (e[i] - mean) * (e[i] - mean);
  return tree8(e);
}
__device__ __forceinline__ uint4 ln8_bf16(uint4 v, float2 mean_rstd, const float* s,
                                          const float* b) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[i] = pack_bf2((f.x - mean_rstd.x) * mean_rstd.y * s[2 * i] + b[2 * i],
                      (f.y - mean_rstd.x) * mean_rstd.y * s[2 * i + 1] + b[2 * i + 1]);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
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

// Elements of the longest K slice: the LN scale and bias a CTA keeps.
inline int gemm_ln_k(int k, int n, int jobs) {
  const int slices = gemm_slices(k, n, jobs);
  return (k / G_TILE + slices - 1) / slices * G_TILE;
}

// Dynamic shared memory of a CTA: the ring, the converted int8 tiles, the
// barriers, with ``resid`` the residual rows of EPI_BIAS_RESID and, in LN
// mode (``ln_k`` = gemm_ln_k > 0), each row's partial and final statistics
// and the slice's scale and bias in f32.
inline int gemm_smem(int mt, bool w8, int stages, bool resid = true, int ln_k = 0) {
  return 1024 + stages * (mt * G_XT + (w8 ? G_WRAW : G_WTILE)) + (w8 ? G_WBUF * G_WTILE : 0) +
         16 * stages + (resid || ln_k ? 16 * mt * G_TILE * 2 : 0) +
         (ln_k ? 16 * 16 * mt + 8 * ln_k : 0);
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
// LN mode's operands: X (M, K) as plain rows for the statistics, and the
// norm's (K,) scale and bias; a trailing kernel argument that the other
// instantiations leave unread (their code is the plain GEMM's).
struct LnArgs {
  const bf16 *x, *s, *b;
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
//
// LN: X is normalized first (see the header); the norm's scale and bias are
// weights, loaded before the wait.  Rows m < M of a stage's X tile are
// rewritten in place once it has landed: the producer refills a stage only
// after every consumer warp's products of its previous use are done, so no
// product still reads a tile being rewritten.
template <int MT, bool W8, bool LN>
__global__ void __launch_bounds__(G_THREADS)
wgemm_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw0,
             const __grid_constant__ CUtensorMap mw1, const __grid_constant__ CUtensorMap mw2,
             const GemmJobs jobs, int layer, int m_rows, int chunks, int stages, int ldo,
             int ldres, const LnArgs lna) {
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
  // LN mode, past the residual rows: each row's (mean, M2) over this slice
  // (at the same offset in every rank), its (mean, rstd) over K, and the
  // slice's scale and bias.
  float2* ln_part = reinterpret_cast<float2*>(res_rows + 16 * MT * G_TILE);
  float2* ln_row = ln_part + 16 * MT;
  float* ln_s = reinterpret_cast<float*>(ln_row + 16 * MT);
  float* ln_b = ln_s + nch * G_TILE;

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
  if constexpr (LN) {   // the slice's scale and bias, 8 of each a thread (nch * 8 <= 80)
    for (int i = threadIdx.x; i < nch * 8; i += G_THREADS) {
      const size_t at = (size_t)c_first * G_TILE + 8 * i;
      float es[8], eb[8];
      unpack8_bf16(*reinterpret_cast<const uint4*>(lna.s + at), es);
      unpack8_bf16(*reinterpret_cast<const uint4*>(lna.b + at), eb);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ln_s[8 * i + e] = es[e];
        ln_b[8 * i + e] = eb[e];
      }
    }
  }
  griddep_wait();

  if constexpr (LN) {
    if (warp == 4 && lane == 0)   // the first stages' raw X tiles, while the stats run
      for (int it = 0; it < pre; ++it)
        tma_load_2d(xs + it * MT * G_XT, &mx, &full[it], (c_first + it) * G_TILE, 0);
    // This slice's (mean, M2) of each row: G_LN_LANES lanes a row, lane l
    // holding its nch 16-byte pieces l, l + G_LN_LANES, ... in registers
    // (every load of the row in flight at once), adding them in order, then
    // a butterfly over the lanes; the same again over the squared deviations
    // from the slice's mean (ops/megastep.py::ln_fold_stats mirrors it).
    const int k = chunks * G_TILE, gl = threadIdx.x % G_LN_LANES;
    const float cnt = (float)(nch * G_TILE);
    for (int m0 = 0; m0 < m_rows; m0 += G_THREADS / G_LN_LANES) {
      const int m = m0 + threadIdx.x / G_LN_LANES;
      // Loads without branches, so that they issue back to back: a row past
      // M reads row 0, a piece past nch piece 0, and neither is used.
      const uint4* xr = reinterpret_cast<const uint4*>(
          lna.x + (size_t)(m < m_rows ? m : 0) * k + c_first * G_TILE) + gl;
      uint4 v[G_LN_MAXP];
#pragma unroll
      for (int i = 0; i < G_LN_MAXP; ++i) v[i] = xr[G_LN_LANES * (i < nch ? i : 0)];
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < G_LN_MAXP; ++i)
        if (i < nch) sum += sum8_bf16(v[i]);
#pragma unroll
      for (int o = 1; o < G_LN_LANES; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mean = sum / cnt;
      float m2 = 0.0f;
#pragma unroll
      for (int i = 0; i < G_LN_MAXP; ++i)
        if (i < nch) m2 += sqdev8_bf16(v[i], mean);
#pragma unroll
      for (int o = 1; o < G_LN_LANES; o <<= 1) m2 += __shfl_xor_sync(0xffffffffu, m2, o);
      if (m < m_rows && gl == 0) ln_part[m] = make_float2(mean, m2);
    }
    cluster_arrive();   // this rank's partials, released to the cluster
    // Chan's weights for adding slice q (they read the counts alone), while
    // the other ranks arrive.
    float w_mean[G_MAX_SLICES], w_m2[G_MAX_SLICES];
    {
      float n = (float)(gemm_slice_begin(chunks, slices, 1) * G_TILE);
#pragma unroll
      for (int q = 1; q < G_MAX_SLICES; ++q) {
        const float nq = (float)((gemm_slice_begin(chunks, slices, q + 1) -
                                  gemm_slice_begin(chunks, slices, q)) * G_TILE);
        const float tot = n + nq;
        w_mean[q] = nq / tot;
        w_m2[q] = n * nq / tot;
        n = tot;
      }
    }
    cluster_wait();     // every rank's partials are visible
    // Each row over K: the slices in rank order (every rank the same way),
    // every rank's partial read before the first step.
    for (int m = threadIdx.x; m < m_rows; m += G_THREADS) {
      float2 part[G_MAX_SLICES];
#pragma unroll
      for (int q = 0; q < G_MAX_SLICES; ++q)
        if (q < slices) part[q] = cluster.map_shared_rank(ln_part, q)[m];
      float2 all = part[0];   // (mean, M2)
#pragma unroll
      for (int q = 1; q < G_MAX_SLICES; ++q) {
        if (q >= slices) break;
        const float delta = part[q].x - all.x;
        all.x += delta * w_mean[q];
        all.y += part[q].y + delta * delta * w_m2[q];
      }
      ln_row[m] = make_float2(all.x, rsqrtf(all.y / (float)k + 1e-5f));
    }
    __syncthreads();
  }

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
      if constexpr (!LN)
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
    // LN: rows m < M of stage st's X tile (chunk it of the slice), in
    // place: element k of row r lies in 16-byte chunk (k / 8) ^ (r % 8)
    // (the 128-byte swizzle); rows past M stay zero.  A thread takes 16-byte
    // column p of rows q, q + 16, ...: the same logical chunk j of every
    // one, so its scale and bias once.
    auto ln_tile = [&](int st, int it) {
      char* xt = xs + st * MT * G_XT;
      const int p = threadIdx.x & 7, q = threadIdx.x >> 3, j = p ^ (q & 7);
      const float* cs = ln_s + it * G_TILE + 8 * j;
      const float* cb = ln_b + it * G_TILE + 8 * j;
      float sv[8], bv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sv[e] = cs[e];
        bv[e] = cb[e];
      }
      for (int r = q; r < m_rows; r += 16) {
        uint4* piece = reinterpret_cast<uint4*>(xt + r * 128 + p * 16);
        *piece = ln8_bf16(*piece, ln_row[r], sv, bv);
      }
    };
    int pend = -1;
    for (int it = 0; it < nch; ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      char* wt = ws + st * WB;
      if constexpr (LN) ln_tile(st, it);
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
      } else if constexpr (LN) {
        fence_proxy_async();
        named_sync(1, 128);
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
// jobs sharing X, as wgemm_kernel<mt, W8, LN> with mt in [MT, MAXMT];
// ``stages`` ring stages and ``smem`` bytes (gemm_smem), the K slices from
// gemm_slices.
template <int MAXMT, bool W8, bool LN = false, int MT = 1>
int wgemm_launch(int mt, int stages, size_t smem, cudaStream_t st, const CUtensorMap& mx,
                 const CUtensorMap& w0, const CUtensorMap& w1, const CUtensorMap& w2,
                 int njobs, const GemmJobs& jobs, int layer, int m, int k, int n, int ldo,
                 int ldres, const LnArgs& lna = LnArgs{}) {
  static_assert(MAXMT <= G_MAX_MT, "WgmmaN takes N <= 192");
  if (mt == MT) {
    const int slices = gemm_slices(k, n, njobs);
    return launch_pdl(wgemm_kernel<MT, W8, LN>, dim3(slices, n / G_TILE, njobs), dim3(G_THREADS),
                      smem, slices, st, mx, w0, w1, w2, jobs, layer, m, k / G_TILE, stages,
                      ldo, ldres, lna);
  }
  if constexpr (MT < MAXMT)
    return wgemm_launch<MAXMT, W8, LN, MT + 1>(mt, stages, smem, st, mx, w0, w1, w2, njobs,
                                               jobs, layer, m, k, n, ldo, ldres, lna);
  return (int)cudaErrorInvalidValue;
}

// Shared memory above 48 KB for wgemm_kernel<mt, W8, LN>, mt in [MT, MAXMT]
// (per call: the attribute belongs to the current device's context).
template <int MAXMT, bool W8, bool LN = false, int MT = 1>
void wgemm_set_smem(int mt, int smem) {
  if (mt == MT) {
    cudaFuncSetAttribute(wgemm_kernel<MT, W8, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    return;
  }
  if constexpr (MT < MAXMT) wgemm_set_smem<MAXMT, W8, LN, MT + 1>(mt, smem);
}

}  // namespace
}  // namespace wm
