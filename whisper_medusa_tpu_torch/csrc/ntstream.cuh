// The tied-embedding projection as a weight stream, shared by K7 (qmm.cu,
// int8 E) and K3 (logits.cu, bf16 E): Y[M, V] = X[M, D] @ E[V, D]^T in f32,
// times s[v] at int8, for M <= 192 rows.  Bound on H100: bytes, the
// embedding (51865 x 1280: 133 MB bf16, 66 MB int8) plus M x 207 KB of f32
// output; the rows are re-read from L2 by every tile.
//
//  * a persistent grid (as many CTAs as fit, an SM holding two to four at
//    M <= 32) walks the 811 vocab tiles of 64 entries; one producer warp
//    keeps a ring of mbarrier stages in flight through TMA, each the E tile
//    (64 entries x 64 K: bf16 as TMA writes it with the 128-byte swizzle,
//    8 KB; int8 raw, 4 KB) and the x tile of the same K chunk (ceil(M / 16)
//    * 16 rows, rows past M zero-filled: never 128 rows for ten);
//  * tensor cores from shared memory: wgmma with E as the 64-row A side and
//    the x tile as its N side, N = ceil(M / 16) * 16, one m64nNk16 product a
//    16-deep step (MT m64n16k16 products instead read the E tile from shared
//    memory MT times, and measured slower at M = 80 on the H100).  A bf16 E
//    tile is already the K-major swizzled layout wgmma reads; there is no
//    int8 x bf16 wgmma, so the consumer warpgroup converts an int8 E tile
//    once, exactly (|q| <= 127), into that layout (three buffers, so a
//    conversion never overwrites a tile a product still reads) and the
//    next tile's conversion overlaps this tile's products;
//  * the epilogue writes sum (bf16 E) or sum * s[v] (int8 E) straight from
//    the accumulators.  Each output is one chain of products over K in
//    order, the same instruction for every 16-row tile, so a row's bits do
//    not depend on M or on the grid (B = 8 gives each example its B = 1
//    drafts).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace wm {
namespace {   // internal linkage: every .cu gets its own copy

constexpr int NT_VT = 64;              // vocab rows per tile: wgmma's M side
constexpr int NT_KC = 64;              // K a ring stage holds
constexpr int NT_ERAW = NT_VT * NT_KC; // raw int8 E tile (64 entries x 64 K), bytes
constexpr int NT_EBF = NT_VT * NT_KC * 2;   // bf16 E tile, bytes
constexpr int NT_XT = 16 * NT_KC * 2;  // one 16-row x tile (64 K), bytes
constexpr int NT_WBUF = 3;             // converted bf16 E tiles (int8)
constexpr int NT_MAX_MT = 12;          // 16-row tiles a launch takes (192 rows)
constexpr int NT_THREADS = 160;        // 4 consumer warps + 1 producer warp

// Ring depth by row tiles.  int8: 8 stages (48 KB, three CTAs an SM) at one
// or two row tiles; 3 at three to six (two CTAs an SM, measured faster at
// M = 80 on the H100 than one CTA with 6 stages); 4 (112 KB) at seven to
// twelve.  bf16: 8 stages (80-96 KB, two CTAs an SM: 128 KB of E in flight)
// at one or two row tiles, 4 at three to five (three CTAs an SM), 3 past.
__host__ __device__ constexpr int nt_stages(int mt, bool w8) {
  return w8 ? (mt <= 2 ? 8 : (mt <= 6 ? 3 : 4)) : (mt <= 2 ? 8 : (mt <= 5 ? 4 : 3));
}

inline int nt_smem(int mt, bool w8) {
  const int s = nt_stages(mt, w8);
  return 1024 + s * (mt * NT_XT + (w8 ? NT_ERAW : NT_EBF)) + (w8 ? NT_WBUF * NT_EBF : 0) +
         16 * s;
}

// Persistent grid: CTA b takes vocab tiles b, b + grid, ...; for each, the
// 64-wide K chunks in order.  The producer warp streams (x tile, E tile)
// pairs through the ring without a break between vocab tiles; the consumer
// warpgroup (converting an int8 E tile exactly to bf16, K-major, 128-byte
// swizzle) runs one m64nNk16 product per 16-deep step (A the E tile, B the
// 16 MT-row x tile; both K-major; N = 16 MT), and at a tile's last chunk
// writes y = sum (* s[v] at int8) straight from them.  Each output's sum is
// the same chain of products whatever M or the grid is.
template <int MT, bool W8>
__global__ void __launch_bounds__(NT_THREADS)
nt_stream_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap me,
                 const float* __restrict__ scale, float* __restrict__ y, int m, int v,
                 int chunks, int tiles) {
  constexpr int S = nt_stages(MT, W8);
  constexpr int EB = W8 ? NT_ERAW : NT_EBF;   // E bytes a stage
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* xs = smem;                                  // S x MT x tiles of 16 rows
  char* wb = xs + S * MT * NT_XT;                   // NT_WBUF converted tiles (int8)
  char* eraw = wb + (W8 ? NT_WBUF * NT_EBF : 0);    // S E tiles as TMA writes them
  uint64_t* full = reinterpret_cast<uint64_t*>(eraw + S * EB);
  uint64_t* empty = full + S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * chunks;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {   // producer
    if (lane == 0) {
      for (int it = 0; it < total; ++it) {
        const int st = it % S, c = it % chunks;
        const int tile = blockIdx.x + (it / chunks) * gridDim.x;
        if (it >= S) mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
        mbar_arrive_tx(&full[st], MT * NT_XT + EB);
        tma_load_2d(xs + st * MT * NT_XT, &mx, &full[st], c * NT_KC, 0);
        tma_load_2d(eraw + st * EB, &me, &full[st], c * NT_KC, tile * NT_VT);
      }
    }
    return;
  }

  float acc[MT * 8];
  int pend = -1;
  for (int it = 0; it < total; ++it) {
    const int st = it % S, c = it % chunks;
    mbar_wait(&full[st], (it / S) & 1);
    char* wt = eraw + st * EB;
    if constexpr (W8) {
      // int8 (v, k) rows of 64 bytes -> bf16 rows of 128 bytes, chunk j of
      // row v stored at chunk j ^ (v % 8) (the 128-byte swizzle).
      wt = wb + (it % NT_WBUF) * NT_EBF;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = threadIdx.x + 128 * h, vr = idx >> 2, q = idx & 3;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(eraw + st * NT_ERAW + vr * 64 + q * 16);
        char* rowp = wt + vr * 128;
        *reinterpret_cast<uint4*>(rowp + (((2 * q) ^ (vr & 7)) * 16)) =
            i8x8_to_bf16(make_uint2(raw.x, raw.y));
        *reinterpret_cast<uint4*>(rowp + (((2 * q + 1) ^ (vr & 7)) * 16)) =
            i8x8_to_bf16(make_uint2(raw.z, raw.w));
      }
      fence_proxy_async();
      named_sync(1, 128);
    }
    const uint64_t adesc = sw128_desc(smem_addr(wt));
    const uint64_t bdesc = sw128_desc(smem_addr(xs + st * MT * NT_XT));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT_KC / 16; ++kk)
      WgmmaN<MT, 0, 0>::run(acc, adesc + 2 * kk, bdesc + 2 * kk, c > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (lane == 0 && pend >= 0) mbar_arrive(&empty[pend]);
    pend = st;
    if (c == chunks - 1) {     // the tile's sums are complete: write them
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[pend]);
      pend = -1;
      reg_fence(acc);
      // Element i of tile t: vocab row v0 + 16 warp + lane / 4 (+ 8), x row
      // 16 t + 8 (i / 4) + 2 (lane % 4) + i % 2.
      const int va = (blockIdx.x + (it / chunks) * gridDim.x) * NT_VT + 16 * warp + (lane >> 2);
      float sa = 1.0f, sb = 1.0f;
      if constexpr (W8) {
        sa = va < v ? scale[va] : 0.0f;
        sb = va + 8 < v ? scale[va + 8] : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = 16 * t + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int col = va + ((i & 2) ? 8 : 0);
          if (row < m && col < v) {
            if constexpr (W8)
              y[(size_t)row * v + col] = acc[8 * t + i] * ((i & 2) ? sb : sa);
            else
              y[(size_t)row * v + col] = acc[8 * t + i];
          }
        }
    }
  }
}

// x (m, d) bf16, m <= 192, e (v, d) bf16 or int8 (W8, with s (v,) f32) ->
// y (m, v) f32; d % 64 == 0; x and e 16-byte aligned (the tensor-map encoder
// refuses another address: the entry then returns TENSOR_MAP_ERROR + its
// error).  The vocab tiles (ceil(v / 64)) and K chunks (d / 64) come from
// the shapes alone (ops/qmm.py::nt_plan); the grid (CTAs an SM times the
// SMs) changes no sum.
template <bool W8>
int nt_launch(const void* x, const void* e, const void* s, void* y, int m, int v, int d,
              cudaStream_t stream) {
  if (m < 1 || m > 16 * NT_MAX_MT || v < 1 || d < NT_KC || d % NT_KC)
    return (int)cudaErrorInvalidValue;
  const int mt = (m + 15) / 16, tiles = (v + NT_VT - 1) / NT_VT;
  const cuuint64_t xdims[2] = {(cuuint64_t)d, (cuuint64_t)m};
  const cuuint64_t xstrides[1] = {(cuuint64_t)d * sizeof(bf16)};
  const cuuint32_t xbox[2] = {NT_KC, (cuuint32_t)(16 * mt)};
  const cuuint64_t edims[2] = {(cuuint64_t)d, (cuuint64_t)v};
  const cuuint64_t estrides[1] = {(cuuint64_t)d * (W8 ? 1 : sizeof(bf16))};
  const cuuint32_t ebox[2] = {NT_KC, NT_VT};
  CUtensorMap mx, me;
  int err = encode_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstrides, xbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = W8 ? encode_map(&me, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, e, edims, estrides, ebox,
                          CU_TENSOR_MAP_SWIZZLE_NONE)
             : encode_map(&me, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, e, edims, estrides, ebox,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  // The grid: as many CTAs as fit on the card, found once per device and row
  // tiles (the occupancy query costs host time on every call otherwise).
  constexpr int MAX_DEV = 16;
  static int fits[MAX_DEV][NT_MAX_MT + 1] = {};
  if (dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  const int smem = nt_smem(mt, W8);
  // Per launch: the attribute belongs to the current device's context.
#define WM_NT(MT)                                                                          \
  case MT: {                                                                               \
    cudaFuncSetAttribute(nt_stream_kernel<MT, W8>,                                         \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);               \
    if (fits[dev][MT] == 0) {                                                              \
      int sms = 0, per_sm = 0;                                                             \
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);                   \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nt_stream_kernel<MT, W8>,     \
                                                    NT_THREADS, smem);                     \
      fits[dev][MT] = (per_sm > 1 ? per_sm : 1) * sms;                                     \
    }                                                                                      \
    const int grid = tiles < fits[dev][MT] ? tiles : fits[dev][MT];                        \
    nt_stream_kernel<MT, W8><<<grid, NT_THREADS, smem, stream>>>(                          \
        mx, me, static_cast<const float*>(s), static_cast<float*>(y), m, v, d / NT_KC,     \
        tiles);                                                                            \
    break;                                                                                 \
  }
  switch (mt) {
    WM_NT(1) WM_NT(2) WM_NT(3) WM_NT(4) WM_NT(5) WM_NT(6)
    WM_NT(7) WM_NT(8) WM_NT(9) WM_NT(10) WM_NT(11) WM_NT(12)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WM_NT
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wm
