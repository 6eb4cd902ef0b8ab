// K6 — Y[M, N] = (bf16(X[M, K]) @ bf16(Wq[K, N])) * s[N], f32 out, and
// K7 — Y[M, V] = (bf16(X[M, D]) @ bf16(Eq[V, D])^T) * s[V], f32 out: the int8
// weight-only (W8A16) products of int8 serving.
//
// K6 replaces whisper_medusa_tpu/ops/qmm.py::_qmm_kernel (TPU, launched by
// qmm), which keeps all of x in VMEM and streams 512-column weight blocks,
// converting them to bf16 in VMEM.  On Hopper it computes Y^T = W^T x^T on
// wgmma (hopper.cuh), A and B swapped so that the weight gives wgmma's
// 64-row M side and the batch rows its N side:
//
//  * one CTA per (64 weight columns, 64 R rows of x, K range): one consumer
//    warpgroup (warps 0-3) and one producer warp (warp 4).  The producer
//    keeps Q_STAGES stages in flight through TMA: the x tile (64 R rows x 64
//    K, bf16, 128-byte swizzle, rows past M zero-filled) and the raw int8
//    weight tile (64 K x 64 columns);
//  * the consumers convert each int8 tile exactly to bf16 (|q| <= 127) into
//    a swizzled bf16 tile (three buffers, so a conversion never overwrites
//    a tile a product still reads), then run R x 4 wgmma m64n64k16 (A the
//    converted weight, MN-major; B the x tile, K-major), asynchronously: the
//    next tile's conversion overlaps this tile's products;
//  * K is cut into slices chosen from (K, N) alone (qmm_slices: enough for
//    132 CTAs at one row tile, in fixed contiguous ranges of 64-wide
//    chunks).  Each slice is summed from zero in f32 by wgmma, and the slices
//    are added in order, (p0 + p1) + p2 ..., then multiplied by s[n].  When
//    the grid of (column tiles x row tiles) fills half the card (M = 1500:
//    240 CTAs of 128 rows; M = 176 at N = 5120: 240 CTAs of 64 rows) one CTA
//    adds its slices in registers; when it is smaller (M = 16, or N = 1280
//    at M = 176) each CTA computes one slice of up to 256 rows into f32
//    scratch and a second kernel adds the slices in the same order.  Both
//    give the same bits, so a row's result does not depend on M or on what
//    it is batched with; no atomics.
//
// A warpgroup's loop over its chunks is one serial chain (wait for the
// tiles, convert, fence, barrier, products), and more warpgroups on an SM
// is what shortens it: a deeper ring, or a second consumer warpgroup
// sharing the x tile, did not make the kernel faster; three stages (two or
// more CTAs an SM) and 64-row tiles at decode sizes did.
//
// On the decode path it projects each example's encoder output (1500 x
// 1280) into the cross K and V of every layer (init_cache), and runs the
// int8 projections and FFN of the per-op step (M = B T <= 176).  Bound on
// H100: at (1500, 1280, 1280) the 4.9 GFLOP of products (5 us at 989
// TFLOP/s) over its 13.2 MB (4 us at 3.35 TB/s); at decode sizes the int8
// weight stream (1.6 MB at 1280 x 1280, 6.6 MB at 1280 x 5120), which the
// K slices spread over the whole card.
//
// K7 replaces whisper_medusa_tpu/ops/qmm.py::_qmm_nt_kernel (TPU, launched
// by qmm_nt), the int8 tied-embedding projection of the prefill, the draft
// heads at B >= 2 and language detection: M = 10 rows at B = 1, 80 at B = 8.
// Bound on H100: bytes, the 66 MB int8 embedding (51865 x 1280) plus M x
// 207 KB of f32 output (20.5 us at M = 10).  It is a weight stream:
//
//  * a persistent grid (as many CTAs as fit, an SM holding two to four at
//    M <= 32) walks the 811 vocab tiles of 64 entries; one producer warp
//    keeps a ring of 4-8 mbarrier stages in flight through TMA, each the raw
//    int8 E tile (64 entries x 64 K, 4 KB) and the x tile of the same K
//    chunk (ceil(M / 16) * 16 rows, rows past M zero-filled: never 128 rows
//    for ten), 32-48 KB of E in flight an SM at M <= 32;
//  * tensor cores from shared memory: there is no int8 x bf16 wgmma, so the
//    consumer warpgroup converts each E tile once, exactly (|q| <= 127),
//    into a K-major 128-byte-swizzled bf16 tile and runs wgmma with E as
//    the 64-row A side and the x tile as its N side, N = ceil(M / 16) * 16:
//    one m64nNk16 product a 16-deep step (MT m64n16k16 products instead read
//    the E tile from shared memory MT times, and measured slower at M = 80
//    on the H100).
//    wgmma rather than mma.sync on register-converted fragments: the
//    products run asynchronously, so the next tile's conversion overlaps
//    them, and the conversion, ring and descriptors are K6's, already held
//    against their plain versions on the card;
//  * the epilogue multiplies by s[v] and writes straight from the
//    accumulators.  Each output is one chain of products over K in order,
//    the same instruction for every 16-row tile, so a row's bits do not
//    depend on M (B = 8 gives each example its B = 1 drafts).
#include "common.cuh"
#include "hopper.cuh"

namespace wm {
namespace {

constexpr int QT = 64;                  // K chunk, weight columns per CTA, rows per R
constexpr int Q_STAGES = 3;             // TMA ring depth (at R <= 3, two or more CTAs an SM)
constexpr int Q_WBUF = 3;               // converted bf16 weight tiles
constexpr int Q_THREADS = 160;          // 4 consumer warps + 1 producer warp
constexpr int Q_XTILE = QT * QT * 2;    // 64 rows of x, bytes
constexpr int Q_WRAW = QT * QT;         // int8 weight tile, bytes
constexpr int Q_WTILE = QT * QT * 2;    // converted weight tile, bytes
constexpr int Q_CTAS = 132;             // CTAs the K slices aim for (one per SM)
constexpr int Q_MAX_ROWS = 256;         // rows a one-slice CTA takes (R <= 4)

inline int qmm_smem(int r) {
  return 1024 + Q_STAGES * (r * Q_XTILE + Q_WRAW) + Q_WBUF * Q_WTILE + 8 * 2 * Q_STAGES;
}

// The K slices of a (K, N) weight: their number, from (K, N) alone.
__host__ __device__ inline int qmm_slices(int k, int n) {
  const int chunks = k / QT, want = (Q_CTAS + n / QT - 1) / (n / QT);
  return want < 1 ? 1 : (want > chunks ? chunks : want);
}
// Slice i covers 64-wide chunks [begin, end): fixed contiguous ranges.
__device__ __forceinline__ int slice_begin(int chunks, int slices, int i) {
  const int base = chunks / slices, extra = chunks % slices;
  return i * base + min(i, extra);
}

struct QmmPlan {
  int slices;   // K slices (qmm_slices)
  int split;    // 1: one slice per CTA into scratch, then qmm_reduce_kernel
  int r;        // 64-row x tiles per CTA
  int mt;       // row tiles
};

inline QmmPlan qmm_plan(int m, int k, int n) {
  QmmPlan p;
  p.slices = qmm_slices(k, n);
  const int tiles = n / QT;
  p.r = m > 4 * QT ? 2 : 1;         // 64-row tiles for decode sizes: more CTAs
  p.mt = (m + QT * p.r - 1) / (QT * p.r);
  p.split = p.slices > 1 && tiles * p.mt < Q_CTAS / 2;
  if (p.split) {
    const int tiles_m = (m + QT - 1) / QT;
    p.r = tiles_m < Q_MAX_ROWS / QT ? tiles_m : Q_MAX_ROWS / QT;
    p.mt = (m + QT * p.r - 1) / (QT * p.r);
  }
  return p;
}

// grid (N / 64, row tiles, SPLIT ? slices : 1).  SPLIT: out is the (slices,
// M, N) f32 scratch and each CTA writes its slice unscaled; otherwise out is
// Y and each CTA adds all slices in registers and applies the scales.
template <int R, bool SPLIT>
__global__ void __launch_bounds__(Q_THREADS)
qmm_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
           const float* __restrict__ scale, float* __restrict__ out, int m, int n,
           int chunks, int slices) {
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* xs = smem;                                        // Q_STAGES x R x 64 rows
  char* wb = xs + Q_STAGES * R * Q_XTILE;                 // Q_WBUF converted tiles
  char* wraw = wb + Q_WBUF * Q_WTILE;                     // Q_STAGES raw int8 tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(wraw + Q_STAGES * Q_WRAW);
  uint64_t* empty = full + Q_STAGES;

  const int n0 = blockIdx.x * QT, m0 = blockIdx.y * QT * R;
  const int s_first = SPLIT ? blockIdx.z : 0, s_end = SPLIT ? blockIdx.z + 1 : slices;
  const int c_first = slice_begin(chunks, slices, s_first);
  const int c_end = slice_begin(chunks, slices, s_end);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < Q_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {   // producer
    if (lane == 0) {
      for (int c = c_first, it = 0; c < c_end; ++c, ++it) {
        const int st = it % Q_STAGES;
        if (it >= Q_STAGES) mbar_wait(&empty[st], ((it / Q_STAGES) & 1) ^ 1);
        mbar_arrive_tx(&full[st], R * Q_XTILE + Q_WRAW);
        tma_load_2d(xs + st * R * Q_XTILE, &mx, &full[st], c * QT, m0);
        tma_load_2d(wraw + st * Q_WRAW, &mw, &full[st], n0, c * QT);
      }
    }
    return;
  }

  float acc[R][32], tot[SPLIT ? 1 : R][32];
  int it = 0, pend = -1;
  for (int sl = s_first; sl < s_end; ++sl) {
    const int cb = slice_begin(chunks, slices, sl), ce = slice_begin(chunks, slices, sl + 1);
    for (int c = cb; c < ce; ++c, ++it) {
      const int st = it % Q_STAGES;
      mbar_wait(&full[st], (it / Q_STAGES) & 1);
      // int8 (k, n) rows of 64 bytes -> bf16 rows of 128 bytes, chunk j of
      // row k stored at chunk j ^ (k % 8) (the 128-byte swizzle).
      char* wt = wb + (it % Q_WBUF) * Q_WTILE;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = threadIdx.x + 128 * h, kr = idx >> 2, q = idx & 3;
        const uint4 raw = *reinterpret_cast<const uint4*>(wraw + st * Q_WRAW + kr * 64 + q * 16);
        char* rowp = wt + kr * 128;
        *reinterpret_cast<uint4*>(rowp + (((2 * q) ^ (kr & 7)) * 16)) =
            i8x8_to_bf16(make_uint2(raw.x, raw.y));
        *reinterpret_cast<uint4*>(rowp + (((2 * q + 1) ^ (kr & 7)) * 16)) =
            i8x8_to_bf16(make_uint2(raw.z, raw.w));
      }
      fence_proxy_async();
      named_sync(1, 128);
      const uint64_t adesc = sw128_desc(smem_addr(wt));
      const uint64_t bdesc = sw128_desc(smem_addr(xs + st * R * Q_XTILE));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
#pragma unroll
        for (int r = 0; r < R; ++r)
          wgmma_ss<1, 0>(acc[r], adesc + 128 * kk, bdesc + (r * Q_XTILE >> 4) + 2 * kk,
                         c > cb || kk > 0);
      wgmma_commit();
      // The previous chunk's products are done: its stage goes back to the
      // producer.  (Waits outside branches keep ptxas from serialising the
      // wgmmas.)
      wgmma_wait<1>();
      if (lane == 0 && pend >= 0) mbar_arrive(&empty[pend]);
      pend = st;
    }
    wgmma_wait<0>();                // the slice's sum is in acc
    if (lane == 0) mbar_arrive(&empty[pend]);
    pend = -1;
#pragma unroll
    for (int r = 0; r < R; ++r) reg_fence(acc[r]);
    if constexpr (!SPLIT) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 32; ++i) tot[r][i] = sl == 0 ? acc[r][i] : tot[r][i] + acc[r][i];
    }
  }

  // Element (weight column n, x row) of tile r: n = n0 + 16 warp + lane / 4
  // (+ 8), row = m0 + 64 r + 8 j + 2 (lane % 4) (+ 1).
  const int na = n0 + 16 * warp + (lane >> 2);
  float sa = 1.0f, sb = 1.0f;
  float* dst = out;
  if constexpr (SPLIT) {
    dst += (size_t)blockIdx.z * m * n;
  } else {
    sa = scale[na];
    sb = scale[na + 8];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = m0 + 64 * r + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int col = na + ((i & 2) ? 8 : 0);
      float val;
      if constexpr (SPLIT) val = acc[r][i];
      else val = tot[r][i] * ((i & 2) ? sb : sa);
      if (row < m) dst[(size_t)row * n + col] = val;
    }
  }
}

// Y = (part[0] + part[1] + ... ) * s, the slices in order; four columns a
// thread.
__global__ void __launch_bounds__(256)
qmm_reduce_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                  float* __restrict__ y, int m, int n, int slices) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x, total4 = (size_t)m * n / 4;
  if (i >= total4) return;
  const size_t stride4 = (size_t)m * n / 4;
  float4 v = reinterpret_cast<const float4*>(part)[i];
  for (int s = 1; s < slices; ++s) {
    const float4 p = reinterpret_cast<const float4*>(part)[s * stride4 + i];
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  const float4 sc = reinterpret_cast<const float4*>(scale)[(i * 4 % n) / 4];
  reinterpret_cast<float4*>(y)[i] = make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
}

// ---------------------------------------------------------------------------
// K7: the int8 vocab projection as a weight stream
// ---------------------------------------------------------------------------

constexpr int NT_VT = 64;              // vocab rows per tile: wgmma's M side
constexpr int NT_KC = 64;              // K a ring stage holds (QT)
constexpr int NT_ERAW = NT_VT * NT_KC; // raw int8 E tile (64 entries x 64 K), bytes
constexpr int NT_XT = 16 * NT_KC * 2;  // one 16-row x tile (64 K), bytes
constexpr int NT_WBUF = 3;             // converted bf16 E tiles
constexpr int NT_MAX_MT = 12;          // 16-row tiles a launch takes (192 rows)

// Ring depth by row tiles: 8 stages (48 KB, three CTAs an SM) at one or two
// row tiles; 3 at three to six (two CTAs an SM, measured faster at M = 80 on
// the H100 than one CTA with 6 stages); 4 (112 KB) at seven to twelve.
__host__ __device__ constexpr int nt_stages(int mt) { return mt <= 2 ? 8 : (mt <= 6 ? 3 : 4); }

inline int nt_smem(int mt) {
  return 1024 + nt_stages(mt) * (mt * NT_XT + NT_ERAW) + NT_WBUF * Q_WTILE +
         16 * nt_stages(mt);
}

// Persistent grid: CTA b takes vocab tiles b, b + grid, ...; for each, the
// 64-wide K chunks in order.  The producer warp streams (x tile, int8 E tile)
// pairs through the ring without a break between vocab tiles; the consumer
// warpgroup converts each E tile exactly to bf16 (K-major, 128-byte
// swizzle), runs one m64nNk16 product per 16-deep step (A the E tile, B
// the 16 MT-row x tile; both K-major; N = 16 MT), and at a tile's
// last chunk writes y = sum * s[v] straight from them.  Each output's sum
// is the same chain of products whatever M or the grid is.
template <int MT>
__global__ void __launch_bounds__(Q_THREADS)
qmm_nt_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap me,
              const float* __restrict__ scale, float* __restrict__ y, int m, int v, int chunks,
              int tiles) {
  constexpr int S = nt_stages(MT);
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* xs = smem;                                  // S x MT x tiles of 16 rows
  char* wb = xs + S * MT * NT_XT;                   // NT_WBUF converted tiles
  char* eraw = wb + NT_WBUF * Q_WTILE;              // S raw int8 tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(eraw + S * NT_ERAW);
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
        mbar_arrive_tx(&full[st], MT * NT_XT + NT_ERAW);
        tma_load_2d(xs + st * MT * NT_XT, &mx, &full[st], c * NT_KC, 0);
        tma_load_2d(eraw + st * NT_ERAW, &me, &full[st], c * NT_KC, tile * NT_VT);
      }
    }
    return;
  }

  float acc[MT * 8];
  int pend = -1;
  for (int it = 0; it < total; ++it) {
    const int st = it % S, c = it % chunks;
    mbar_wait(&full[st], (it / S) & 1);
    // int8 (v, k) rows of 64 bytes -> bf16 rows of 128 bytes, chunk j of row
    // v stored at chunk j ^ (v % 8) (the 128-byte swizzle).
    char* wt = wb + (it % NT_WBUF) * Q_WTILE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int idx = threadIdx.x + 128 * h, vr = idx >> 2, q = idx & 3;
      const uint4 raw = *reinterpret_cast<const uint4*>(eraw + st * NT_ERAW + vr * 64 + q * 16);
      char* rowp = wt + vr * 128;
      *reinterpret_cast<uint4*>(rowp + (((2 * q) ^ (vr & 7)) * 16)) =
          i8x8_to_bf16(make_uint2(raw.x, raw.y));
      *reinterpret_cast<uint4*>(rowp + (((2 * q + 1) ^ (vr & 7)) * 16)) =
          i8x8_to_bf16(make_uint2(raw.z, raw.w));
    }
    fence_proxy_async();
    named_sync(1, 128);
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
      const float sa = va < v ? scale[va] : 0.0f;
      const float sb = va + 8 < v ? scale[va + 8] : 0.0f;
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = 16 * t + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int col = va + ((i & 2) ? 8 : 0);
          if (row < m && col < v) y[(size_t)row * v + col] = acc[8 * t + i] * ((i & 2) ? sb : sa);
        }
    }
  }
}

}  // namespace
}  // namespace wm

// f32 floats of scratch wm_qmm needs at (m, k, n): the K slices' partial
// products when the call splits K over CTAs, else 0.
extern "C" int wm_qmm_scratch(int m, int k, int n) {
  using namespace wm;
  if (m < 1 || k < QT || n < QT || k % QT || n % QT) return -1;
  const QmmPlan p = qmm_plan(m, k, n);
  const long long floats = p.split ? (long long)p.slices * m * n : 0;
  return floats > 0x7fffffffLL ? -1 : (int)floats;
}

// x (m, k) bf16, wq (k, n) int8, s (n,) f32 -> y (m, n) f32; k, n % 64 == 0;
// scratch: wm_qmm_scratch(m, k, n) f32 floats (may be null when that is 0).
// x and wq must be 16-byte aligned (the tensor-map encoder refuses another
// address: the entry then returns TENSOR_MAP_ERROR + its error).
extern "C" int wm_qmm(const void* x, const void* wq, const void* s, void* y, void* scratch,
                      int m, int k, int n, void* stream) {
  using namespace wm;
  if (m < 1 || k < QT || n < QT || k % QT || n % QT) return (int)cudaErrorInvalidValue;
  const QmmPlan p = qmm_plan(m, k, n);
  if (p.split && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cuuint64_t xdims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t xstrides[1] = {(cuuint64_t)k * sizeof(bf16)};
  const cuuint32_t xbox[2] = {QT, (cuuint32_t)(QT * p.r)};
  const cuuint64_t wdims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t wstrides[1] = {(cuuint64_t)n};
  const cuuint32_t wbox[2] = {QT, QT};
  CUtensorMap mx, mw;
  int err = encode_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstrides, xbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, wdims, wstrides, wbox,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(n / QT, p.mt, p.split ? p.slices : 1);
  float* out = p.split ? (float*)scratch : (float*)y;
  const int smem = qmm_smem(p.r);
  // Per launch: the attribute belongs to the current device's context.
#define WM_QMM(R, SPLIT)                                                                  \
  if (p.r == R && (bool)p.split == SPLIT) {                                               \
    cudaFuncSetAttribute(qmm_kernel<R, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         smem);                                                           \
    qmm_kernel<R, SPLIT><<<grid, Q_THREADS, smem, st>>>(mx, mw, (const float*)s, out, m,  \
                                                        n, k / QT, p.slices);             \
  }
  WM_QMM(1, false) WM_QMM(2, false) WM_QMM(1, true) WM_QMM(2, true) WM_QMM(3, true)
  WM_QMM(4, true)
#undef WM_QMM
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !p.split) return (int)e;
  const long long total4 = (long long)m * n / 4;
  qmm_reduce_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, st>>>(
      (const float*)scratch, (const float*)s, (float*)y, m, n, p.slices);
  return (int)cudaGetLastError();
}

// x (m, d) bf16, m <= 192, e (v, d) int8, s (v,) f32 -> y (m, v) f32; d % 64
// == 0; x and e 16-byte aligned (the tensor-map encoder refuses another
// address: the entry then returns TENSOR_MAP_ERROR + its error).  The vocab
// tiles (ceil(v / 64)) and K chunks (d / 64) come from the shapes alone
// (ops/qmm.py::nt_plan); the grid (CTAs an SM times the SMs) changes no sum.
extern "C" int wm_qmm_nt(const void* x, const void* e, const void* s, void* y, int m,
                         int v, int d, void* stream) {
  using namespace wm;
  if (m < 1 || m > 16 * NT_MAX_MT || v < 1 || d < NT_KC || d % NT_KC)
    return (int)cudaErrorInvalidValue;
  const int mt = (m + 15) / 16, tiles = (v + NT_VT - 1) / NT_VT;
  const cuuint64_t xdims[2] = {(cuuint64_t)d, (cuuint64_t)m};
  const cuuint64_t xstrides[1] = {(cuuint64_t)d * sizeof(bf16)};
  const cuuint32_t xbox[2] = {QT, (cuuint32_t)(16 * mt)};
  const cuuint64_t edims[2] = {(cuuint64_t)d, (cuuint64_t)v};
  const cuuint64_t estrides[1] = {(cuuint64_t)d};
  const cuuint32_t ebox[2] = {NT_KC, NT_VT};
  CUtensorMap mx, me;
  int err = encode_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstrides, xbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_map(&me, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, e, edims, estrides, ebox,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  // The grid: as many CTAs as fit on the card, found once per device and row
  // tiles (the occupancy query costs host time on every call otherwise).
  constexpr int MAX_DEV = 16;
  static int fits[MAX_DEV][NT_MAX_MT + 1] = {};
  if (dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  const int smem = nt_smem(mt);
  // Per launch: the attribute belongs to the current device's context.
#define WM_NT(MT)                                                                        \
  case MT: {                                                                             \
    cudaFuncSetAttribute(qmm_nt_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         smem);                                                          \
    if (fits[dev][MT] == 0) {                                                            \
      int sms = 0, per_sm = 0;                                                           \
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);                 \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qmm_nt_kernel<MT>,         \
                                                    Q_THREADS, smem);                    \
      fits[dev][MT] = (per_sm > 1 ? per_sm : 1) * sms;                                   \
    }                                                                                    \
    const int grid = tiles < fits[dev][MT] ? tiles : fits[dev][MT];                      \
    qmm_nt_kernel<MT><<<grid, Q_THREADS, smem, (cudaStream_t)stream>>>(                  \
        mx, me, (const float*)s, (float*)y, m, v, d / NT_KC, tiles);                     \
    break;                                                                               \
  }
  switch (mt) {
    WM_NT(1) WM_NT(2) WM_NT(3) WM_NT(4) WM_NT(5) WM_NT(6)
    WM_NT(7) WM_NT(8) WM_NT(9) WM_NT(10) WM_NT(11) WM_NT(12)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WM_NT
  return (int)cudaGetLastError();
}
