// The f32 attention body of K10's f32 modes (decode_ops.cu: wm_cross_decode_f32,
// wm_self_decode_f32, wm_cross_decode_w8a32) and of K2's W8A32 mode
// (megastep.cu: its self- and cross-attention), FFMA on the CUDA cores (the
// tensor cores take f32 only as TF32).  It follows K10's bf16 body
// (cluster_attn.cuh) with the f32 arithmetic kept:
//
// One thread-block cluster of C CTAs (8 warps each) per (head, example),
// rank r taking the keys [r SC, (r + 1) SC) of cd_split (from S alone:
// large-v2's 1500 cross keys 8 x 192, a 460-row self slab 3 x 160), and NR
// query rows, a template argument chosen from T (1, 4, 8 or 16: a T = 1
// step computes one row):
//   1. the CTA loads its K slice and its V slice: the cross modes' V (f32
//      or int8) and the f32 cross K by TMA, one box each (two past 256
//      keys) onto an mbarrier each, issued by one thread; the int8 cross K (rows of S
//      bytes, no 16-byte stride for a tensor map), the int8 scales and the
//      mask mode's rows by cp.async; keys past the visible end are not
//      read (TMA zero-fills past S); q transposed into shared memory;
//   2. scores from shared memory as FFMA register tiles of 4 keys x 4 rows
//      (1 row at NR = 1; row groups past T skipped), each score one fmaf
//      chain over d = 0 .. 63 in order; cross K is staged d-major as it
//      lies in memory (a thread reads its 4 keys as one float4, or one
//      32-bit word of int8), self K key-major (a thread takes keys kq + i
//      SC/4, a 272-byte pitch keeping a quarter-warp's float4 reads on
//      distinct banks); masked keys -inf (the int8 modes: times the key's
//      scale first); the scores over the dead K slice;
//   3. the row maxima pushed to every rank through distributed shared
//      memory, a cluster barrier, the global max; p = exp(s - max) in place
//      (not rounded: the TPU kernel's f32 P is not; times the value's scale
//      at int8), the row sums (lane-strided, then a butterfly) pushed to
//      every rank;
//   4. the partial O = P V of the slice: thread (d quad, row group, key
//      group) sums a contiguous run of keys in order (P as float4 of four
//      rows, V as one float4 of a row), the key groups added in order, each
//      output row pushed to its owner rank (t % C); after a second cluster
//      barrier the owner adds the C partials and the C row sums in rank
//      order and writes O / sum.
// One launch a call: no partials scratch, no combine kernel.  Each (example,
// head)'s arithmetic and its order of sums depend on S and T alone, so an
// example's bits do not depend on the batch.
//
// Q8 (W8A32: the int8 copy of an f32 model) reads int8 K/V, each value
// converted exactly to f32 (common.cuh's i8x4_to_f32).  Cross mode: K (B, H,
// 64, S) and V (B, S, H * 64) int8, staged as int8 (a quarter of the f32
// bytes), with f32 (B, H, S) scales ks / vs, each score times its key's
// scale before the mask and the max, each probability times its value's
// scale before the PV product, the sum of p unscaled
// (decode_ops.py::cross_attention_decode_plain).  Mask mode (K2's self-
// attention): history keys j < off[b] from the int8 slab (B, S, H * 64),
// converted to f32 as they are staged, with the bf16 scale slab ss (B, S,
// 2H), score times f32(k scale) and p times f32(v scale); the chunk's own
// keys off[b] + t from the fresh f32 rows kn / vn ((B * T, H * 64), the
// projections' output), as the JAX kernel attends them (megastep.py:
// 832-875); the CTA of rank 0 also commits the chunk's rows into the slabs:
// each 64-lane (position, head) row quantized with sc = max(amax, 1e-30) /
// 127 and round-half-even, clipped to +-127, bf16(sc) into ss (models/
// whisper.py quantize_self_rows; positions at or past S are not written).
// The other CTAs read only rows j < off, which the commit does not touch.
//
// K2 = true (K2's W8A32 instantiations): launched with programmatic
// dependent launch beside the cluster attribute; griddep_launch() at the
// top.  Cross mode issues its K / V loads and reads its scales before
// griddep_wait() and reads q only after it (the cross K/V are written by
// init_cache, never by the step); mask mode waits first.
//
// Bound on H100: bytes, 768 KB of f32 K and V per (example, head) at S =
// 1500 (at B = 16 and 20 heads 245.8 MB, 0.073 ms at 3.35 TB/s), a quarter
// of that at int8.  A CTA holds 110 KB at the f32 cross slice (two an SM),
// 40 KB at int8.
#pragma once

#include <cooperative_groups.h>

#include "cluster_attn.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace wm {
namespace {

constexpr int DA_THREADS = 256;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_KP = CD_DH + 4;   // f32 pitch of a key-major K row (mask mode)
constexpr int DA_TILES = 2;        // score tiles a thread holds: (SC / 4) x 4 <= 512

struct DfArgs {
  const float* q;      // cross (B, H, T, 64); self (B, T, H, 64); pre-scaled
  const float* k;      // cross (B, H, 64, S); self (B, S, H * 64)  (f32 modes)
  const float* v;      // (B, S, H * 64)
  const int* off;      // self: (B,) int32 offsets
  const int* bits;     // self: (T, W) int32 chunk bits
  float* out;          // q's layout
  // Q8: int8 K/V in the f32 layouts above; cross scales (B, H, S) f32; the
  // self slabs' bf16 scales (B, S, 2H) and the chunk's fresh f32 K/V rows
  // (B * T, H * 64).
  int8_t* k8;
  int8_t* v8;
  const float* ks;
  const float* vs;
  bf16* ss;
  const float* kn;
  const float* vn;
  long long q_b, q_h, q_t;
  int heads, t_len, t_chunk, s_len, kv_len;
  int vz;         // cross: the V map's first slab of the call (K2: the cache slot's)
  int sc;         // set by da_launch: the slice
};

// The query rows a launch computes for T rows: 1, 4, 8 or 16.
__host__ __device__ inline int da_rows(int t) { return t <= 1 ? 1 : (t <= 4 ? 4 : (t <= 8 ? 8 : 16)); }

// Shared memory of one CTA (byte offsets from a 128-byte aligned base,
// every region 128-byte aligned): region A (the K slice, then the scores /
// p, NR rows of SC + 4, then the PV key groups' partials), V, qT (64 x QP),
// the int8 modes' key and value scales, the PV rows the other ranks push,
// their row maxima and sums, and the two mbarriers of the cross modes.
struct DaSmem {
  int v, q, scales, recv, stat, bar, total;
};

__host__ __device__ inline int da_r128(int x) { return (x + 127) / 128 * 128; }
__host__ __device__ inline int da_qp(int nr) { return nr == 1 ? 1 : nr + 4; }

__host__ __device__ inline DaSmem da_smem(int sc, int csize, int nr, bool self_mode, bool i8) {
  DaSmem l;
  const int es = i8 ? 1 : 4;
  const int rr = nr >= 4 ? 4 : 1;
  const int kb = self_mode ? sc * DA_KP * 4 : CD_DH * sc * es;
  const int pb = nr * (sc + 4) * 4, rb = 16 * rr * CD_DH * 4;
  int a = kb > pb ? kb : pb;
  a = a > rb ? a : rb;
  l.v = da_r128(a);
  l.q = l.v + da_r128(sc * CD_DH * es);
  l.scales = l.q + da_r128(CD_DH * da_qp(nr) * 4);
  l.recv = l.scales + da_r128(2 * sc * 4);
  l.stat = l.recv + da_r128(csize * ((nr + csize - 1) / csize) * CD_DH * 4);
  l.bar = l.stat + da_r128(2 * CD_MAXC * CD_MAXT * 4);
  l.total = 128 + l.bar + 16;   // with the base's alignment slack
  return l;
}

// The keys of a K / V box: the whole slice (one TMA load each for K and
// V), or half of it past 256 keys (a box side's limit).
__host__ __device__ inline int da_kbox(int sc) { return sc <= 256 ? sc : sc / 2; }

// The commit of the chunk's K/V rows of head h of example b (Q8 mask mode,
// the CTA of rank 0): warp w takes (row, K or V) tasks w, w + 8, ...; lanes
// hold elements l and l + 32 of the 64-lane row.
__device__ __forceinline__ void df_commit(const DfArgs& a, int b, int h, int off) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d_model = a.heads * CD_DH;
  for (int task = warp; task < 2 * a.t_len; task += DA_WARPS) {
    const int t = task >> 1, is_v = task & 1;
    const int pos = off + t;
    if (pos >= a.s_len) continue;
    const float* src = (is_v ? a.vn : a.kn) + ((size_t)b * a.t_len + t) * d_model + h * CD_DH;
    const float x0 = src[lane], x1 = src[lane + 32];
    const float amax = warp_max(fmaxf(fabsf(x0), fabsf(x1)));
    const float sc = fmaxf(amax, 1e-30f) / 127.0f;
    int8_t* dst = (is_v ? a.v8 : a.k8) + ((size_t)b * a.s_len + pos) * d_model + h * CD_DH;
    dst[lane] = (int8_t)fminf(fmaxf(rintf(x0 / sc), -127.0f), 127.0f);
    dst[lane + 32] = (int8_t)fminf(fmaxf(rintf(x1 / sc), -127.0f), 127.0f);
    if (lane == 0)
      a.ss[((size_t)b * a.s_len + pos) * 2 * a.heads + is_v * a.heads + h] =
          __float2bfloat16_rn(sc);
  }
}

// Mask mode (Q8): rows [0, n) of one head's slice of an int8 slab,
// converted exactly to f32 rows of `pitch` floats (16 values a task).
__device__ __forceinline__ void da_stage_i8(float* dst, int pitch, const int8_t* src, int ld,
                                            int n) {
  for (int i = threadIdx.x; i < n * 4; i += DA_THREADS) {
    const int j = i >> 2, cc = (i & 3) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)j * ld + cc);
    float4* d = reinterpret_cast<float4*>(dst + j * pitch + cc);
    d[0] = i8x4_to_f32(raw.x);
    d[1] = i8x4_to_f32(raw.y);
    d[2] = i8x4_to_f32(raw.z);
    d[3] = i8x4_to_f32(raw.w);
  }
}

// grid (C, H, B), clusters of (C, 1, 1): one cluster per (head, example),
// rank r takes keys [r * SC, (r + 1) * SC).  mk: the f32 cross K as (rows of
// S keys) with (KB key, 64 row) boxes; mv: cross V as (64 H, S, B) with (64,
// KB, 1) boxes (f32 or int8), KB = da_kbox(SC).  The modes: see the file
// comment.
template <int NR, bool SELF, bool Q8, bool K2>
__global__ void __launch_bounds__(DA_THREADS, Q8 && !SELF ? 3 : 2)
decode_attn_f32_kernel(const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv, const DfArgs a) {
  constexpr int RR = NR >= 4 ? 4 : 1;       // rows of a PV tile
  constexpr int NRG = NR / RR;              // PV row groups
  constexpr int KG = 16 / NRG;              // PV key groups: 16 d quads x NRG x KG threads
  constexpr int QP = NR == 1 ? 1 : NR + 4;  // qT's pitch
  constexpr bool I8 = Q8 && !SELF;          // int8 K/V in shared memory (cross)
  constexpr bool TMA_K = !SELF && !Q8;      // the f32 cross K by TMA
  constexpr int ES = I8 ? 1 : 4;
  static_assert(16 * NRG * KG == DA_THREADS, "the PV threads");
  if constexpr (K2) {
    griddep_launch();
    if constexpr (SELF) griddep_wait();   // mask mode reads nothing before its wait
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sc = a.sc, j0 = rank * sc, s_len = a.s_len, t_len = a.t_len;
  const int d_model = a.heads * CD_DH;
  const int off = SELF ? a.off[b] : 0;
  const int kv_end = SELF ? min(off + a.t_chunk, s_len) : a.kv_len;
  const int n_load = max(0, min(sc, kv_end - j0));   // keys of the slice read
  const int n4 = (n_load + 3) & ~3;                  // ... to a whole quad (zero-filled)
  const int kq_n = sc / 4;                           // key quads of the slice
  const int kbx = da_kbox(sc);                       // keys a K / V box
  const int sp = sc + 4;                             // pitch of a row of scores

  extern __shared__ unsigned char da_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(da_smem_raw) + 127) & ~uintptr_t(127));
  const DaSmem L = da_smem(sc, csize, NR, SELF, I8);
  float* ksm = reinterpret_cast<float*>(smem);              // f32 K (region A)
  int8_t* ksm8 = reinterpret_cast<int8_t*>(smem);           // int8 cross K (region A)
  float* sbuf = reinterpret_cast<float*>(smem);             // scores, then p (region A)
  float* red = reinterpret_cast<float*>(smem);              // PV key groups (region A)
  float* vsm = reinterpret_cast<float*>(smem + L.v);
  int8_t* vsm8 = reinterpret_cast<int8_t*>(smem + L.v);
  float* qt = reinterpret_cast<float*>(smem + L.q);         // qT[d][QP]
  float* ksc = reinterpret_cast<float*>(smem + L.scales);
  float* vsc = ksc + sc;
  float* recv = reinterpret_cast<float*>(smem + L.recv);    // [rank][own][64], pushed
  float* xmax = reinterpret_cast<float*>(smem + L.stat);    // [rank][16], pushed
  float* xsum = xmax + CD_MAXC * CD_MAXT;                   // [rank][16], pushed
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);  // K, V

  // 1. The K slice, then the V slice.
  if constexpr (!SELF) {
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&mv))
                   : "memory");
      if constexpr (TMA_K)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&mk))
                     : "memory");
      mbar_init(&bar[0], 1);
      mbar_init(&bar[1], 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
      const int boxes = sc / kbx;
      if constexpr (TMA_K) {
        // d-major boxes of kbx keys: key j of row d at (j / kbx) 64 kbx + d kbx + j % kbx.
        mbar_arrive_tx(&bar[0], CD_DH * sc * 4);
        const int row = ((int)b * a.heads + h) * CD_DH;
        for (int c = 0; c < boxes; ++c)
          tma_load_2d(ksm + c * CD_DH * kbx, &mk, &bar[0], j0 + c * kbx, row);
      }
      mbar_arrive_tx(&bar[1], sc * CD_DH * ES);
      for (int c = 0; c < boxes; ++c)
        tma_load_3d(smem + L.v + c * kbx * CD_DH * ES, &mv, &bar[1], h * CD_DH, j0 + c * kbx,
                    a.vz + b);
    }
    if constexpr (I8) {
      // K head-major int8: 64 d-rows of the slice's keys, four keys a copy.
      const size_t krow = ((size_t)b * a.heads + h) * CD_DH * s_len + j0;
      for (int i = tid; i < CD_DH * kq_n; i += DA_THREADS) {
        const int d = i / kq_n, j = 4 * (i % kq_n);
        const bool in = j < n_load;
        cp_async(ksm8 + d * sc + j, in ? a.k8 + krow + (size_t)d * s_len + j : a.k8, 4, in);
      }
      cp_async_commit();
      const size_t row = ((size_t)b * a.heads + h) * s_len + j0;
      for (int j = tid; j < 2 * sc; j += DA_THREADS) {
        const int jj = j < sc ? j : j - sc;
        const bool in = jj < n_load;
        cp_async(ksc + j, in ? (j < sc ? a.ks : a.vs) + row + jj : a.ks, 4, in);
      }
      cp_async_commit();
    }
  } else {
    // Key-major rows of 64 floats; Q8: history rows j < off from the int8
    // slab (converted as they are staged), the chunk's rows from kn / vn.
    const int hist = Q8 ? min(max(off - j0, 0), n_load) : 0;
    const size_t slab0 = ((size_t)b * s_len + j0) * d_model + h * CD_DH;
    const size_t fresh0 = ((size_t)b * a.t_len + max(j0 - off, 0)) * d_model + h * CD_DH;
    const float* kf = Q8 ? a.kn + fresh0 - (size_t)hist * d_model : a.k + slab0;
    const float* vf = Q8 ? a.vn + fresh0 - (size_t)hist * d_model : a.v + slab0;
    const float* kbase = Q8 ? a.kn : a.k;
    const float* vbase = Q8 ? a.vn : a.v;
    // Rows past n4 are never read as V (nor counted as K: their scores are
    // masked), so only the quads of the rows read are staged.
    for (int i = hist * 16 + tid; i < n4 * 16; i += DA_THREADS) {
      const int j = i >> 4, cc = (i & 15) * 4;
      const bool in = j < n_load;
      cp_async(ksm + j * DA_KP + cc, in ? kf + (size_t)j * d_model + cc : kbase, 16, in);
    }
    cp_async_commit();
    for (int i = hist * 16 + tid; i < n4 * 16; i += DA_THREADS) {
      const int j = i >> 4, cc = (i & 15) * 4;
      const bool in = j < n_load;
      cp_async(vsm + j * CD_DH + cc, in ? vf + (size_t)j * d_model + cc : vbase, 16, in);
    }
    cp_async_commit();
    if constexpr (Q8) {
      da_stage_i8(ksm, DA_KP, a.k8 + slab0, d_model, hist);
      da_stage_i8(vsm, CD_DH, a.v8 + slab0, d_model, hist);
      const bf16* srow = a.ss + ((size_t)b * s_len + j0) * 2 * a.heads + h;
      for (int j = tid; j < sc; j += DA_THREADS) {
        ksc[j] = j < hist ? bf2f(srow[(size_t)j * 2 * a.heads]) : 1.0f;
        vsc[j] = j < hist ? bf2f(srow[(size_t)j * 2 * a.heads + a.heads]) : 1.0f;
      }
      if (rank == 0) df_commit(a, b, h, off);
    }
  }
  // K2's cross mode: the K/V slices (and scales) are in flight; q, written
  // by the cross-q projection, only after the wait.
  if constexpr (K2 && !SELF) griddep_wait();
  const float* qg = a.q + b * a.q_b + h * a.q_h;
  for (int i = tid; i < NR * CD_DH; i += DA_THREADS) {
    const int r = i / CD_DH, d = i % CD_DH;
    qt[d * QP + r] = r < t_len ? qg[r * a.q_t + d] : 0.0f;
  }
  if constexpr (TMA_K) mbar_wait(&bar[0], 0);
  else if constexpr (I8) cp_async_wait<0>();   // K and the scales
  else cp_async_wait<1>();                     // K (V in flight)
  __syncthreads();

  // 2. Scores: tile (kq, rg) = keys of quad kq x rows [RR rg, + RR), each a
  // chain over d in order, held in registers until every thread is past K.
  const int rows = min(NR, (t_len + RR - 1) / RR * RR);   // the live row groups' rows
  float acc[DA_TILES][RR][4];
  int tiles[DA_TILES];
#pragma unroll
  for (int u = 0; u < DA_TILES; ++u) {
    const int tile = tid + u * DA_THREADS;
    const int kq = tile % kq_n, rg = tile / kq_n;
    // Cross keys 4 kq .. + 3; self keys kq + i kq_n.
    const bool live = RR * rg < rows && (SELF ? kq < n4 : 4 * kq < n_load);
    tiles[u] = live ? tile : -1;
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][r][i] = 0.0f;
    if (!live) continue;
    if constexpr (!SELF) {
      // Key j of row d: int8 at d sc + j; f32 in the boxes of kbx keys.
      const float* kcol = ksm + (4 * kq / kbx) * CD_DH * kbx + (4 * kq) % kbx;
#pragma unroll 8
      for (int d = 0; d < CD_DH; ++d) {
        float4 kv;
        if constexpr (I8)
          kv = i8x4_to_f32(*reinterpret_cast<const uint32_t*>(ksm8 + d * sc + 4 * kq));
        else
          kv = *reinterpret_cast<const float4*>(kcol + d * kbx);
        float qv[RR];
        if constexpr (RR == 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qt + d * QP + 4 * rg);
          qv[0] = q4.x;
          qv[1] = q4.y;
          qv[2] = q4.z;
          qv[3] = q4.w;
        } else {
          qv[0] = qt[d * QP + rg];
        }
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          acc[u][r][0] = fmaf(qv[r], kv.x, acc[u][r][0]);
          acc[u][r][1] = fmaf(qv[r], kv.y, acc[u][r][1]);
          acc[u][r][2] = fmaf(qv[r], kv.z, acc[u][r][2]);
          acc[u][r][3] = fmaf(qv[r], kv.w, acc[u][r][3]);
        }
      }
    } else {
#pragma unroll 2
      for (int d4 = 0; d4 < CD_DH; d4 += 4) {
        float kk[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 k4 = *reinterpret_cast<const float4*>(ksm + (kq + i * kq_n) * DA_KP + d4);
          kk[i][0] = k4.x;
          kk[i][1] = k4.y;
          kk[i][2] = k4.z;
          kk[i][3] = k4.w;
        }
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          float qv[RR];
          if constexpr (RR == 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qt + (d4 + dd) * QP + 4 * rg);
            qv[0] = q4.x;
            qv[1] = q4.y;
            qv[2] = q4.z;
            qv[3] = q4.w;
          } else {
            qv[0] = qt[(d4 + dd) * QP + rg];
          }
#pragma unroll
          for (int r = 0; r < RR; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[u][r][i] = fmaf(qv[r], kk[i][dd], acc[u][r][i]);
        }
      }
    }
  }
  __syncthreads();   // every thread is past K: the scores overwrite it
  const int words = (a.t_chunk + 31) / 32;
#pragma unroll
  for (int u = 0; u < DA_TILES; ++u) {
    if (tiles[u] < 0) continue;
    const int kq = tiles[u] % kq_n, rg = tiles[u] / kq_n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = SELF ? kq + i * kq_n : 4 * kq + i, jg = j0 + j;
      const float kscale = Q8 ? ksc[j] : 1.0f;
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const int row = RR * rg + r;
        bool vis = row < t_len && j < n_load;
        if constexpr (SELF) {
          const int rel = jg - off;
          vis = vis && (rel < 0 || (rel < a.t_chunk && jg < s_len &&
                                    ((__ldg(reinterpret_cast<const unsigned*>(a.bits) +
                                            row * words + (rel >> 5)) >> (rel & 31)) & 1u)));
        } else {
          vis = vis && jg < a.kv_len;
        }
        const float s = Q8 ? acc[u][r][i] * kscale : acc[u][r][i];
        sbuf[row * sp + j] = vis ? s : -INFINITY;
      }
    }
  }
  __syncthreads();

  // 3. Row maxima pushed to every rank, the global max; p = exp(s - max) in
  // place (times the value's scale at Q8) and the row sums pushed, summed
  // lane-strided then by a butterfly.
  for (int r = warp; r < rows; r += DA_WARPS) {
    float m = -INFINITY;
    for (int j = lane; j < n_load; j += 32) m = fmaxf(m, sbuf[r * sp + j]);
    m = warp_max(m);
    if (lane < csize) cluster.map_shared_rank(xmax, lane)[rank * CD_MAXT + r] = m;
  }
  cluster.sync();
  for (int r = warp; r < rows; r += DA_WARPS) {
    float m = xmax[r];
    for (int q = 1; q < csize; ++q) m = fmaxf(m, xmax[q * CD_MAXT + r]);
    float l = 0.0f;
    for (int j = lane; j < n4; j += 32) {
      const float s = sbuf[r * sp + j];
      float p = s == -INFINITY ? 0.0f : expf(s - m);
      l += p;
      if constexpr (Q8) p *= vsc[j];
      sbuf[r * sp + j] = p;
    }
    l = warp_sum(l);
    if (lane < csize) cluster.map_shared_rank(xsum, lane)[rank * CD_MAXT + r] = l;
  }
  if constexpr (SELF) cp_async_wait<0>();
  else mbar_wait(&bar[1], 0);
  __syncthreads();

  // 4. Partial PV: thread (dq, rg, kg) sums keys [kg len, + len) in order.
  {
    const int dq = tid & 15, rest = tid >> 4, rg = rest % NRG, kg = rest / NRG;
    const int len = ((n4 / 4 + KG - 1) / KG) * 4;
    const int jb = kg * len, je = RR * rg < rows ? min(jb + len, n4) : jb;
    float o[RR][4];
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][e] = 0.0f;
    for (int j = jb; j < je; j += 4) {
      float pv[RR][4];
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(sbuf + (RR * rg + r) * sp + j);
        pv[r][0] = p4.x;
        pv[r][1] = p4.y;
        pv[r][2] = p4.z;
        pv[r][3] = p4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 vv;
        if constexpr (I8)
          vv = i8x4_to_f32(*reinterpret_cast<const uint32_t*>(vsm8 + (j + jj) * CD_DH + 4 * dq));
        else
          vv = *reinterpret_cast<const float4*>(vsm + (j + jj) * CD_DH + 4 * dq);
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          o[r][0] = fmaf(pv[r][jj], vv.x, o[r][0]);
          o[r][1] = fmaf(pv[r][jj], vv.y, o[r][1]);
          o[r][2] = fmaf(pv[r][jj], vv.z, o[r][2]);
          o[r][3] = fmaf(pv[r][jj], vv.w, o[r][3]);
        }
      }
    }
    __syncthreads();   // every thread is past P and V: the partials overwrite P
    if (RR * rg < rows) {
#pragma unroll
      for (int r = 0; r < RR; ++r)
        *reinterpret_cast<float4*>(red + ((kg * NR + RR * rg + r) * CD_DH + 4 * dq)) =
            make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
    }
  }
  __syncthreads();
  // The key groups added in order; row t's partial pushed to rank t % C.
  const int own = (NR + csize - 1) / csize;
  for (int e = tid; e < t_len * CD_DH; e += DA_THREADS) {
    const int r = e / CD_DH, d = e % CD_DH;
    float y = red[r * CD_DH + d];
#pragma unroll
    for (int g = 1; g < KG; ++g) y += red[(g * NR + r) * CD_DH + d];
    cluster.map_shared_rank(recv, r % csize)[(rank * own + r / csize) * CD_DH + d] = y;
  }
  cluster.sync();
  // The owner of row t: the C partials and the C row sums in rank order.
  float* og = a.out + b * a.q_b + h * a.q_h;
  for (int e = tid; e < own * CD_DH; e += DA_THREADS) {
    const int slot = e / CD_DH, d = e % CD_DH, r = slot * csize + rank;
    if (r >= t_len) continue;
    float l = xsum[r], y = recv[slot * CD_DH + d];
    for (int q = 1; q < csize; ++q) {
      l += xsum[q * CD_MAXT + r];
      y += recv[(q * own + slot) * CD_DH + d];
    }
    og[r * a.q_t + d] = y / l;
  }
}

// The split of S keys, the rows of T and the shared memory of one call.
struct DaPlan {
  int csize, slice, nr, smem;
};

// The cross modes' tensor maps: K (f32 only: the int8 K is staged by
// cp.async) as rows of S keys, (kbx, 64) boxes; V as (64 H, S, slabs) with
// (64, kbx, 1) boxes, f32 or int8.  A call's maps over ``nk`` K rows and
// ``nv`` V slabs (K2: every cache slot's).
inline int da_maps(CUtensorMap* mk, CUtensorMap* mv, const void* k, const void* v, bool i8,
                   int s_len, int heads, int nk, int nv, int kbx) {
  int err = 0;
  if (!i8) {
    const cuuint64_t dims[2] = {(cuuint64_t)s_len, (cuuint64_t)nk};
    const cuuint64_t strides[1] = {(cuuint64_t)s_len * 4};
    const cuuint32_t box[2] = {(cuuint32_t)kbx, CD_DH};
    err = encode_map_cached(mk, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, k, dims, strides, box,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err) return err;
  const cuuint64_t es = i8 ? 1 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)heads * CD_DH, (cuuint64_t)s_len, (cuuint64_t)nv};
  const cuuint64_t strides[2] = {heads * CD_DH * es, (cuuint64_t)s_len * heads * CD_DH * es};
  const cuuint32_t box[3] = {CD_DH, (cuuint32_t)kbx, 1};
  err = encode_map_cached(mv, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          3, v, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  return err;
}

template <int NR, bool SELF, bool Q8, bool K2>
int da_launch_nr(const CUtensorMap& mk, const CUtensorMap& mv, const DfArgs& a,
                 const DaPlan& p, int batch, cudaStream_t st, bool set_smem) {
  auto kern = decode_attn_f32_kernel<NR, SELF, Q8, K2>;
  if (set_smem)   // above 48 KB it needs the attribute (the current device's context)
    return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.csize, a.heads, batch);
  cfg.blockDim = dim3(DA_THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K2 ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, mk, mv, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <bool SELF, bool Q8, bool K2>
int da_dispatch(const CUtensorMap& mk, const CUtensorMap& mv, const DfArgs& a,
                const DaPlan& p, int batch, cudaStream_t st, bool set_smem) {
  switch (p.nr) {
    case 1: return da_launch_nr<1, SELF, Q8, K2>(mk, mv, a, p, batch, st, set_smem);
    case 4: return da_launch_nr<4, SELF, Q8, K2>(mk, mv, a, p, batch, st, set_smem);
    case 8: return da_launch_nr<8, SELF, Q8, K2>(mk, mv, a, p, batch, st, set_smem);
    case 16: return da_launch_nr<16, SELF, Q8, K2>(mk, mv, a, p, batch, st, set_smem);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The plan over S keys and T query rows, its shared memory set on the
// instantiation.
template <bool SELF, bool Q8, bool K2>
int da_plan(int s_len, int t_len, DaPlan* p) {
  if (t_len < 1 || t_len > CD_MAXT || !cd_split(s_len, &p->csize, &p->slice))
    return (int)cudaErrorInvalidValue;
  p->nr = da_rows(t_len);
  p->smem = da_smem(p->slice, p->csize, p->nr, SELF, Q8 && !SELF).total;
  const CUtensorMap none = {};
  return da_dispatch<SELF, Q8, K2>(none, none, DfArgs{}, *p, 1, nullptr, true);
}

// One launch over `batch` examples on a plan from da_plan; mk / mv from
// da_maps (cross modes; unread in mask mode).
template <bool SELF, bool Q8, bool K2>
int da_launch(const CUtensorMap& mk, const CUtensorMap& mv, DfArgs a, const DaPlan& p,
              int batch, cudaStream_t st) {
  a.sc = p.slice;
  return da_dispatch<SELF, Q8, K2>(mk, mv, a, p, batch, st, false);
}

// K10's f32 modes: plan, maps (the cross modes) and launch (the shared
// memory set on every call).
template <bool SELF, bool Q8 = false>
int k10_f32_launch(const DfArgs& a, int batch, cudaStream_t st) {
  DaPlan p;
  int err = da_plan<SELF, Q8, false>(a.s_len, a.t_len, &p);
  if (err) return err;
  CUtensorMap mk = {}, mv = {};
  if (!SELF) {
    err = da_maps(&mk, &mv, Q8 ? (const void*)a.k8 : (const void*)a.k,
                  Q8 ? (const void*)a.v8 : (const void*)a.v, Q8, a.s_len, a.heads,
                  batch * a.heads * CD_DH, batch, da_kbox(p.slice));
    if (err) return err;
  }
  return da_launch<SELF, Q8, false>(mk, mv, a, p, batch, st);
}

}  // namespace
}  // namespace wm
