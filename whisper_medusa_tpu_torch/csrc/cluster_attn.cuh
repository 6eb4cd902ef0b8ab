// The thread-block-cluster attention body shared by K10 (decode_ops.cu:
// wm_cross_decode, wm_self_decode) and K2's self- and cross-attention
// (megastep.cu).  Internal linkage, as wgemm.cuh: every .cu that includes
// it gets its own copy.
//
// One cluster of C CTAs per (head, example) splits the S keys into C
// contiguous slices of SC keys (cd_split: from S alone), stages its slice
// with cp.async, computes its scores and its partial PV with mma.sync
// m16n8k16 (the T <= 16 queries are one m16 tile), and merges the row maxima
// and then the row sums through distributed shared memory (sums in rank
// order); P is rounded to bf16 once, after the whole-row softmax; the PV
// partials are added in rank order.  decode_ops.cu's file comment has the
// design in full.
//
// The body's modes, template arguments of cross_decode_kernel<KT, SELF, K2>:
//   * KT: the type of the K/V in device memory, bf16 or int8.  Cross K/V
//     (SELF false) are staged as they are and int8 scores are multiplied by
//     the key's scale (ks) and probabilities by the value's (vs).  Self
//     slabs (SELF true) are staged as bf16: K2's int8 slabs are dequantized
//     as they are staged, bf16(q * f32(bf16 scale)) with the (position,
//     head) scale of the (B, S, 2H) scale slab, as models/whisper.py::
//     dequant_self does; then the bf16 mma.sync path runs.
//   * SELF: mask mode (models/whisper.py::make_step_mask) over head-flat
//     (B, S, H * 64) slabs: key j is visible to query t iff j < off[b], or
//     0 <= j - off[b] < TC and chunk bit j - off[b] of row t is set.  K10's
//     mask mode (K2 false) reads row t's bits as W = ceil(TC / 32) int32
//     words, bit r % 32 of word r / 32 (cd_visible_words, through the
//     read-only cache where a tile holds chunk keys), so TC runs to S; K2
//     packs its (T <= 16)-wide mask into one word a row in registers.
//   * K2: the decoder step's instantiations (K10's are K2 = false, their
//     code unchanged).  Launched with programmatic dependent launch beside
//     the cluster attribute (cd_launch); griddep_launch() at the top.  In
//     cross mode the CTA issues the cp.async groups of its K and V slices
//     (and, at int8, reads their scales) before griddep_wait() and reads q
//     only after it: the cross K/V are written by init_cache before the step
//     and by no kernel of the step, so the bytes that bound the kernel load
//     while the cross-q GEMM before it runs.  In mask mode it waits first and
//     reads nothing before: history rows were written by earlier steps'
//     launches, and a chain of early launches is not ordered against them.
//     Mask mode then also commits the chunk: the rank whose slice holds
//     position off + t (off + t < S) writes the chunk's fresh K/V row t
//     (kn, vn: K2's (B * T, H * 64) projection rows) into the slabs, bf16 as
//     it is or int8 quantized per (position, head) with sc = max(amax,
//     1e-30) / 127, rintf, clipped to +-127, bf16(sc) into the scale slab;
//     every rank stages the chunk's own keys from kn / vn, never from the
//     slab, so no CTA reads a row another CTA writes (history rows j < off
//     are read, rows off .. off + T - 1 written).  The chunk mask comes as
//     K2's (T, T) uint8 mask (TC = T), packed into bit rows in the kernel.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace wm {
namespace {   // internal linkage: every .cu gets its own copy

namespace cg = cooperative_groups;

constexpr int CD_DH = 64;          // head dim
constexpr int CD_MAXT = 16;        // query rows per (example, head): one m16 tile
constexpr int CD_WARPS = 8;
constexpr int CD_THREADS = 32 * CD_WARPS;
constexpr int CD_KEYS = 192;       // keys a CTA takes before the cluster grows
constexpr int CD_MAXC = 8;         // the portable cluster size
constexpr int CD_NT = 3;           // 16-key score tiles a warp holds in registers
constexpr int CD_MAXSLICE = CD_WARPS * 16 * CD_NT;  // 384 keys a CTA
constexpr int CD_QP = CD_DH + 8;   // bf16 pitch of q (and of self-mode K rows)

// The key split of S keys: C CTAs of SC keys (SC % 16 == 0); false past
// CD_MAXSLICE.  ops/decode_ops.py::cluster_split is the same rule.
bool cd_split(int s, int* c, int* sc) {
  const int want = (s + CD_KEYS - 1) / CD_KEYS;
  *c = want < CD_MAXC ? want : CD_MAXC;
  *sc = ((s + *c - 1) / *c + 15) / 16 * 16;
  return *sc <= CD_MAXSLICE;
}

// Shared-memory layout of one CTA (byte offsets; every region 16-byte
// aligned): the K slice, later P and, past it, the receive buffer of the PV
// partials the other ranks push; the V slice; q; the int8 scales of the
// slice; the row statistics, each rank's pushed into every rank.
struct CdSmem {
  int kp, vp;          // K and V pitches, in elements
  int recv, v, q, scales, stat, total;
};

__host__ __device__ inline int cd_round16(int x) { return (x + 15) / 16 * 16; }

// Floats of the PV receive buffer, per sending rank: rank r owns output
// rows t = r, r + C, ..., each 64 floats, at slot t / C.
__host__ __device__ inline int cd_own(int csize) {
  return (CD_MAXT + csize - 1) / csize * CD_DH;
}

__host__ __device__ inline CdSmem cd_smem(int sc, int csize, bool self_mode, int esize) {
  CdSmem l;
  l.kp = self_mode ? CD_QP : sc + (esize == 1 ? 16 : 8);
  l.vp = CD_DH + (esize == 1 ? 16 : 8);
  const int kb = (self_mode ? sc : CD_DH) * l.kp * esize;
  l.recv = cd_round16(CD_MAXT * (sc + 8) * 2);
  const int pb = l.recv + csize * cd_own(csize) * 4;
  l.v = cd_round16(kb > pb ? kb : pb);
  l.q = l.v + cd_round16(sc * l.vp * esize);
  l.scales = l.q + CD_MAXT * CD_QP * 2;
  l.stat = l.scales + (esize == 1 ? 2 * sc * 4 : 0);
  l.total = l.stat + (CD_WARPS + 2 * CD_MAXC) * CD_MAXT * 4;
  return l;
}

struct CdArgs {
  const bf16* q;
  const void* k;         // K2's mask mode: the slabs the commit writes
  const void* v;
  const float* ks;       // (B, H, S) int8 scales, or null
  const float* vs;
  const int* off;        // mask mode: (B,) offsets and (T,) chunk bit rows
  const int* bits;
  bf16* out;             // q's layout
  long long q_b, q_h, q_t;   // element strides of q and out
  int heads, t_len, s_len, kv_len, slice;
  int t_chunk;           // mask mode: the chunk's width (>= t_len; K2: == t_len <= 16)
  // K2's mask mode: the chunk's fresh K/V rows (B * T, H * 64), the (T, T)
  // uint8 chunk mask (in place of bits) and, with int8 slabs, their (B, S,
  // 2H) bf16 scale slab (K scales at head h, V at H + h).
  const bf16* kn;
  const bf16* vn;
  const uint8_t* mask;
  bf16* ss;
};

// The grid and shared memory of one instantiation over S keys (cd_plan).
struct CdPlan {
  int csize, slice, smem;
};

__device__ __forceinline__ int8_t quant8(float x, float sc) {
  return (int8_t)fminf(fmaxf(rintf(x / sc), -127.0f), 127.0f);
}

// 8 int8 values times a scale, each rounded to bf16 (the dequantized row).
__device__ __forceinline__ uint4 dequant8(uint2 raw, float sc) {
  return make_uint4(pack_bf2(i8_at(raw.x, 0) * sc, i8_at(raw.x, 1) * sc),
                    pack_bf2(i8_at(raw.x, 2) * sc, i8_at(raw.x, 3) * sc),
                    pack_bf2(i8_at(raw.y, 0) * sc, i8_at(raw.y, 1) * sc),
                    pack_bf2(i8_at(raw.y, 2) * sc, i8_at(raw.y, 3) * sc));
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? bytes : 0;   // 0: zero-fill, nothing read
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Two int8 elements of shared memory as a bf16 pair (lo = *lo), exactly.
__device__ __forceinline__ uint32_t bf_pair(const int8_t* lo, const int8_t* hi) {
  return pack_bf2((float)*lo, (float)*hi);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

template <bool SELF>
__device__ __forceinline__ bool cd_visible(int t, int jg, int t_len, int t_chunk, int s_len,
                                           int kv_len, int off, uint32_t bits) {
  if (t >= t_len) return false;
  if (!SELF) return jg < kv_len;
  if (jg < off) return true;
  const int r = jg - off;
  return r < t_chunk && jg < s_len && ((bits >> r) & 1u);
}

// K10's mask mode: the same test over row t's W words of chunk bits
// (rows: the launch's (T, W) int32 rows), bit r % 32 of word r / 32.
__device__ __forceinline__ bool cd_visible_words(int t, int jg, int t_len, int t_chunk,
                                                 int s_len, int off, const int* rows,
                                                 int words) {
  if (t >= t_len) return false;
  if (jg < off) return true;
  const int r = jg - off;
  return r < t_chunk && jg < s_len &&
         ((__ldg(reinterpret_cast<const unsigned*>(rows) + t * words + (r >> 5)) >> (r & 31)) &
          1u);
}

// K2's mask mode: stage the first `rows` keys of a slice of one head as bf16
// rows of `pitch` elements: keys j < hist from the slab (bf16 by cp.async;
// int8 dequantized as it is staged, with the key's scale scale[j * sstride]),
// keys hist <= j < n_load from the chunk's fresh rows (fresh + (j - hist) *
// ld), zero past n_load (nothing read; `base` is only an address).
template <typename KT>
__device__ __forceinline__ void cd_stage_self(bf16* dst, int pitch, const KT* slab,
                                              const bf16* fresh, const bf16* base,
                                              const bf16* scale, int sstride, int hist,
                                              int n_load, int rows, int ld, int tid) {
  for (int i = tid; i < rows * 8; i += CD_THREADS) {
    const int j = i >> 3, cc = (i & 7) * 8;
    bf16* d = dst + j * pitch + cc;
    if (j < hist) {
      if constexpr (sizeof(KT) == 1)
        *reinterpret_cast<uint4*>(d) =
            dequant8(*reinterpret_cast<const uint2*>(slab + (size_t)j * ld + cc),
                     bf2f(scale[(size_t)j * sstride]));
      else
        cp_async(d, slab + (size_t)j * ld + cc, 16, true);
    } else {
      const bool in = j < n_load;
      cp_async(d, in ? fresh + (size_t)(j - hist) * ld + cc : base, 16, in);
    }
  }
}

// grid (C, H, B), clusters of (C, 1, 1): one cluster per (head, example),
// rank r takes keys [r * SC, (r + 1) * SC).  The modes: see the file comment.
template <typename KT, bool SELF, bool K2>
__global__ void __launch_bounds__(CD_THREADS, 4) cross_decode_kernel(const CdArgs a) {
  // Shared memory holds K and V as KT, but self slabs always as bf16 (K2's
  // int8 slabs dequantized); Q: int8 cross K/V (scores times ks, P times vs).
  using ST = typename std::conditional<SELF, bf16, KT>::type;
  constexpr bool Q = sizeof(ST) == 1;
  constexpr int ES = sizeof(ST);
  if constexpr (K2) {
    griddep_launch();
    if constexpr (SELF) griddep_wait();   // mask mode reads nothing before its wait
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int sc = a.slice, j_start = rank * sc, s_len = a.s_len, t_len = a.t_len;
  const int d_model = a.heads * CD_DH;
  const int off = SELF ? a.off[b] : 0;
  const int kv_end = SELF ? min(off + a.t_chunk, s_len) : a.kv_len;
  const int n_load = max(0, min(sc, kv_end - j_start));   // keys of the slice read
  uint32_t bits0 = 0u, bits1 = 0u;
  if constexpr (SELF && K2) {
    for (int x = 0; x < t_len; ++x) {     // rows g, g + 8 of the (T, T) mask as bits
      if (g < t_len && a.mask[g * t_len + x]) bits0 |= 1u << x;
      if (g + 8 < t_len && a.mask[(g + 8) * t_len + x]) bits1 |= 1u << x;
    }
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const CdSmem L = cd_smem(sc, csize, SELF, ES);
  ST* ksm = reinterpret_cast<ST*>(smem);
  bf16* psm = reinterpret_cast<bf16*>(smem);               // P over the dead K slice
  float* recv = reinterpret_cast<float*>(smem + L.recv);   // [rank][cd_own] partials
  ST* vsm = reinterpret_cast<ST*>(smem + L.v);
  bf16* qsm = reinterpret_cast<bf16*>(smem + L.q);
  float* ksc = reinterpret_cast<float*>(smem + L.scales);
  float* vsc = ksc + sc;
  float* wstat = reinterpret_cast<float*>(smem + L.stat);  // [warp][16]
  float* xmax = wstat + CD_WARPS * CD_MAXT;                // [rank][16], pushed
  float* xsum = xmax + CD_MAXC * CD_MAXT;                  // [rank][16], pushed
  const int pp = sc + 8;                                   // P pitch

  // 1. K slice, then V slice, in flight as two groups.
  const KT* kg = static_cast<const KT*>(a.k);
  const KT* vg = static_cast<const KT*>(a.v);
  if constexpr (SELF && K2) {
    // History keys from the slabs, the chunk's keys from its fresh rows.
    const int hist = min(max(off - j_start, 0), n_load);
    const size_t slab0 = ((size_t)b * s_len + j_start) * d_model + h * CD_DH;
    const size_t fresh0 = ((size_t)b * t_len + max(j_start - off, 0)) * d_model + h * CD_DH;
    const bf16* ks0 = a.ss ? a.ss + ((size_t)b * s_len + j_start) * 2 * a.heads + h : nullptr;
    cd_stage_self<KT>(ksm, L.kp, kg + slab0, a.kn + fresh0, a.kn, ks0, 2 * a.heads, hist,
                      n_load, sc, d_model, tid);
    cp_async_commit();
    cd_stage_self<KT>(vsm, L.vp, vg + slab0, a.vn + fresh0, a.vn, ks0 ? ks0 + a.heads : nullptr,
                      2 * a.heads, hist, n_load, sc, d_model, tid);
    cp_async_commit();
    // The commit: this rank's chunk positions off + t (below S), one warp a
    // row, from the fresh rows; int8 quantized per (position, head).
    KT* sk = static_cast<KT*>(const_cast<void*>(a.k));
    KT* sv = static_cast<KT*>(const_cast<void*>(a.v));
    const int t_end = min(t_len, min(j_start + sc, s_len) - off);
    for (int t = max(j_start - off, 0) + warp; t < t_end; t += CD_WARPS) {
      const size_t src = ((size_t)b * t_len + t) * d_model + h * CD_DH;
      const size_t dst = ((size_t)b * s_len + off + t) * d_model + h * CD_DH;
      if constexpr (sizeof(KT) == 1) {
        const float k0 = bf2f(a.kn[src + lane]), k1 = bf2f(a.kn[src + lane + 32]);
        const float v0 = bf2f(a.vn[src + lane]), v1 = bf2f(a.vn[src + lane + 32]);
        const float kq = fmaxf(warp_max(fmaxf(fabsf(k0), fabsf(k1))), 1e-30f) / 127.0f;
        const float vq = fmaxf(warp_max(fmaxf(fabsf(v0), fabsf(v1))), 1e-30f) / 127.0f;
        sk[dst + lane] = quant8(k0, kq);
        sk[dst + lane + 32] = quant8(k1, kq);
        sv[dst + lane] = quant8(v0, vq);
        sv[dst + lane + 32] = quant8(v1, vq);
        if (lane == 0) {
          bf16* srow = a.ss + ((size_t)b * s_len + off + t) * 2 * a.heads + h;
          srow[0] = f2bf(kq);
          srow[a.heads] = f2bf(vq);
        }
      } else {
        reinterpret_cast<uint32_t*>(sk + dst)[lane] =
            reinterpret_cast<const uint32_t*>(a.kn + src)[lane];
        reinterpret_cast<uint32_t*>(sv + dst)[lane] =
            reinterpret_cast<const uint32_t*>(a.vn + src)[lane];
      }
    }
  } else {
    if constexpr (SELF) {
      const KT* src = kg + ((size_t)b * s_len + j_start) * d_model + h * CD_DH;
      for (int i = tid; i < sc * 8; i += CD_THREADS) {
        const int j = i >> 3, cc = (i & 7) * 8;
        const bool in = j < n_load;
        cp_async(ksm + j * L.kp + cc, in ? src + (size_t)j * d_model + cc : kg, 16, in);
      }
    } else {
      // Warp w copies K rows w, w + 4, ...; lane l four keys at 4 l, 4 l + 128, ...
      const KT* src = kg + ((size_t)b * a.heads + h) * CD_DH * s_len + j_start;
      for (int d = warp; d < CD_DH; d += CD_WARPS)
        for (int j = 4 * lane; j < sc; j += 128) {
          const bool in = j < n_load;
          cp_async(ksm + d * L.kp + j, in ? src + (size_t)d * s_len + j : kg, 4 * ES, in);
        }
    }
    cp_async_commit();
    constexpr int CH = 16 / ES, NCH = CD_DH / CH;   // elements per copy, copies per row
    const KT* src = vg + ((size_t)b * s_len + j_start) * d_model + h * CD_DH;
    for (int i = tid; i < sc * NCH; i += CD_THREADS) {
      const int j = i / NCH, cc = (i % NCH) * CH;
      const bool in = j < n_load;
      cp_async(vsm + j * L.vp + cc, in ? src + (size_t)j * d_model + cc : vg, 16, in);
    }
    cp_async_commit();
  }
  if constexpr (Q) {
    const size_t row = ((size_t)b * a.heads + h) * s_len + j_start;
    for (int j = tid; j < sc; j += CD_THREADS) {
      ksc[j] = j < n_load ? a.ks[row + j] : 0.0f;
      vsc[j] = j < n_load ? a.vs[row + j] : 0.0f;
    }
  }
  // K2's cross mode: the K/V slices (and scales) are in flight; q, written
  // by the cross-q projection, only after the wait.
  if constexpr (K2 && !SELF) griddep_wait();
  const bf16* qg = a.q + b * a.q_b + h * a.q_h;
  for (int i = tid; i < CD_MAXT * 8; i += CD_THREADS) {
    const int t = i >> 3, cc = (i & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < t_len) val = *reinterpret_cast<const uint4*>(qg + t * a.q_t + cc);
    *reinterpret_cast<uint4*>(qsm + t * CD_QP + cc) = val;
  }
  cp_async_wait<1>();
  __syncthreads();

  // 2. Scores of this warp's 16-key tiles warp, warp + 4, ...: rows g, g + 8,
  // keys j0 + 8 h + 2c, + 1 in s[i][h].  bf16 K fragments come by ldmatrix
  // (transposed from the head-major rows of cross K), int8 ones are built
  // and converted exactly from shared memory.
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* q0 = qsm + g * CD_QP + 16 * kk + 2 * c;
    qa[kk][0] = ld32(q0);
    qa[kk][1] = ld32(q0 + 8 * CD_QP);
    qa[kk][2] = ld32(q0 + 8);
    qa[kk][3] = ld32(q0 + 8 * CD_QP + 8);
  }
  // Keys of the slice before vis_all are visible to every query row (cross:
  // below kv_len; mask mode: the committed history, below off).
  const int vis_all = (SELF ? off : a.kv_len) - j_start;
  const bool row0 = g < t_len, row1 = g + 8 < t_len;
  float s[CD_NT][2][4];
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < CD_NT; ++i) {
    const int j0 = (warp + CD_WARPS * i) * 16;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][hh][e] = -INFINITY;
    if (j0 >= n_load) continue;    // warp-uniform: no key of the tile was read
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][hh][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (Q) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const ST* kr = ksm + (16 * kk + 2 * c) * L.kp + j0 + 8 * hh + g;
          mma16816(s[i][hh], qa[kk], bf_pair(kr, kr + L.kp),
                   bf_pair(kr + 8 * L.kp, kr + 9 * L.kp));
        }
      } else if constexpr (SELF) {
        if (kk & 1) continue;      // one ldmatrix covers k-steps kk, kk + 1
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t f[4];
          ldsm_x4(f, reinterpret_cast<const bf16*>(ksm) +
                         (j0 + 8 * hh + (lane & 7)) * L.kp + 16 * kk + (lane >> 3) * 8);
          mma16816(s[i][hh], qa[kk], f[0], f[1]);
          mma16816(s[i][hh], qa[kk + 1], f[2], f[3]);
        }
      } else {
        uint32_t f[4];
        ldsm_x4_t(f, reinterpret_cast<const bf16*>(ksm) +
                         (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * L.kp + j0 +
                         (lane >> 4) * 8);
        mma16816(s[i][0], qa[kk], f[0], f[1]);
        mma16816(s[i][1], qa[kk], f[2], f[3]);
      }
    }
    const bool all = j0 + 16 <= vis_all;     // warp-uniform
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = g + 8 * (e >> 1), j = j0 + 8 * hh + 2 * c + (e & 1);
        bool vis;
        if constexpr (SELF && !K2)
          vis = all ? (e < 2 ? row0 : row1)
                    : j < n_load && cd_visible_words(t, j_start + j, t_len, a.t_chunk, s_len,
                                                     off, a.bits, (a.t_chunk + 31) >> 5);
        else
          vis = all ? (e < 2 ? row0 : row1)
                    : j < n_load && cd_visible<SELF>(t, j_start + j, t_len, a.t_chunk, s_len,
                                                     a.kv_len, off, e < 2 ? bits0 : bits1);
        s[i][hh][e] = vis ? s[i][hh][e] * (Q ? ksc[j] : 1.0f) : -INFINITY;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx0 = fmaxf(mx0, fmaxf(s[i][hh][0], s[i][hh][1]));
      mx1 = fmaxf(mx1, fmaxf(s[i][hh][2], s[i][hh][3]));
    }
  }

  // 3. Row maxima: the quad, the warps, then pushed to every rank of the
  // cluster (remote stores), which takes the max of the C locally.
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  if (c == 0) {
    wstat[warp * CD_MAXT + g] = mx0;
    wstat[warp * CD_MAXT + g + 8] = mx1;
  }
  __syncthreads();
  if (tid < CD_MAXT * csize) {     // thread -> (destination rank, row)
    const int t = tid % CD_MAXT;
    float m = wstat[t];
    for (int w = 1; w < CD_WARPS; ++w) m = fmaxf(m, wstat[w * CD_MAXT + t]);
    cluster.map_shared_rank(xmax, tid / CD_MAXT)[rank * CD_MAXT + t] = m;
  }
  cluster.sync();
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int r = 0; r < csize; ++r) {
    m0 = fmaxf(m0, xmax[r * CD_MAXT + g]);
    m1 = fmaxf(m1, xmax[r * CD_MAXT + g + 8]);
  }
  // exp(s - max) in place (ex2 of the scaled difference: the result is
  // rounded to bf16), and the row sums in a fixed order: tiles, the quad,
  // the warps, then every rank's pushed sum in rank order.
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int i = 0; i < CD_NT; ++i) {
    if ((warp + CD_WARPS * i) * 16 >= n_load) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[i][hh][e] = s[i][hh][e] == -INFINITY
                          ? 0.0f
                          : __expf(s[i][hh][e] - (e < 2 ? m0 : m1));
      l0 += s[i][hh][0];
      l0 += s[i][hh][1];
      l1 += s[i][hh][2];
      l1 += s[i][hh][3];
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (c == 0) {                    // (the cluster barrier ordered the maxima's reads)
    wstat[warp * CD_MAXT + g] = l0;
    wstat[warp * CD_MAXT + g + 8] = l1;
  }
  __syncthreads();
  if (tid < CD_MAXT * csize) {
    const int t = tid % CD_MAXT;
    float l = wstat[t];
    for (int w = 1; w < CD_WARPS; ++w) l += wstat[w * CD_MAXT + t];
    cluster.map_shared_rank(xsum, tid / CD_MAXT)[rank * CD_MAXT + t] = l;
  }
  cluster.sync();
  l0 = xsum[g];
  l1 = xsum[g + 8];
  for (int r = 1; r < csize; ++r) {
    l0 += xsum[r * CD_MAXT + g];
    l1 += xsum[r * CD_MAXT + g + 8];
  }
  // P = exp(s - max) / sum (times the value scale at int8), rounded to bf16
  // once, over the K slice (every thread of this CTA is past its scores);
  // tiles past the keys read are zero.  A real row's sum is at least 1
  // (its max contributes exp(0)); the clamp keeps the padding rows (t >= T,
  // sum 0) off the division's slow path.
  const float i0 = 1.0f / fmaxf(l0, 1.0f), i1 = 1.0f / fmaxf(l1, 1.0f);
#pragma unroll
  for (int i = 0; i < CD_NT; ++i) {
    const int j0 = (warp + CD_WARPS * i) * 16;
    if (j0 >= sc) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = j0 + 8 * hh + 2 * c;
      float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j0 < n_load) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = s[i][hh][e] * (e < 2 ? i0 : i1) * (Q ? vsc[j + (e & 1)] : 1.0f);
      }
      *reinterpret_cast<uint32_t*>(psm + g * pp + j) = pack_bf2(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(psm + (g + 8) * pp + j) = pack_bf2(p[2], p[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 4. Partial PV: warp w owns columns 8w..8w+7.
  float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int nks = (n_load + 15) / 16;
  for (int ks = 0; ks < nks; ++ks) {
    const bf16* p0 = psm + g * pp + 16 * ks + 2 * c;
    const uint32_t pa[4] = {ld32(p0), ld32(p0 + 8 * pp), ld32(p0 + 8), ld32(p0 + 8 * pp + 8)};
    if constexpr (Q) {
      const ST* vr = vsm + (16 * ks + 2 * c) * L.vp + 8 * warp + g;
      mma16816(o, pa, bf_pair(vr, vr + L.vp), bf_pair(vr + 8 * L.vp, vr + 9 * L.vp));
    } else {
      uint32_t f[2];
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                   : "=r"(f[0]), "=r"(f[1])
                   : "r"(static_cast<unsigned>(__cvta_generic_to_shared(
                       reinterpret_cast<const bf16*>(vsm) +
                       (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * L.vp + 8 * warp))));
      mma16816(o, pa, f[0], f[1]);
    }
  }
  const int own = cd_own(csize);
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int t = g + 4 * e;
    if (t < t_len) {
      float* dst = cluster.map_shared_rank(recv, t % csize) + rank * own +
                   (t / csize) * CD_DH + 8 * warp + 2 * c;
      dst[0] = o[e];
      dst[1] = o[e + 1];
    }
  }
  cluster.sync();
  bf16* og = a.out + b * a.q_b + h * a.q_h;
  for (int u = tid; u < own; u += CD_THREADS) {
    const int t = (u / CD_DH) * csize + rank;
    if (t < t_len) {
      float acc = recv[u];
      for (int r = 1; r < csize; ++r) acc += recv[r * own + u];
      og[t * a.q_t + u % CD_DH] = f2bf(acc);
    }
  }
}

// The split of S keys and the shared memory of cross_decode_kernel<KT,
// SELF, K2>, set on the kernel (above 48 KB it needs the attribute, which
// belongs to the current device's context): once per call of a C entry.
template <typename KT, bool SELF, bool K2>
int cd_plan(int s_len, CdPlan* p) {
  if (!cd_split(s_len, &p->csize, &p->slice)) return (int)cudaErrorInvalidValue;
  p->smem = cd_smem(p->slice, p->csize, SELF, SELF ? 2 : (int)sizeof(KT)).total;
  auto kern = cross_decode_kernel<KT, SELF, K2>;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
}

// The launch over `batch` examples, grid (C, H, B) in clusters of C; K2's
// instantiations also under programmatic dependent launch.  `attr` must
// outlive the config.
template <bool K2>
cudaLaunchConfig_t cd_config(const CdPlan& p, int heads, int batch, cudaStream_t stream,
                             cudaLaunchAttribute (&attr)[2]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.csize, heads, batch);
  cfg.blockDim = dim3(CD_THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K2 ? 2 : 1;
  return cfg;
}

template <typename KT, bool SELF, bool K2>
int cd_launch(CdArgs a, const CdPlan& p, int batch, cudaStream_t stream) {
  a.slice = p.slice;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = cd_config<K2>(p, a.heads, batch, stream, attr);
  auto kern = cross_decode_kernel<KT, SELF, K2>;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// How many clusters of the instantiation the card can hold at once
// (cudaOccupancyMaxActiveClusters; after cd_plan), or -1 on an error.
template <typename KT, bool SELF, bool K2>
int cd_max_clusters(const CdPlan& p, int heads, int batch) {
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = cd_config<K2>(p, heads, batch, nullptr, attr);
  auto kern = cross_decode_kernel<KT, SELF, K2>;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return err == cudaSuccess ? n : -1;
}

}  // namespace
}  // namespace wm
