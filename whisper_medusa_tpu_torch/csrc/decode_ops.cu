// K10 and K11 — the per-op decoder step's attention and FFN
// (ops/decode_ops.py), the path that serves what K2 does not take (B > 8,
// T > 16, widths off K2's scope).
//
// K10, wm_cross_decode, replaces tools/decode_kernels_experiment.py::
// _cross_kernel (one program per example, the head loop unrolled): q (B, H,
// T <= 16, 64) bf16, pre-scaled; K head-major (B, H, 64, S); V head-flat
// (B, S, H * 64); out (B, H, T, 64) bf16.  f32 scores (times the key's scale
// at int8), keys >= kv_len get probability 0, an f32 softmax over the whole
// row, P (times the value's scale at int8) rounded to bf16 once, an f32 PV
// and the output rounded to bf16 once.  Bound by bytes: 384 KB of bf16 K and
// V per (example, head) at S = 1500, 122.9 MB at large-v2 and B = 16.
//
// Design: one thread-block cluster of C CTAs per (head, example) splits the
// S keys into C contiguous slices of SC keys, C = min(8, ceil(S / 192)) and
// SC = ceil(S / C) rounded up to 16, both from S alone (never from B, H or
// the data), so a (b, h)'s arithmetic and its order of sums do not depend on
// what it is batched with.  Each CTA (8 warps):
//   1. issues cp.async copies of its K slice (8-byte copies of four keys of
//      a K row at bf16, 4-byte at int8: K rows are 3000 or 1500 bytes, not a
//      multiple of 16, so TMA cannot map them) as one group and of its V rows
//      (16-byte copies) as a second, so that V is in flight while the scores
//      are computed; keys past the visible end are zero-filled, not read;
//   2. computes its (16 x SC) scores on the tensor cores, mma.sync m16n8k16
//      (the T <= 16 queries are one m16 tile, rows >= T zero), bf16 operands
//      and f32 sums: bf16 K fragments by ldmatrix (transposed for cross K's
//      head-major rows), int8 K converted exactly to bf16 between shared
//      memory and the product; the scores stay in registers;
//   3. pushes its row maxima into every rank's shared memory (remote stores
//      through distributed shared memory), and after a cluster barrier each
//      CTA takes the max of the C; then the row sums of exp(s - max) the same
//      way, added in rank order; it normalises its P with the global max and
//      sum and rounds it to bf16 once, into shared memory over the dead K
//      slice;
//   4. computes its partial (16 x 64) PV on the tensor cores (warp w owns
//      columns 8w..8w+7, V fragments by transposing ldmatrix at bf16) and
//      pushes row t to rank t % C, which adds the C partials in rank order
//      after a third barrier: one fixed order, no atomics.
// Waves: at S = 1500, C = 8 and SC = 192; a CTA holds 25 KB of K, 27 KB of V,
// 2.3 KB of q and 1.5 KB of statistics at bf16 (57 KB: four CTAs an SM, as
// its 64 registers a thread allow), half of K and V at int8 (33 KB).  B = 16
// at large-v2 is 320 clusters, 2560 CTAs, 4.8 waves of 528; whisper tiny at
// B = 8 is 48 clusters, 384 CTAs, one wave.  S up to 8 x 384 = 3072 keys (3
// score tiles of 16 keys a warp in registers).
//
// Mask mode, wm_self_decode: the same kernel over the decoder's bf16 self
// slabs, head-flat K and V (B, S = max_len, H * 64), q and out (B, T, H,
// 64), with models/whisper.py::make_step_mask's mask in place of kv_len: key
// j is visible to query t of example b iff j < off[b], or 0 <= j - off[b] <
// TC and bit j - off[b] of chunk_bits[t], TC the chunk's width.  Keys at or
// past off[b] + TC are neither read nor counted (a masked logit gives an
// exact 0 after the softmax); the slices come from max_len alone, so each
// example's bits are its B=1 bits (the per-op step's self-attention is
// batch-invariant).
//
// Chunks past 16 rows (T > 16: a chain of 16 or more heads): a launch takes
// one m16 tile of queries, so ops/decode_ops.py blocks the rows into 16-row
// launches.  Cross-attention rows are independent: each block is one more
// launch on the same K/V.  In mask mode block j passes its own rows of
// chunk bits over all TC columns at the same offsets (TC <= 32, the bits of
// one int32).
//
// K11, wm_ffn_decode, replaces tools/decode_kernels_experiment.py::
// _ffn_kernel (a sequential grid over F / 512 column blocks accumulating
// into an f32 VMEM scratch): h = bf16(gelu_erf(x @ W1 + b1)) (exact erf, not
// the TPU kernel's A&S 7.1.26), then y = bf16(h @ W2 + b2), the f32 sums
// plus the bias rounded once.  Bound by bytes: the 26.2 MB of bf16 weights
// at large-v2 (7.8 us at 3.35 TB/s), whatever M is.  The entry launches
// K2's weight-streaming GEMM (wgemm.cuh) twice under programmatic dependent
// launch, fc1 with EPI_BIAS_GELU into the (M, F) scratch h and fc2 with
// EPI_BIAS, so fc2's CTAs stream W2 while fc1 finishes:
//   * up to 192 rows a call (one m64nNk16 of N = ceil(M / 16) * 16 a step,
//     the rows TMA-loaded from a tensor map over exactly M rows and
//     zero-filled past them), so B = 16's 176-row chunk reads each weight
//     once; the wrapper blocks rows past 192 (ops/decode_ops.py);
//   * K slices from (K, N) alone (gemm_slices: large-v2 fc1 2 x 80 CTAs, fc2
//     7 x 20) and ring stages from (K, N) alone (ffn_stages: the longest
//     slice, at most 3, so two CTAs of 192 rows fit an SM), added in rank
//     order across a cluster: a row's result does not depend on M;
//   * the weights' 3-D tensor maps (L = 1, layer 0) are encoded once per
//     weight and kept (encode_map_cached); only x's and h's maps are
//     encoded per call.
#include <cooperative_groups.h>

#include "common.cuh"
#include "wgemm.cuh"

namespace wm {
namespace {

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
  const void* k;
  const void* v;
  const float* ks;       // (B, H, S) int8 scales, or null
  const float* vs;
  const int* off;        // mask mode: (B,) offsets and (T,) chunk bit rows
  const int* bits;
  bf16* out;             // q's layout
  long long q_b, q_h, q_t;   // element strides of q and out
  int heads, t_len, s_len, kv_len, slice;
  int t_chunk;           // mask mode: the chunk's width (>= t_len, <= 32)
};

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

// grid (C, H, B), clusters of (C, 1, 1): one cluster per (head, example),
// rank r takes keys [r * SC, (r + 1) * SC).
template <typename KT, bool SELF>
__global__ void __launch_bounds__(CD_THREADS, 4) cross_decode_kernel(const CdArgs a) {
  constexpr bool Q = sizeof(KT) == 1;
  constexpr int ES = sizeof(KT);
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
  const uint32_t bits0 = SELF && g < t_len ? (uint32_t)a.bits[g] : 0u;
  const uint32_t bits1 = SELF && g + 8 < t_len ? (uint32_t)a.bits[g + 8] : 0u;

  extern __shared__ __align__(16) unsigned char smem[];
  const CdSmem L = cd_smem(sc, csize, SELF, ES);
  KT* ksm = reinterpret_cast<KT*>(smem);
  bf16* psm = reinterpret_cast<bf16*>(smem);               // P over the dead K slice
  float* recv = reinterpret_cast<float*>(smem + L.recv);   // [rank][cd_own] partials
  KT* vsm = reinterpret_cast<KT*>(smem + L.v);
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
  {
    constexpr int CH = 16 / ES, NCH = CD_DH / CH;   // elements per copy, copies per row
    const KT* src = vg + ((size_t)b * s_len + j_start) * d_model + h * CD_DH;
    for (int i = tid; i < sc * NCH; i += CD_THREADS) {
      const int j = i / NCH, cc = (i % NCH) * CH;
      const bool in = j < n_load;
      cp_async(vsm + j * L.vp + cc, in ? src + (size_t)j * d_model + cc : vg, 16, in);
    }
  }
  cp_async_commit();
  const bf16* qg = a.q + b * a.q_b + h * a.q_h;
  for (int i = tid; i < CD_MAXT * 8; i += CD_THREADS) {
    const int t = i >> 3, cc = (i & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < t_len) val = *reinterpret_cast<const uint4*>(qg + t * a.q_t + cc);
    *reinterpret_cast<uint4*>(qsm + t * CD_QP + cc) = val;
  }
  if constexpr (Q) {
    const size_t row = ((size_t)b * a.heads + h) * s_len + j_start;
    for (int j = tid; j < sc; j += CD_THREADS) {
      ksc[j] = j < n_load ? a.ks[row + j] : 0.0f;
      vsc[j] = j < n_load ? a.vs[row + j] : 0.0f;
    }
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
          const KT* kr = ksm + (16 * kk + 2 * c) * L.kp + j0 + 8 * hh + g;
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
        const bool vis =
            all ? (e < 2 ? row0 : row1)
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
      const KT* vr = vsm + (16 * ks + 2 * c) * L.vp + 8 * warp + g;
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

template <typename KT, bool SELF>
int cd_launch(CdArgs a, int batch, cudaStream_t stream) {
  int csize, sc;
  if (!cd_split(a.s_len, &csize, &sc)) return (int)cudaErrorInvalidValue;
  a.slice = sc;
  const CdSmem l = cd_smem(sc, csize, SELF, (int)sizeof(KT));
  auto kern = cross_decode_kernel<KT, SELF>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, l.total);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, a.heads, batch);
  cfg.blockDim = dim3(CD_THREADS);
  cfg.dynamicSmemBytes = l.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

constexpr int FFN_MAX_STAGES = 3;   // ring stages: two CTAs of 192 rows fit an SM

// Ring stages of K11's GEMM over a (K, N) weight, from (K, N) alone: its
// longest K slice, within [2, FFN_MAX_STAGES] (ops/decode_ops.py::ffn_plan).
inline int ffn_stages(int k, int n) {
  const int slices = gemm_slices(k, n, 1), chunks = k / G_TILE;
  const int longest = (chunks + slices - 1) / slices;
  return longest < 2 ? 2 : (longest > FFN_MAX_STAGES ? FFN_MAX_STAGES : longest);
}

// A (K, N) bf16 weight as a 3-D (1, K, N) map, box (64, 64, 1), 128-byte
// swizzle: wgemm_kernel's W operand at layer 0.  Kept after the first call.
int ffn_weight_map(CUtensorMap* map, const void* w, int k, int n) {
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)k, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)n * sizeof(bf16), (cuuint64_t)k * n * sizeof(bf16)};
  const cuuint32_t box[3] = {G_TILE, G_TILE, 1};
  return encode_map_cached(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
}  // namespace wm

// q (B, H, T, 64) bf16; k (B, H, 64, S), v (B, S, H * 64) bf16, or int8 with
// ks, vs (B, H, S) f32 (null for bf16); out (B, H, T, 64) bf16.
extern "C" int wm_cross_decode(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, void* out, int B, int H,
                               int T, int S, int kv_len, void* stream) {
  using namespace wm;
  if (B < 1 || H < 1 || T < 1 || T > CD_MAXT || S % 4 || kv_len < 1 || kv_len > S ||
      (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  CdArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.out = static_cast<bf16*>(out);
  a.q_b = (long long)H * T * CD_DH;
  a.q_h = (long long)T * CD_DH;
  a.q_t = CD_DH;
  a.heads = H;
  a.t_len = T;
  a.t_chunk = T;
  a.s_len = S;
  a.kv_len = kv_len;
  cudaStream_t st = (cudaStream_t)stream;
  return ks ? cd_launch<int8_t, false>(a, B, st) : cd_launch<bf16, false>(a, B, st);
}

// Mask mode: q (B, T, H, 64) bf16, pre-scaled, T <= 16 query rows of a chunk
// of TC <= 32 tokens (a block of its rows); k, v (B, S, H * 64) bf16 (the
// self slabs, S = max_len); offsets (B,) int32; chunk_bits (T,) int32, the
// block's rows (bit j of row t: query t sees chunk key j < TC); out (B, T, H,
// 64) bf16.
extern "C" int wm_self_decode(const void* q, const void* k, const void* v,
                              const void* offsets, const void* chunk_bits, void* out, int B,
                              int H, int T, int S, int TC, void* stream) {
  using namespace wm;
  if (B < 1 || H < 1 || T < 1 || T > CD_MAXT || TC < T || TC > 32 || S < TC)
    return (int)cudaErrorInvalidValue;
  CdArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = k;
  a.v = v;
  a.off = static_cast<const int*>(offsets);
  a.bits = static_cast<const int*>(chunk_bits);
  a.out = static_cast<bf16*>(out);
  a.q_b = (long long)T * H * CD_DH;
  a.q_h = CD_DH;
  a.q_t = (long long)H * CD_DH;
  a.heads = H;
  a.t_len = T;
  a.t_chunk = TC;
  a.s_len = S;
  a.kv_len = S;
  return cd_launch<bf16, true>(a, B, (cudaStream_t)stream);
}

// x (M, D), w1 (D, F), b1 (F,), w2 (F, D), b2 (D,) bf16; h (M, F) bf16
// scratch; y (M, D) bf16 out.  1 <= M <= 192; D, F multiples of 64; x, w1,
// w2 and h 16-byte aligned (the tensor-map encoder refuses another address:
// the entry then returns TENSOR_MAP_ERROR + its error).
extern "C" int wm_ffn_decode(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* h, void* y, int M, int D, int F,
                             void* stream) {
  using namespace wm;
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || M > 16 * G_MAX_MT || D < G_TILE || F < G_TILE || D % G_TILE || F % G_TILE)
    return (int)cudaErrorInvalidValue;
  const int mt = (M + 15) / 16;
  CUtensorMap mx, mh, mw1, mw2;
  int err = encode_x_map(&mx, static_cast<const bf16*>(x), M, D, mt);
  if (err == 0) err = encode_x_map(&mh, static_cast<const bf16*>(h), M, F, mt);
  if (err == 0) err = ffn_weight_map(&mw1, w1, D, F);
  if (err == 0) err = ffn_weight_map(&mw2, w2, F, D);
  if (err != 0) return err;
  GemmJobs fc1, fc2;
  fc1.j[0] = gjob(static_cast<const bf16*>(b1), static_cast<bf16*>(h), EPI_BIAS_GELU);
  fc2.j[0] = gjob(static_cast<const bf16*>(b2), static_cast<bf16*>(y), EPI_BIAS);
  const int s1 = ffn_stages(D, F), s2 = ffn_stages(F, D);
  const int smem1 = gemm_smem(mt, false, s1, false), smem2 = gemm_smem(mt, false, s2, false);
  wgemm_set_smem<G_MAX_MT, false>(mt, smem1 > smem2 ? smem1 : smem2);
  err = wgemm_launch<G_MAX_MT, false>(mt, s1, smem1, st, mx, mw1, mw1, mw1, 1, fc1, 0, M, D, F,
                                      F, F);
  if (err == 0)
    err = wgemm_launch<G_MAX_MT, false>(mt, s2, smem2, st, mh, mw2, mw2, mw2, 1, fc2, 0, M, F,
                                        D, D, D);
  return err != 0 ? err : (int)cudaGetLastError();
}
