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
// Design (the body, cross_decode_kernel, lives in cluster_attn.cuh, shared
// with K2's self- and cross-attention): one thread-block cluster of C CTAs
// per (head, example) splits the S keys into C contiguous slices of SC keys,
// C = min(8, ceil(S / 192)) and SC = ceil(S / C) rounded up to 16, both from
// S alone (never from B, H or the data), so a (b, h)'s arithmetic and its
// order of sums do not depend on what it is batched with.  Each CTA (8 warps):
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
// Chunks past 16 rows (T > 16: a chain of 16 or more heads, a tree of more
// than 16 nodes): a launch takes one m16 tile of queries, so
// ops/decode_ops.py blocks the rows into 16-row launches.  Cross-attention
// rows are independent: each block is one more launch on the same K/V.  In
// mask mode block j passes its own rows of chunk bits over all TC columns at
// the same offsets, W = ceil(TC / 32) int32 words a row (bit r % 32 of word
// r / 32), so TC may be any width up to S; a tile of keys below the offset
// is visible to every row without a look at the bits, and the words are
// read (through the read-only cache) only for the tiles that hold the
// chunk's keys.
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
#include "cluster_attn.cuh"
#include "common.cuh"
#include "ffma_attn.cuh"
#include "ffma_gemm.cuh"
#include "wgemm.cuh"

namespace wm {
namespace {

// K10's launch: plan (the shared memory set on every call) and launch.
template <typename KT, bool SELF>
int k10_launch(const CdArgs& a, int batch, cudaStream_t stream) {
  CdPlan p;
  const int err = cd_plan<KT, SELF, false>(a.s_len, &p);
  return err ? err : cd_launch<KT, SELF, false>(a, p, batch, stream);
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
  return ks ? k10_launch<int8_t, false>(a, B, st) : k10_launch<bf16, false>(a, B, st);
}

// Mask mode: q (B, T, H, 64) bf16, pre-scaled, T <= 16 query rows of a chunk
// of T <= TC <= S tokens (a block of its rows); k, v (B, S, H * 64) bf16 (the
// self slabs, S = max_len); offsets (B,) int32; chunk_bits (T, ceil(TC / 32))
// int32, the block's rows (bit j % 32 of word j / 32 of row t: query t sees
// chunk key j < TC); out (B, T, H, 64) bf16.
extern "C" int wm_self_decode(const void* q, const void* k, const void* v,
                              const void* offsets, const void* chunk_bits, void* out, int B,
                              int H, int T, int S, int TC, void* stream) {
  using namespace wm;
  if (B < 1 || H < 1 || T < 1 || T > CD_MAXT || TC < T || S < TC)
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
  return k10_launch<bf16, true>(a, B, (cudaStream_t)stream);
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

// ---------------------------------------------------------------------------
// The f32 modes (the JAX package's default dtype), FFMA on the CUDA cores:
// the tensor cores take f32 only as TF32.
//
// K10's f32 mode, wm_cross_decode_f32 and wm_self_decode_f32: the same
// function as tools/decode_kernels_experiment.py::_cross_kernel on f32 q, K
// and V (P not rounded: the TPU kernel rounds it to the value dtype, f32
// here), and in the mask mode the same visibility as wm_self_decode (keys at
// or past off + TC neither read nor counted).  The body lives in
// ffma_attn.cuh (shared with K2's W8A32 mode) and follows the bf16 mode's:
// one thread-block cluster of C CTAs per (head, example) over the key
// slices of cd_split (from S alone: large-v2's 1500 cross keys 8 x 192, a
// 460-row self slab 3 x 160), each CTA staging its K and V slice (cross:
// one TMA box each; mask mode: cp.async of the rows read), FFMA scores from
// shared memory in register tiles over (keys x
// query rows), NR = 1, 4, 8 or 16 rows from T (a T = 1 step computes one),
// the row maxima and then the row sums merged through distributed shared
// memory, the PV partials added in rank order by each row's owner rank:
// one launch a call, no scratch.  Each (example, head)'s arithmetic and its
// order of sums depend on S and T only, so an example's bits do not depend
// on the batch.  Bound by bytes: 768 KB of f32 K and V per (example, head)
// at S = 1500.
//
// K11's f32 mode, wm_ffn_decode_f32: fc1 with the exact-erf GELU, then fc2
// with its bias, each one launch of ffma_gemm.cuh's f32 weight stream (K
// slices from (K, N) alone, added in rank order across a cluster, the
// epilogue in the same kernel), fc2 under programmatic dependent launch
// behind fc1 (its first W stages stream while fc1 finishes), h (M, F) f32
// between them.  Bound by bytes at the decode step's M: 52.4 MB of f32
// weights at large-v2.
//
// wm_gemm_f32 is that GEMM alone: out (nh, M, N) = epi(x @ w + b), the
// Medusa heads' rows of the f32 two-pass verification (EPI_SILU_RESID) and
// the per-op step's f32 projections (EPI_BIAS).
//
// W8A32 (the int8 copy of an f32 model): wm_cross_decode_w8a32 is K10's f32
// mode on int8 K/V with f32 (B, H, S) scales (the per-op step's cross-
// attention; decode_attn_f32_kernel<NR, false, Q8 = true>: the slices staged
// as int8, each value converted exactly, a score times its key's scale
// before the mask, a probability times its value's scale before the PV
// product), bound by the 384 KB of int8 K and V per (example, head) at S =
// 1500; wm_gemm_w8a32 is wm_gemm_f32 on int8 (nh, K, N) weights with f32
// (nh, N) scales (ffma_gemm.cuh's int8-weight mode: the two-pass loop's
// head rows on int8 heads), the scale on the sum before the bias, one
// launch and no scratch.

// q (B, H, T, 64) f32; k (B, H, 64, S), v (B, S, H * 64) f32, S % 4 == 0;
// out (B, H, T, 64) f32.
extern "C" int wm_cross_decode_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int H, int T, int S, int kv_len, void* stream) {
  using namespace wm;
  if (B < 1 || H < 1 || T < 1 || T > CD_MAXT || S % 4 || kv_len < 1 || kv_len > S)
    return (int)cudaErrorInvalidValue;
  DfArgs a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.q_b = (long long)H * T * CD_DH;
  a.q_h = (long long)T * CD_DH;
  a.q_t = CD_DH;
  a.heads = H;
  a.t_len = T;
  a.t_chunk = T;
  a.s_len = S;
  a.kv_len = kv_len;
  return k10_f32_launch<false>(a, B, (cudaStream_t)stream);
}

// K10's f32 mask mode: q and out (B, T, H, 64) f32; k, v (B, S, H * 64) f32
// self slabs; offsets (B,) and chunk bits (T, ceil(TC / 32)) int32.
extern "C" int wm_self_decode_f32(const void* q, const void* k, const void* v,
                                  const void* offsets, const void* chunk_bits, void* out, int B,
                                  int H, int T, int S, int TC, void* stream) {
  using namespace wm;
  if (B < 1 || H < 1 || T < 1 || T > CD_MAXT || TC < T || S < TC)
    return (int)cudaErrorInvalidValue;
  DfArgs a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.off = static_cast<const int*>(offsets);
  a.bits = static_cast<const int*>(chunk_bits);
  a.out = static_cast<float*>(out);
  a.q_b = (long long)T * H * CD_DH;
  a.q_h = CD_DH;
  a.q_t = (long long)H * CD_DH;
  a.heads = H;
  a.t_len = T;
  a.t_chunk = TC;
  a.s_len = S;
  a.kv_len = S;
  return k10_f32_launch<true>(a, B, (cudaStream_t)stream);
}

// x (M, D), w1 (D, F), b1 (F,), w2 (F, D), b2 (D,) f32; h (M, F) f32
// scratch; y (M, D) f32 out.  D multiple of 64, F of 64 and 32; x, w1, w2,
// the biases, h and y 16-byte aligned.
extern "C" int wm_ffn_decode_f32(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* h, void* y, int M,
                                 int D, int F, void* stream) {
  using namespace wm;
  cudaStream_t st = (cudaStream_t)stream;
  int err = fg_launch(static_cast<const float*>(x), w1, nullptr, static_cast<const float*>(b1),
                      nullptr, static_cast<float*>(h), M, D, F, 1, EPI_BIAS_GELU, st);
  if (err == 0)
    err = fg_launch(static_cast<const float*>(h), w2, nullptr, static_cast<const float*>(b2),
                    nullptr, static_cast<float*>(y), M, F, D, 1, EPI_BIAS, st);
  return err;
}

// out (NH, M, N) = epi(x (M, K) @ w (NH, K, N) + b (NH, N)) in f32; b may
// be null; resid (M, N) for EPI_SILU_RESID.  K % 32 == 0, N % 64 == 0,
// every operand 16-byte aligned.
extern "C" int wm_gemm_f32(const void* x, const void* w, const void* b, const void* resid,
                           void* out, int M, int K, int N, int NH, int epi, void* stream) {
  using namespace wm;
  return fg_launch(static_cast<const float*>(x), w, nullptr, static_cast<const float*>(b),
                   static_cast<const float*>(resid), static_cast<float*>(out), M, K, N, NH, epi,
                   (cudaStream_t)stream);
}

// K10's W8A32 mode: q (B, H, T, 64) f32; k (B, H, 64, S), v (B, S, H * 64)
// int8 with ks, vs (B, H, S) f32, S % 4 == 0; out as wm_cross_decode_f32's.
extern "C" int wm_cross_decode_w8a32(const void* q, const void* k, const void* v,
                                     const void* ks, const void* vs, void* out, int B, int H,
                                     int T, int S, int kv_len, void* stream) {
  using namespace wm;
  if (B < 1 || H < 1 || T < 1 || T > CD_MAXT || S % 4 || kv_len < 1 || kv_len > S || !ks ||
      !vs)
    return (int)cudaErrorInvalidValue;
  DfArgs a = {};
  a.q = static_cast<const float*>(q);
  a.k8 = static_cast<int8_t*>(const_cast<void*>(k));
  a.v8 = static_cast<int8_t*>(const_cast<void*>(v));
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.out = static_cast<float*>(out);
  a.q_b = (long long)H * T * CD_DH;
  a.q_h = (long long)T * CD_DH;
  a.q_t = CD_DH;
  a.heads = H;
  a.t_len = T;
  a.t_chunk = T;
  a.s_len = S;
  a.kv_len = kv_len;
  return k10_f32_launch<false, true>(a, B, (cudaStream_t)stream);
}

// out (NH, M, N) = epi(x (M, K) @ (wq (NH, K, N) * s (NH, N)) + b (NH, N))
// in f32, the scale on the sum before the bias; b may be null; resid (M, N)
// for EPI_SILU_RESID.  K % 32 == 0, N % 64 == 0, every operand 16-byte
// aligned.
extern "C" int wm_gemm_w8a32(const void* x, const void* wq, const void* s, const void* b,
                             const void* resid, void* out, int M, int K, int N, int NH, int epi,
                             void* stream) {
  using namespace wm;
  if (!s) return (int)cudaErrorInvalidValue;
  return fg_launch(static_cast<const float*>(x), wq, static_cast<const float*>(s),
                   static_cast<const float*>(b), static_cast<const float*>(resid),
                   static_cast<float*>(out), M, K, N, NH, epi, (cudaStream_t)stream);
}
