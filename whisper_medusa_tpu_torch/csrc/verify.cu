// K4 — fused verification with in-kernel row construction (verify_hidden),
// and K5 — fused verification of prebuilt rows (verify_rows).
//
// Replaces whisper_medusa_tpu/ops/verify.py::_kernel_hidden (TPU, launched
// by verify_hidden).  The TPU kernel builds the (R, D) rows in VMEM at grid
// step 0 and then streams the tied embedding, folding per-row statistics
// across the sequential grid.  Hopper's CTAs run in parallel and in no
// order, so the fold becomes a reduction across CTAs — three launches behind
// one C entry:
//
//  (A) rows[k * BN + n] = src[n] + bf16(SiLU(src[n] @ W_k + b_k)) for every
//      head k: the skinny GEMM of common.cuh batched over heads (row block
//      0 is head 0 — the base_head verification row — or the hidden state
//      itself when identity0);
//  (B) one CTA per 64-entry vocab tile scores all R <= 128 rows on the
//      tensor cores (common.cuh::vocab_tile), applies suppress /
//      begin-suppress / exponential EOS decay exactly as _process_tile
//      (verify.py:100-128), and writes per-(tile, row) partial max, argmax,
//      sum of exp and the value at gcol;
//  (C) one warp per row combines the tiles.  Argmax ties break to the
//      lowest column inside a tile and across tiles (the JAX fold keeps the
//      earlier maximum); suppressed columns take NEG = -f32max/2, not -inf,
//      so fully suppressed rows still give finite statistics.
//
// The logits never exist in device memory.  Bound on H100: stage B's 16
// GFLOP of bf16 products at R = 121 (tensor cores) plus the 133 MB
// embedding stream; stage A streams the 11 heads (36 MB).
//
// K5 replaces whisper_medusa_tpu/ops/verify.py::_kernel (TPU, launched by
// verify_rows): the same vocab stream and row statistics over R <= 1024 rows
// that the caller built — the B vanilla rows hidden[None], or the B*N head-0
// verification rows of the two-pass loop at batch.  It is stages B and C
// above with a second grid dimension over 128-row blocks (vocab_tile holds
// 128 rows): grid (ceil(V / 64), ceil(R / 128)), partial statistics
// (3, R, ntiles).  Bound on H100: the 133 MB embedding stream (40 us at
// 3.35 TB/s) up to R ~ 250 rows, then the 2 * R * V * D products (R = 1024:
// 136 GFLOP, 0.14 ms at 989 TFLOP/s; counted from the shapes).  Each
// 128-row block re-reads the embedding tile, from L2 when the blocks of one
// tile run together; a row's arithmetic does not depend on R.
//
// wm_head_rows is stage A alone: rows[k * M + m] = src[m] +
// bf16(SiLU(src[m] @ W_k + b_k)) for M <= 128 source rows, the same skinny
// GEMM and epilogue as K4's stage A, so a head row has the same bits whether
// K4 builds it or the two-pass loop does.
//
// int8 serving (the JAX kernels' quant / hquant modes) rides the same three
// entries: an int8 embedding (V, D) with f32 scales (V,) is converted to bf16
// as vocab_tile stages it and column v's sum is multiplied by s[v] before the
// processors (66 MB stream instead of 133 MB); int8 heads (nh, D, D) with
// f32 scales (nh, D) take the skinny GEMM's W8A16 form.  A null scale
// pointer selects the bf16 form.
#include "common.cuh"

namespace wm {
namespace {

template <typename ET>
__global__ void __launch_bounds__(VTHREADS)
verify_tile_kernel(const bf16* __restrict__ rows, int n_rows, const ET* __restrict__ e,
                   const float* __restrict__ escale, int v_dim, int d_dim,
                   const int* __restrict__ pos,
                   const int* __restrict__ gcol, const int8_t* __restrict__ sup,
                   int begin_index, int eos_id, int has_decay, int decay_start,
                   float log_factor, float* __restrict__ part_f,
                   int* __restrict__ part_a) {
  extern __shared__ __align__(128) char smem[];
  const float* cs = reinterpret_cast<const float*>(smem + VRB * VLDS * 2 + VT * VLDS * 2);
  const int v0 = blockIdx.x * VT;
  const int row0 = blockIdx.y * VRB;
  vocab_tile(rows, n_rows, row0, e, v_dim, d_dim, v0, smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t ntile_rows = (size_t)gridDim.x * n_rows;
  for (int rr = 0; rr < 16; ++rr) {
    const int rl = warp * 16 + rr;
    const int r = row0 + rl;
    if (r >= n_rows) break;
    const int p = pos[r];
    const int gc = gcol[r];
    float x[2];
    int col[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = lane + 32 * hh;
      col[hh] = v0 + c;
      float val = cs[rl * VLDC + c];
      if (col[hh] >= v_dim) {
        val = NEG_VERIFY;
      } else {
        if constexpr (sizeof(ET) == 1) val *= escale[col[hh]];
        if (sup[col[hh]]) val = NEG_VERIFY;
        if (sup[v_dim + col[hh]] && p == begin_index) val = NEG_VERIFY;
        if (has_decay && col[hh] == eos_id && p > decay_start) {
          const float idx = (float)max(p - decay_start, 0);
          val = val + fabsf(val) * (expf(idx * log_factor) - 1.0f);
        }
      }
      x[hh] = val;
    }
    float m = x[0];
    int a = col[0];
    if (x[1] > m) { m = x[1]; a = col[1]; }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, o);
      const int oa = __shfl_xor_sync(0xffffffffu, a, o);
      if (om > m || (om == m && oa < a)) { m = om; a = oa; }
    }
    const float s = warp_sum(expf(x[0] - m) + expf(x[1] - m));
    const float g = warp_max(fmaxf(col[0] == gc ? x[0] : NEG_VERIFY,
                                   col[1] == gc ? x[1] : NEG_VERIFY));
    if (lane == 0) {
      const size_t idx = (size_t)r * gridDim.x + blockIdx.x;   // row-major: (R, tiles)
      part_f[idx] = m;
      part_f[ntile_rows + idx] = s;
      part_f[2 * ntile_rows + idx] = g;
      part_a[idx] = a;
    }
  }
}

__device__ __forceinline__ void merge(float& m, int& a, float& s, float m2, int a2,
                                      float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) { m = m2; a = a2; s = s2; return; }
  const float mn = fmaxf(m, m2);
  if (m2 > m || (m2 == m && a2 < a)) a = a2;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__global__ void __launch_bounds__(256)
verify_combine_kernel(const float* __restrict__ part_f, const int* __restrict__ part_a,
                      int ntiles, int n_rows, float* __restrict__ o_max,
                      float* __restrict__ o_lse, int* __restrict__ o_arg,
                      float* __restrict__ o_gth) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;
  const size_t nt = (size_t)ntiles * n_rows;
  float m = -INFINITY, s = 0.0f, g = NEG_VERIFY;
  int a = 0x7fffffff;
  for (int t = lane; t < ntiles; t += 32) {
    const size_t idx = (size_t)r * ntiles + t;
    merge(m, a, s, part_f[idx], part_a[idx], part_f[nt + idx]);
    g = fmaxf(g, part_f[2 * nt + idx]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const int a2 = __shfl_xor_sync(0xffffffffu, a, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, a, s, m2, a2, s2);
  }
  g = warp_max(g);
  if (lane == 0) {
    o_max[r] = m;
    o_lse[r] = m + logf(s);
    o_arg[r] = a;
    o_gth[r] = g;
  }
}

template <typename ET>
inline void launch_tiles(dim3 grid, const bf16* rows, int n_rows, const void* e,
                         const float* escale, int v_dim, int d_dim, const int* pos,
                         const int* gcol, const int8_t* sup, int begin_index, int eos_id,
                         int has_decay, int decay_start, float log_factor, float* part_f,
                         int* part_a, cudaStream_t st) {
  // Per launch: the attribute belongs to the current device's context.
  cudaFuncSetAttribute(verify_tile_kernel<ET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       VOCAB_SMEM);
  verify_tile_kernel<ET><<<grid, VTHREADS, VOCAB_SMEM, st>>>(
      rows, n_rows, static_cast<const ET*>(e), escale, v_dim, d_dim, pos, gcol, sup,
      begin_index, eos_id, has_decay, decay_start, log_factor, part_f, part_a);
}

// Stages B and C over rows (n_rows, D): every 128-row block of every vocab
// tile, then the per-row combine.  e is bf16, or int8 when escale is set.
inline void score_rows(const bf16* rows, int n_rows, const void* e, const float* escale,
                       int v_dim, int d_dim, const int* pos, const int* gcol,
                       const int8_t* sup, int begin_index, int eos_id, int has_decay,
                       int decay_start, float log_factor, float* part_f, int* part_a,
                       float* o_max, float* o_lse, int* o_arg, float* o_gth,
                       cudaStream_t st) {
  const int ntiles = (v_dim + VT - 1) / VT;
  const dim3 grid(ntiles, (n_rows + VRB - 1) / VRB);
  if (escale)
    launch_tiles<int8_t>(grid, rows, n_rows, e, escale, v_dim, d_dim, pos, gcol, sup,
                         begin_index, eos_id, has_decay, decay_start, log_factor, part_f,
                         part_a, st);
  else
    launch_tiles<bf16>(grid, rows, n_rows, e, nullptr, v_dim, d_dim, pos, gcol, sup,
                       begin_index, eos_id, has_decay, decay_start, log_factor, part_f,
                       part_a, st);
  verify_combine_kernel<<<(n_rows + 7) / 8, 256, 0, st>>>(
      part_f, part_a, ntiles, n_rows, o_max, o_lse, o_arg, o_gth);
}

}  // namespace
}  // namespace wm

// Pointer table of wm_verify_hidden (ops/verify.py builds the same list).
enum VerifyPtr {
  V_HVER = 0,   // (BN, D) bf16 row-block-0 source (identity0 only)
  V_HSRC16,     // (16, D) bf16 draft-row source, zero-padded to 16 rows
  V_HEADS_W,    // (nh, D, D) bf16, or int8 with V_HEADS_S
  V_HEADS_B,    // (nh, D) bf16
  V_EMBED,      // (V, D) bf16, or int8 with V_EMBED_S
  V_POS,        // (R,) int32
  V_GCOL,       // (R,) int32
  V_SUP,        // (2, V) int8 [suppress; begin-suppress]
  V_ROWS,       // (R, D) bf16 scratch
  V_PART_F,     // (3, R, ntiles) f32 scratch
  V_PART_A,     // (R, ntiles) int32 scratch
  V_MAX, V_LSE, V_ARG, V_GTH,   // (R,) outputs
  V_EMBED_S,    // (V,) f32 int8-embedding scales, or null (bf16 embedding)
  V_HEADS_S,    // (nh, D) f32 int8-head scales, or null (bf16 heads)
  V_COUNT
};

// ints: BN, D, V, n_heads, identity0, begin_index, eos_id, has_decay,
// decay_start.  R = (n_heads + identity0) * BN <= 128.
extern "C" int wm_verify_hidden(void** p, const int* ints, float log_factor,
                                void* stream) {
  using namespace wm;
  const int BN = ints[0], D = ints[1], V = ints[2], NH = ints[3], id0 = ints[4];
  const int begin_index = ints[5], eos_id = ints[6], has_decay = ints[7];
  const int decay_start = ints[8];
  const int R = (NH + id0) * BN;
  cudaStream_t st = (cudaStream_t)stream;
  if (BN > 16 || R > VRB || D % 64) return (int)cudaErrorInvalidValue;
  bf16* rows = static_cast<bf16*>(p[V_ROWS]);
  // (A) row construction.
  if (id0)
    cudaMemcpyAsync(rows, p[V_HVER], (size_t)BN * D * sizeof(bf16),
                    cudaMemcpyDeviceToDevice, st);
  const bf16* src = static_cast<const bf16*>(p[V_HSRC16]);
  SkinnyJobs heads;
  heads.j[0] = job(p[V_HEADS_W], static_cast<const bf16*>(p[V_HEADS_B]),
                   rows + (size_t)id0 * BN * D, EPI_SILU_RESID, src, 1.0f,
                   static_cast<const float*>(p[V_HEADS_S]));
  skinny_gemm(src, D, BN, D, D, D, D, heads, 1, NH, (long long)D * D, D,
              (long long)BN * D, st);
  // (B) vocab tiles, (C) combine.
  score_rows(rows, R, p[V_EMBED], static_cast<const float*>(p[V_EMBED_S]), V, D,
             static_cast<const int*>(p[V_POS]), static_cast<const int*>(p[V_GCOL]),
             static_cast<const int8_t*>(p[V_SUP]), begin_index, eos_id, has_decay,
             decay_start, log_factor, static_cast<float*>(p[V_PART_F]),
             static_cast<int*>(p[V_PART_A]), static_cast<float*>(p[V_MAX]),
             static_cast<float*>(p[V_LSE]), static_cast<int*>(p[V_ARG]),
             static_cast<float*>(p[V_GTH]), st);
  return (int)cudaGetLastError();
}

// Pointer table of wm_verify_rows (ops/verify.py builds the same list).
enum VerifyRowsPtr {
  VR_ROWS = 0,   // (R, D) bf16 rows to score
  VR_EMBED,      // (V, D) bf16, or int8 with VR_EMBED_S
  VR_POS,        // (R,) int32
  VR_GCOL,       // (R,) int32
  VR_SUP,        // (2, V) int8 [suppress; begin-suppress]
  VR_PART_F,     // (3, R, ntiles) f32 scratch
  VR_PART_A,     // (R, ntiles) int32 scratch
  VR_MAX, VR_LSE, VR_ARG, VR_GTH,   // (R,) outputs
  VR_EMBED_S,    // (V,) f32 int8-embedding scales, or null (bf16 embedding)
  VR_COUNT
};

constexpr int VR_MAX_ROWS = 1024;   // the JAX kernel's _MAX_R

// ints: R, D, V, begin_index, eos_id, has_decay, decay_start.
extern "C" int wm_verify_rows(void** p, const int* ints, float log_factor,
                              void* stream) {
  using namespace wm;
  const int R = ints[0], D = ints[1], V = ints[2], begin_index = ints[3];
  const int eos_id = ints[4], has_decay = ints[5], decay_start = ints[6];
  if (R < 1 || R > VR_MAX_ROWS || D % VKC) return (int)cudaErrorInvalidValue;
  score_rows(static_cast<const bf16*>(p[VR_ROWS]), R, p[VR_EMBED],
             static_cast<const float*>(p[VR_EMBED_S]), V, D, static_cast<const int*>(p[VR_POS]), static_cast<const int*>(p[VR_GCOL]),
             static_cast<const int8_t*>(p[VR_SUP]), begin_index, eos_id, has_decay,
             decay_start, log_factor, static_cast<float*>(p[VR_PART_F]),
             static_cast<int*>(p[VR_PART_A]), static_cast<float*>(p[VR_MAX]),
             static_cast<float*>(p[VR_LSE]), static_cast<int*>(p[VR_ARG]),
             static_cast<float*>(p[VR_GTH]), (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// out (NH, M, D) = src + bf16(SiLU(src @ W_k + b_k)) for each head k; src has
// ceil(M / 16) * 16 rows allocated, w (NH, D, D), b (NH, D), all bf16; or w
// int8 with f32 scales ws (NH, D) (null for bf16 heads).
extern "C" int wm_head_rows(const void* src, const void* w, const void* b, void* out,
                            const void* ws, int m, int d, int nh, void* stream) {
  using namespace wm;
  if (m < 1 || m > SK_MAX_ROWS || d % 64 || nh < 1) return (int)cudaErrorInvalidValue;
  SkinnyJobs heads;
  heads.j[0] = job(w, static_cast<const bf16*>(b), static_cast<bf16*>(out), EPI_SILU_RESID,
                   static_cast<const bf16*>(src), 1.0f, static_cast<const float*>(ws));
  skinny_gemm(static_cast<const bf16*>(src), d, m, d, d, d, d, heads, 1, nh,
              (long long)d * d, d, (long long)m * d, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
