// K10 and K11 — the per-op decoder step's cross-attention and FFN
// (ops/decode_ops.py), the path that serves what K2 does not take (B > 8,
// T > 16, widths off K2's scope).
//
// K10, wm_cross_decode, replaces tools/decode_kernels_experiment.py::
// _cross_kernel (one program per example, the head loop unrolled): q (B, H,
// T, 64) bf16, pre-scaled; K head-major (B, H, 64, S); V head-flat (B, S,
// H * 64); out (B, H, T, 64) bf16.  One CTA of 512 threads per (head,
// example).  The (T, S) f32 score block stays in shared memory, so the
// softmax runs over the whole row and P is rounded to bf16 once before the
// PV product, as in the TPU kernel and the plain version:
//   scores: each thread owns four consecutive keys and reads them from each
//           of the 64 K rows with one 8-byte load (4-byte at int8);
//   softmax: one warp per query row; keys >= kv_len get probability 0 (the
//           JAX NEG_BIG mask);
//   PV:     warp w takes keys w, w + 16, ..., each lane two of the head's 64
//           columns of the V row (one 128-byte row per warp and key); the 16
//           warps' partial sums are added in a fixed tree order in shared
//           memory (no atomics: deterministic).
// int8 mode (non-null scales, (B, H, S) f32): K and V are int8, converted
// exactly to bf16 as they are read; each score is multiplied by its key's
// scale before the max, each probability by its value's scale before the
// bf16 rounding, the denominator left unscaled.  Bound by bytes: at
// large-v2 and B = 16, 122.9 MB of bf16 cross K/V per call (counted from the
// shapes).
//
// K11, wm_ffn_decode, replaces tools/decode_kernels_experiment.py::
// _ffn_kernel (a sequential grid over F / 512 column blocks accumulating
// into an f32 VMEM scratch).  A GPU's CTAs run in parallel, so the entry
// runs two launches of the skinny tensor-core GEMM of common.cuh over up to
// 128 rows: h = bf16(gelu_erf(x @ W1 + b1)) (exact erf, not the TPU
// kernel's A&S 7.1.26), then y = bf16(h @ W2 + b2), the f32 sum plus the
// bias rounded once.  Each weight is read once per call, K is split over 16
// warps and summed in a fixed order, so a row's result does not depend on M.
#include "common.cuh"

namespace wm {
namespace {

constexpr int CD_DH = 64;        // head dim
constexpr int CD_MAXT = 16;      // query rows per (example, head)
constexpr int CD_THREADS = 512;
constexpr int CD_WARPS = CD_THREADS / 32;

// Four bf16 values (8 bytes) as floats.
__device__ __forceinline__ void unpack4(uint2 raw, float* out) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = bf2f(e[i]);
}

// Two consecutive values of a bf16 or int8 row as floats.
__device__ __forceinline__ void load2(const bf16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}
__device__ __forceinline__ void load2(const int8_t* p, float& a, float& b) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  a = (float)v.x;
  b = (float)v.y;
}

// Dynamic shared memory: q (16 x 64), scores (T x S), PV partials (8 x T x
// 64), all f32.
template <typename KT>
__global__ void __launch_bounds__(CD_THREADS)
cross_decode_kernel(const bf16* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, bf16* __restrict__ out, int n_heads,
                    int t_len, int s_len, int kv_len) {
  constexpr bool Q = sizeof(KT) == 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ps = qs + CD_MAXT * CD_DH;
  float* red = ps + (size_t)t_len * s_len;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * n_heads + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = n_heads * CD_DH;

  const bf16* qh = q + bh * t_len * CD_DH;
  for (int i = tid; i < t_len * CD_DH; i += CD_THREADS) qs[i] = bf2f(qh[i]);
  __syncthreads();

  // Scores.  S % 4 == 0, so a thread's four keys never cross the row's end.
  const KT* kh = k + bh * CD_DH * s_len;
  const float* ksr = Q ? ks + bh * s_len : nullptr;
  for (int j0 = tid * 4; j0 < kv_len; j0 += CD_THREADS * 4) {
    float acc[CD_MAXT][4];
#pragma unroll
    for (int t = 0; t < CD_MAXT; ++t)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[t][x] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < CD_DH; ++c) {
      float kv[4];
      unpack4(load4(kh + (size_t)c * s_len + j0), kv);
#pragma unroll
      for (int t = 0; t < CD_MAXT; ++t) {
        if (t < t_len) {
          const float qv = qs[t * CD_DH + c];
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[t][x] += qv * kv[x];
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = j0 + x;
      if (j < kv_len) {
        const float sc = Q ? ksr[j] : 1.0f;
#pragma unroll
        for (int t = 0; t < CD_MAXT; ++t)
          if (t < t_len) ps[(size_t)t * s_len + j] = acc[t][x] * sc;
      }
    }
  }
  __syncthreads();

  // Softmax over the kv_len visible keys of each row, then P rounded to
  // bf16 (times the value scale first at int8).
  const float* vsr = Q ? vs + bh * s_len : nullptr;
  for (int t = warp; t < t_len; t += CD_WARPS) {
    float* row = ps + (size_t)t * s_len;
    float m = -INFINITY;
    for (int j = lane; j < kv_len; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.0f;
    for (int j = lane; j < kv_len; j += 32) l += expf(row[j] - m);
    l = warp_sum(l);
    for (int j = lane; j < kv_len; j += 32)
      row[j] = bfr(expf(row[j] - m) / l * (Q ? vsr[j] : 1.0f));
  }
  __syncthreads();

  // PV: warp w sums keys w, w + 16, ...; lane l owns columns 2l, 2l + 1.
  const KT* vh = v + (size_t)b * s_len * d + h * CD_DH + 2 * lane;
  float o[CD_MAXT][2];
#pragma unroll
  for (int t = 0; t < CD_MAXT; ++t) o[t][0] = o[t][1] = 0.0f;
#pragma unroll 4
  for (int j = warp; j < kv_len; j += CD_WARPS) {
    float v0, v1;
    load2(vh + (size_t)j * d, v0, v1);
#pragma unroll
    for (int t = 0; t < CD_MAXT; ++t) {
      if (t < t_len) {
        const float p = ps[(size_t)t * s_len + j];
        o[t][0] += p * v0;
        o[t][1] += p * v1;
      }
    }
  }
  // Fixed-order tree over the warps: the upper half hands its sums to the
  // lower half, 16 -> 8 -> 4 -> 2 -> 1.
  for (int half = CD_WARPS / 2; half >= 1; half >>= 1) {
    if (warp >= half && warp < 2 * half) {
      float* r = red + (size_t)(warp - half) * t_len * CD_DH;
#pragma unroll
      for (int t = 0; t < CD_MAXT; ++t) {
        if (t < t_len) {
          r[t * CD_DH + 2 * lane] = o[t][0];
          r[t * CD_DH + 2 * lane + 1] = o[t][1];
        }
      }
    }
    __syncthreads();
    if (warp < half) {
      const float* r = red + (size_t)warp * t_len * CD_DH;
#pragma unroll
      for (int t = 0; t < CD_MAXT; ++t) {
        if (t < t_len) {
          o[t][0] += r[t * CD_DH + 2 * lane];
          o[t][1] += r[t * CD_DH + 2 * lane + 1];
        }
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
    bf16* oh = out + bh * t_len * CD_DH;
#pragma unroll
    for (int t = 0; t < CD_MAXT; ++t)
      if (t < t_len)
        *reinterpret_cast<__nv_bfloat162*>(oh + t * CD_DH + 2 * lane) =
            __floats2bfloat162_rn(o[t][0], o[t][1]);
  }
}

}  // namespace
}  // namespace wm

// Shared memory of one K10 CTA; ops/decode_ops.py checks the same sum.
static size_t cross_decode_smem(int t_len, int s_len) {
  using namespace wm;
  return ((size_t)CD_MAXT * CD_DH + (size_t)t_len * s_len +
          (size_t)(CD_WARPS / 2) * t_len * CD_DH) * sizeof(float);
}

// q (B, H, T, 64) bf16; k (B, H, 64, S), v (B, S, H * 64) bf16, or int8 with
// ks, vs (B, H, S) f32 (null for bf16); out (B, H, T, 64) bf16.
extern "C" int wm_cross_decode(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, void* out, int B, int H,
                               int T, int S, int kv_len, void* stream) {
  using namespace wm;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = cross_decode_smem(T, S);
  if (T < 1 || T > CD_MAXT || S % 4 || kv_len < 1 || kv_len > S || smem > 227 * 1024 ||
      (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  if (ks) {
    cudaFuncSetAttribute(cross_decode_kernel<int8_t>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cross_decode_kernel<int8_t><<<grid, CD_THREADS, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const int8_t*>(k),
        static_cast<const int8_t*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<bf16*>(out), H, T, S, kv_len);
  } else {
    cudaFuncSetAttribute(cross_decode_kernel<bf16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cross_decode_kernel<bf16><<<grid, CD_THREADS, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), nullptr, nullptr, static_cast<bf16*>(out), H, T, S,
        kv_len);
  }
  return (int)cudaGetLastError();
}

// x (ceil(M / 16) * 16, D) bf16 rows (rows >= M ignored), w1 (D, F), b1 (F,),
// w2 (F, D), b2 (D,) bf16; h (ceil(M / 16) * 16, F) bf16 scratch; y (M, D)
// bf16 out.  M <= 128; D, F multiples of 64.
extern "C" int wm_ffn_decode(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* h, void* y, int M, int D, int F,
                             void* stream) {
  using namespace wm;
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || M > SK_MAX_ROWS || D % 64 || F % 64) return (int)cudaErrorInvalidValue;
  SkinnyJobs fc1;
  fc1.j[0] = job(w1, static_cast<const bf16*>(b1), static_cast<bf16*>(h), EPI_BIAS_GELU);
  skinny_gemm(static_cast<const bf16*>(x), D, M, D, F, F, F, fc1, 1, 1, 0, 0, 0, st);
  SkinnyJobs fc2;
  fc2.j[0] = job(w2, static_cast<const bf16*>(b2), static_cast<bf16*>(y), EPI_BIAS);
  skinny_gemm(static_cast<const bf16*>(h), F, M, F, D, D, D, fc2, 1, 1, 0, 0, 0, st);
  return (int)cudaGetLastError();
}
