// K3 — decode-time vocab projection Y[M, V] = X[M, D] @ E[V, D]^T, f32 out,
// for the bf16 tied embedding (the drafts of the prefill and of pass B).
//
// Replaces whisper_medusa_tpu/ops/logits.py::_logits_kernel (TPU, launched
// by _project via project_logits_stream), which streams the tied embedding
// in 2048-row tiles against query rows resident in VMEM.  Here it is the
// weight stream of ntstream.cuh, shared with K7's int8 embedding: a
// persistent grid walks the 64-entry vocab tiles, one producer warp keeps a
// TMA ring of bf16 E tiles (128-byte swizzle: the layout wgmma reads, no
// conversion) and the matching x tiles (ceil(M / 16) * 16 rows, zero-filled
// past M) in flight, one consumer warpgroup runs one m64nNk16 wgmma a
// 16-deep step (E the 64-row side, the rows the N side) and writes the f32
// sums from the accumulators.  Each output is one chain over K in order, so
// a row's bits do not depend on M.  The ragged last tile (51865 = 810 x 64 +
// 25) is zero-filled by TMA and masked on store.  Up to 192 rows a launch.
//
// Bound on H100: the embedding stream (51865 x 1280 bf16 = 133 MB per call)
// plus M x 207 KB of f32 output.
#include "ntstream.cuh"

extern "C" int wm_logits(const void* x, const void* e, void* y, int m, int v, int d,
                         void* stream) {
  return wm::nt_launch<false>(x, e, nullptr, y, m, v, d, (cudaStream_t)stream);
}

// K3's f32 mode, wm_logits_f32: Y[M, V] = X[M, D] @ E[V, D]^T for an f32
// tied embedding (the JAX package's default dtype), FFMA on the CUDA cores
// (the tensor cores take f32 only as TF32).  A CTA (256 threads) per
// (64-entry vocab tile, pass of up to 128 rows), a tile's passes adjacent
// in the grid so that its E rows come from L2 after the first; ffma.cuh's
// NT tile computes the sums, each one chain over D in order, so a row's
// logits do not depend on M.  Any M a launch.  Bound on H100: the 265 MB
// f32 embedding stream (79 us at 3.35 TB/s) at the drafts' M, the 2 M V D
// products at the CUDA cores' 67 TFLOP/s past M ~ 160 rows.
#include "ffma.cuh"

namespace wm {
namespace {

template <int MT>
__global__ void __launch_bounds__(FF_THREADS)
logits_f32_kernel(const float* __restrict__ x, const float* __restrict__ e,
                  float* __restrict__ y, int m, int v, int d, int passes) {
  __shared__ __align__(16) float sm[2 * ff_stage_floats<MT>()];
  const int tile = blockIdx.x / passes, pass = blockIdx.x % passes;
  const int v0 = tile * FF_COLS, r0 = pass * 16 * MT;
  const int rows = min(16 * MT, m - r0);
  float acc[MT][4];
  ffma_tile<MT, true>(acc, x + (size_t)r0 * d, d, rows, e + (size_t)v0 * d, d,
                      min(FF_COLS, v - v0), 0, d, sm);
  const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = tr * MT + i;
    if (r >= rows) continue;
    float* yr = y + (size_t)(r0 + r) * v + v0 + 4 * tc;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (v0 + 4 * tc + j < v) yr[j] = acc[i][j];
  }
}

template <int MT = 1>
int logits_f32_launch(int mt, const float* x, const float* e, float* y, int m, int v, int d,
                      cudaStream_t st) {
  if (mt == MT) {
    const int passes = (m + 16 * MT - 1) / (16 * MT);
    const int tiles = (v + FF_COLS - 1) / FF_COLS;
    logits_f32_kernel<MT><<<tiles * passes, FF_THREADS, 0, st>>>(x, e, y, m, v, d, passes);
    return (int)cudaGetLastError();
  }
  if constexpr (MT < FF_MAX_MT) return logits_f32_launch<MT * 2>(mt, x, e, y, m, v, d, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wm

// x (M, D), e (V, D), y (M, V), all f32; D % 16 == 0; x and e 16-byte
// aligned.
extern "C" int wm_logits_f32(const void* x, const void* e, void* y, int m, int v, int d,
                             void* stream) {
  using namespace wm;
  if (m < 1 || v < 1 || d < FF_KC || d % FF_KC) return (int)cudaErrorInvalidValue;
  return logits_f32_launch(ff_mt(m), static_cast<const float*>(x), static_cast<const float*>(e),
                           static_cast<float*>(y), m, v, d, (cudaStream_t)stream);
}
