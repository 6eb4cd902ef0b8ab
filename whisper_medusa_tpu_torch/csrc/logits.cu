// K3 — decode-time vocab projection Y[M, V] = X[M, D] @ E[V, D]^T, f32 out.
//
// Replaces whisper_medusa_tpu/ops/logits.py::_logits_kernel (TPU, launched
// by _project via project_logits_stream), which streams the tied embedding
// in 2048-row tiles against query rows resident in VMEM.  Here one CTA
// (8 warps) per 64-entry vocab tile stages the rows and the tile through
// shared memory in 64-wide K slices and multiplies them with WMMA
// (common.cuh::vocab_tile); rows are processed in blocks of 128, so any
// M <= 192 works.  The ragged last tile (51865 = 810 x 64 + 25) is zero-filled
// on load and masked on store.
//
// Bound on H100: the embedding stream (51865 x 1280 bf16 = 133 MB per call at
// M <= 16); the rows are re-read from L2 by every tile.
#include "common.cuh"

namespace wm {
namespace {

__global__ void __launch_bounds__(VTHREADS)
logits_kernel(const bf16* __restrict__ x, const bf16* __restrict__ e,
              float* __restrict__ y, int m_rows, int v_dim, int d_dim) {
  extern __shared__ __align__(128) char smem[];
  const float* cs = reinterpret_cast<const float*>(smem + VRB * VLDS * 2 + VT * VLDS * 2);
  const int v0 = blockIdx.x * VT;
  for (int row0 = 0; row0 < m_rows; row0 += VRB) {
    vocab_tile(x, m_rows, row0, e, v_dim, d_dim, v0, smem);
    for (int i = threadIdx.x; i < VRB * VT; i += VTHREADS) {
      const int r = i / VT, c = i % VT;
      if (row0 + r < m_rows && v0 + c < v_dim)
        y[(size_t)(row0 + r) * v_dim + v0 + c] = cs[r * VLDC + c];
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace wm

extern "C" int wm_logits(const void* x, const void* e, void* y, int m, int v,
                         int d, void* stream) {
  using namespace wm;
  if (d % VKC) return (int)cudaErrorInvalidValue;
  // Per launch: the attribute belongs to the current device's context.
  cudaFuncSetAttribute(logits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       VOCAB_SMEM);
  logits_kernel<<<(v + VT - 1) / VT, VTHREADS, VOCAB_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)e, (float*)y, m, v, d);
  return (int)cudaGetLastError();
}
