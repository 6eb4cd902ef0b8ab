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
// (the tensor cores take f32 only as TF32), on the f32 weight stream of
// ffma_stream.cuh: a persistent grid of two CTAs an SM walks the (64-entry
// vocab tile, pass of up to 64 rows) items, a producer warp keeps a TMA ring
// of E chunks and the pass's rows in flight, four consumer warps hold 4
// entries x TR rows a thread.  Each logit is one chain over D in order, so
// a row's logits do not depend on M.  Any M a launch.  Bound on H100: the
// 265 MB f32 embedding stream (79 us at 3.35 TB/s) at the drafts' M, the
// 2 M V D products at the CUDA cores' 67 TFLOP/s past M ~ 40 rows.
#include "ffma_stream.cuh"

// x (M, D), e (V, D), y (M, V), all f32; D % 32 == 0; x and e 16-byte
// aligned.
extern "C" int wm_logits_f32(const void* x, const void* e, void* y, int m, int v, int d,
                             void* stream) {
  return wm::fs_launch<false>(static_cast<const float*>(x), e,
                              wm::FsStore{static_cast<float*>(y), m, v}, m, v, d,
                              (cudaStream_t)stream);
}
