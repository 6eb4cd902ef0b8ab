// K8 — the fused log-mel frontend: reflect-padded framing, windowed DFT
// (cos and sin, 400 taps -> 201 frequencies), power, mel projection
// (201 -> n_mels) and log10, (B, N) f32 audio -> (B, N / 160, n_mels) f32.
//
// Replaces whisper_medusa_tpu/ops/mel_pallas.py::_mel_kernel (TPU, launched
// by log_mel_spectrogram_pallas).  The TPU kernel cuts the padded waveform
// into 160-lane hop rows and splits the DFT into three partial products
// against zero-padded basis blocks aligned with pltpu.roll, all for Mosaic's
// tiling.  Here one CTA of 4 warps takes one (32-frame tile, example):
//
//   * it stages the MEL_SPAN = 31 * 160 + 400 samples its frames span in
//     shared memory, mirroring the reflect padding of the first and last 200
//     samples itself (the padded signal is never written);
//   * the windowed bases (400 x 201 f32 each, 643 KB together: too large for
//     shared memory) come zero-padded to 256 frequencies and stream from L2
//     in 16-tap slices, double-buffered with cp.async so that the next
//     slice is in flight while the CTA works on this one;
//   * warp w owns frames w, w + 4, ..., w + 28 and lane l frequencies
//     4l..4l+3 and 128+4l..128+4l+3, so four taps cost a thread 8 broadcast
//     float4 sample reads and 16 conflict-free float4 basis reads for 512
//     f32 FMAs (re and im of 8 x 8 pairs, taps summed in order 0..399): the
//     FMA pipes, not shared memory, set the pace;
//   * the power re^2 + im^2 replaces the samples in shared memory (32 x 201
//     f32), then each thread projects 8 frames x up to 4 mel bins (lane l:
//     mels l + 32 j) against the filter bank read through L1, and stores
//     log10(max(mel, 1e-10)).
//
// Arithmetic is full f32 on the CUDA cores, never TF32: a frame's DFT
// cancels strongly in its low-power bins.  The per-example max, the clamp
// and (x + 4) / 4 stay outside (ops/mel.py::normalize_log_mel), as in the JAX
// function.  Bound on H100: bytes, 2.9 MB of audio and features per 30 s
// example (0.86 us at 3.35 TB/s); log-mel by a real FFT and the sparse filter
// bank needs only about 10.5 kFLOP a frame (0.47 us an example at 67
// TFLOP/s).  The design limit is this dense O(N^2) DFT: 1.06 GFLOP an example,
// 34x the FFT's count and 16 us on the f32 CUDA cores alone, and the padding
// to 256 frequencies adds 27 % to the FMAs it issues.  At B = 1 an example's
// 94 CTAs fill 94 of the 132 SMs.
#include "common.cuh"

namespace wm {
namespace {

constexpr int MEL_NFFT = 400;
constexpr int MEL_HOP = 160;
constexpr int MEL_PAD = MEL_NFFT / 2;
constexpr int MEL_NF = MEL_NFFT / 2 + 1;     // 201 frequencies
constexpr int MEL_KP = 256;                  // frequencies padded (the bases' row)
constexpr int MEL_FT = 32;                   // frames per CTA
constexpr int MEL_WARPS = 4;
constexpr int MEL_THREADS = 32 * MEL_WARPS;
constexpr int MEL_FI = MEL_FT / MEL_WARPS;   // frames per thread: warp + 4 i
constexpr int MEL_KS = 16;                   // taps per staged basis slice
constexpr int MEL_NSL = MEL_NFFT / MEL_KS;   // 25 slices
constexpr int MEL_MJ = 4;                    // mel bins per lane: n_mels <= 128
constexpr int MEL_SPAN = (MEL_FT - 1) * MEL_HOP + MEL_NFFT;   // 5360 samples
constexpr int MEL_POW = MEL_FT * MEL_NF;                      // 6432 powers
constexpr int MEL_UNION = MEL_POW > MEL_SPAN ? MEL_POW : MEL_SPAN;
constexpr int MEL_SLICE = 2 * MEL_KS * MEL_KP;                // cos + sin floats
constexpr int MEL_SMEM = (MEL_UNION + 2 * MEL_SLICE) * 4;     // 91264 bytes
static_assert(MEL_NFFT % MEL_KS == 0 && MEL_KS % 4 == 0, "whole slices of 4-tap steps");
static_assert(MEL_UNION % 4 == 0 && MEL_HOP % 4 == 0, "16-byte aligned rows");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Issue slice s of both padded bases into dst (cos rows, then sin rows).
__device__ __forceinline__ void stage_slice(float* dst, const float* __restrict__ cos_b,
                                            const float* __restrict__ sin_b, int s) {
  constexpr int PER = MEL_KS * MEL_KP / 4;   // float4 per matrix slice
  for (int i = threadIdx.x; i < 2 * PER; i += MEL_THREADS) {
    const int m = i / PER, q = i % PER;
    const float* src = (m ? sin_b : cos_b) + (size_t)s * MEL_KS * MEL_KP + q * 4;
    cp_async16(dst + m * MEL_KS * MEL_KP + q * 4, src);
  }
}

__global__ void __launch_bounds__(MEL_THREADS, 2)
log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ cos_b,
               const float* __restrict__ sin_b, const float* __restrict__ fb,
               float* __restrict__ out, int n_samples, int n_frames, int n_mels) {
  extern __shared__ __align__(16) float sm[];
  float* smp = sm;                           // samples, later power [FT][NF]
  float* bas = sm + MEL_UNION;               // 2 buffers of [cos KS][KP], [sin KS][KP]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int f0 = blockIdx.x * MEL_FT, b = blockIdx.y;
  const int nf = min(MEL_FT, n_frames - f0);
  const float* x = audio + (size_t)b * n_samples;

  stage_slice(bas, cos_b, sin_b, 0);
  cp_async_commit();
  // smp[i] = padded[f0 * HOP + i] = x[f0 * HOP + i - PAD], reflected at both
  // ends (x[-j] = x[j], x[N - 1 + j] = x[N - 1 - j]); zero past the span.
  const int span = (nf - 1) * MEL_HOP + MEL_NFFT;
  for (int i = tid; i < MEL_SPAN; i += MEL_THREADS) {
    float v = 0.0f;
    if (i < span) {
      int j = f0 * MEL_HOP + i - MEL_PAD;
      if (j < 0) j = -j;
      else if (j >= n_samples) j = 2 * (n_samples - 1) - j;
      v = x[j];
    }
    smp[i] = v;
  }

  float re[MEL_FI][8], im[MEL_FI][8];
#pragma unroll
  for (int i = 0; i < MEL_FI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) re[i][j] = im[i][j] = 0.0f;

  const float4* smp4 = reinterpret_cast<const float4*>(smp);
  for (int s = 0; s < MEL_NSL; ++s) {
    if (s + 1 < MEL_NSL) stage_slice(bas + ((s + 1) & 1) * MEL_SLICE, cos_b, sin_b, s + 1);
    cp_async_commit();        // (an empty group after the last slice)
    cp_async_wait_one();      // slice s has landed (this thread's copies) ...
    __syncthreads();          // ... and everyone's; the samples too
    const float* bc = bas + (s & 1) * MEL_SLICE;
    const float* bs = bc + MEL_KS * MEL_KP;
    const int n0 = s * MEL_KS;
#pragma unroll 1
    for (int r4 = 0; r4 < MEL_KS; r4 += 4) {
      float4 v4[MEL_FI];
#pragma unroll
      for (int i = 0; i < MEL_FI; ++i)
        v4[i] = smp4[((warp + MEL_WARPS * i) * MEL_HOP + n0 + r4) / 4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int r = r4 + rr;
        const float4 c0 = *reinterpret_cast<const float4*>(bc + r * MEL_KP + 4 * lane);
        const float4 c1 = *reinterpret_cast<const float4*>(bc + r * MEL_KP + 128 + 4 * lane);
        const float4 s0 = *reinterpret_cast<const float4*>(bs + r * MEL_KP + 4 * lane);
        const float4 s1 = *reinterpret_cast<const float4*>(bs + r * MEL_KP + 128 + 4 * lane);
        const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int i = 0; i < MEL_FI; ++i) {
          const float v = rr == 0 ? v4[i].x : rr == 1 ? v4[i].y : rr == 2 ? v4[i].z : v4[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            re[i][j] = fmaf(v, c[j], re[i][j]);
            im[i][j] = fmaf(v, sn[j], im[i][j]);
          }
        }
      }
    }
    __syncthreads();   // this buffer is read: the next stage may refill it
  }

  // Every sample is read: the power takes their place.
#pragma unroll
  for (int i = 0; i < MEL_FI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = (j < 4 ? 0 : 128) + 4 * lane + (j & 3);
      if (k < MEL_NF)
        smp[(warp + MEL_WARPS * i) * MEL_NF + k] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
    }
  __syncthreads();

  float acc[MEL_FI][MEL_MJ];
#pragma unroll
  for (int i = 0; i < MEL_FI; ++i)
#pragma unroll
    for (int j = 0; j < MEL_MJ; ++j) acc[i][j] = 0.0f;
  for (int k = 0; k < MEL_NF; ++k) {
    float w[MEL_MJ];
#pragma unroll
    for (int j = 0; j < MEL_MJ; ++j) {
      const int m = lane + 32 * j;
      w[j] = m < n_mels ? __ldg(fb + (size_t)k * n_mels + m) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < MEL_FI; ++i) {
      const float pw = smp[(warp + MEL_WARPS * i) * MEL_NF + k];
#pragma unroll
      for (int j = 0; j < MEL_MJ; ++j) acc[i][j] = fmaf(pw, w[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < MEL_FI; ++i) {
    const int f = warp + MEL_WARPS * i;
    if (f >= nf) continue;
    float* row = out + ((size_t)b * n_frames + f0 + f) * n_mels;
#pragma unroll
    for (int j = 0; j < MEL_MJ; ++j) {
      const int m = lane + 32 * j;
      if (m < n_mels) row[m] = log10f(fmaxf(acc[i][j], 1e-10f));
    }
  }
}

}  // namespace
}  // namespace wm

// audio (B, N) f32; cos_b, sin_b (400, 256) f32 windowed DFT bases, zero
// past frequency 200; fb (201, n_mels) f32 mel filter bank; out
// (B, N / 160, n_mels) f32.
extern "C" int wm_log_mel(const void* audio, const void* cos_b, const void* sin_b,
                          const void* fb, void* out, int b, int n_samples, int n_mels,
                          void* stream) {
  using namespace wm;
  const int n_frames = n_samples / MEL_HOP;
  if (b < 1 || n_samples < MEL_NFFT || n_mels < 1 || n_mels > 32 * MEL_MJ)
    return (int)cudaErrorInvalidValue;
  // Per launch: the attribute belongs to the current device's context.
  cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       MEL_SMEM);
  const dim3 grid((n_frames + MEL_FT - 1) / MEL_FT, b);
  log_mel_kernel<<<grid, MEL_THREADS, MEL_SMEM, (cudaStream_t)stream>>>(
      static_cast<const float*>(audio), static_cast<const float*>(cos_b),
      static_cast<const float*>(sin_b), static_cast<const float*>(fb),
      static_cast<float*>(out), n_samples, n_frames, n_mels);
  return (int)cudaGetLastError();
}
