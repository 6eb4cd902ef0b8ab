// K8 — the fused log-mel frontend: reflect-padded framing, the Hann-windowed
// DFT (400 taps -> 201 frequencies) as a factored FFT, power, the mel filter
// bank at its nonzeros and log10, (B, N) f32 audio -> (B, N / 160, n_mels)
// f32.
//
// Replaces whisper_medusa_tpu/ops/mel_pallas.py::_mel_kernel (TPU, launched
// by log_mel_spectrogram_pallas), which multiplies each frame by dense
// windowed cos and sin bases split into three 160-lane blocks for Mosaic's
// tiling.  Here the DFT is factored, 400 = 20 x 20 (Cooley-Tukey, n = 20 n1
// + n2, k = k1 + 20 k2):
//
//   stage 1: for each n2, a real 20-point DFT over n1 of the windowed
//            samples x[20 n1 + n2], only its 11 non-redundant outputs
//            Y_n2[k1], k1 = 0..10 (Y_n2[20 - k1] = conj(Y_n2[k1])); taps n1
//            and 20 - n1 share a cosine, so each output costs 10 + 9 FMAs;
//   stage 2: bin k = sum over n2 = 0..19 of Y_n2[k % 20] * W^(n2 k), W =
//            exp(-2 pi i / 400): the twiddle and the 20-point DFT over n2 in
//            one 20-term complex sum, for bins 0..200 only.
//
// About 26 k real MACs a frame against the dense DFT's 161 k.  Each output is
// one thread's sum in a fixed order (n1, then n2, then a mel's bins), so a
// frame's bits do not depend on B or on where its CTA runs.  The tables
// (window, the 20 roots, the 400 twiddles, the filter bank's nonzeros) come
// from ops/mel.py::fft_mel_tables and are copied into shared memory; nothing
// streams from L2 but the audio.  Arithmetic is full f32 on the CUDA cores,
// never TF32: a frame's spectrum cancels strongly in its low-power bins.
//
// One CTA of 5 warps takes 16 frames of one example.  Each warp is two
// groups of 16 lanes, lane = frame; the 10 groups split each stage's items
// evenly: stage 1 the 20 values of n2 (2 each), stage 2 the 20 values of k1
// (2 each, 10 or 11 bins per item), the mel projection 8 mels each at 80
// (12.8 at 128), then log10(max(mel, 1e-10)) is staged and stored
// coalesced.  Within a half-warp every table index is the same, so table
// reads broadcast; frame rows are padded (samples: 2 floats per 160, the
// stage-1 outputs to 441 floats, the power to 201) so that the 16 frames of
// a half-warp hit 16 banks.  Shared memory per frame: 441 floats of stage-1
// output and 201 of power (which reuses the samples), 2.6 KB; a CTA needs
// 16 x 2.6 KB + the 2,834 staged samples + 7.6 KB of tables = 49.6 KB, so
// four CTAs fit on an SM.  Grid: ceil(frames / 16) x B = 188 CTAs at B = 1
// (3000 frames; all resident at once on the 132 SMs) and 1500 at B = 8 (2.8
// waves of 528).  The per-example max, the clamp and (x + 4) / 4 stay
// outside (ops/mel.py::normalize_log_mel), as in the JAX function.
//
// Bound on H100: bytes, 1.9 MB of audio and 0.96 MB of features per 30 s
// example at 80 mels (0.86 us at 3.35 TB/s); the FFT and the sparse filter
// bank are about 32 MFLOP an example (0.47 us at 67 TFLOP/s f32).
#include "common.cuh"

namespace wm {
namespace {

constexpr int MEL_NFFT = 400;
constexpr int MEL_HOP = 160;
constexpr int MEL_PAD = MEL_NFFT / 2;
constexpr int MEL_NF = MEL_NFFT / 2 + 1;          // 201 frequencies
constexpr int MEL_R = 20;                         // 400 = 20 x 20
constexpr int MEL_RH = MEL_R / 2 + 1;             // 11 outputs of a real 20-point DFT
constexpr int MEL_FT = 16;                        // frames per CTA (lanes of a half-warp)
constexpr int MEL_WARPS = 5;
constexpr int MEL_THREADS = 32 * MEL_WARPS;
constexpr int MEL_GROUPS = 2 * MEL_WARPS;         // 10 half-warps
constexpr int MEL_MAXMELS = 128;
constexpr int MEL_MAXNNZ = 512;                   // filter-bank nonzeros (391 at 80 mels)
constexpr int MEL_SPAN = (MEL_FT - 1) * MEL_HOP + MEL_NFFT;       // 2800 samples
// Sample i at i + 2 (i / 160): frame f starts at 162 f, so the 16 frames of
// a half-warp (same tap) fall on 16 even banks, or 16 odd ones for odd n2.
constexpr int MEL_SMP = MEL_SPAN + 2 * (MEL_SPAN / MEL_HOP);      // 2834
constexpr int MEL_POW = MEL_FT * MEL_NF;                          // 3216
constexpr int MEL_A = MEL_SMP > MEL_POW ? MEL_SMP : MEL_POW;      // samples, then power
constexpr int MEL_YP = 2 * MEL_R * MEL_RH + 1;                    // 441: a frame's Y row
constexpr int MEL_OP = MEL_MAXMELS + 1;                           // a frame's log-mel row
constexpr int MEL_B = MEL_FT * MEL_YP;                            // Y, then the log-mel rows
constexpr int MEL_TAB = MEL_NFFT + 2 * MEL_R + 2 * MEL_NFFT;      // window, roots, twiddles
constexpr int MEL_SMEM =
    (MEL_A + MEL_B + MEL_TAB + MEL_MAXNNZ) * 4 + 3 * MEL_MAXMELS * 4;   // 49,632 bytes
static_assert(MEL_FT * MEL_OP <= MEL_B, "the log-mel rows reuse the stage-1 rows");
static_assert(MEL_R * MEL_R == MEL_NFFT, "400 = 20 x 20");

__global__ void __launch_bounds__(MEL_THREADS)
log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ window,
               const float* __restrict__ dft20, const float* __restrict__ twiddle,
               const int* __restrict__ mel_span, const float* __restrict__ mel_w,
               float* __restrict__ out, int n_samples, int n_frames, int n_mels, int nnz) {
  extern __shared__ __align__(16) float sm[];
  float* smp = sm;                    // staged samples, then the power [FT][NF]
  float* ys = sm + MEL_A;             // stage-1 outputs [FT][YP], then log-mel [FT][OP]
  float* win = ys + MEL_B;            // [400]
  float* roots = win + MEL_NFFT;      // cos [20], -sin [20]
  float* tw = roots + 2 * MEL_R;      // cos [400], -sin [400]
  float* fw = tw + 2 * MEL_NFFT;      // filter-bank nonzeros
  int* span = reinterpret_cast<int*>(fw + MEL_MAXNNZ);   // [n_mels][3]
  const int tid = threadIdx.x, lane = tid & 31;
  const int group = 2 * (tid >> 5) + (lane >> 4);        // 0..9; parity = lane >> 4
  const int f = lane & 15;
  const int f0 = blockIdx.x * MEL_FT, b = blockIdx.y;
  const int nf = min(MEL_FT, n_frames - f0);
  const float* x = audio + (size_t)b * n_samples;

  // Samples i of the padded signal from f0 * HOP, reflected at both ends
  // (x[-j] = x[j], x[N - 1 + j] = x[N - 1 - j]), zero past the last frame.
  const int span_len = (nf - 1) * MEL_HOP + MEL_NFFT;
  for (int i = tid; i < MEL_SPAN; i += MEL_THREADS) {
    float v = 0.0f;
    if (i < span_len) {
      int j = f0 * MEL_HOP + i - MEL_PAD;
      if (j < 0) j = -j;
      else if (j >= n_samples) j = 2 * (n_samples - 1) - j;
      v = x[j];
    }
    smp[i + 2 * (i / MEL_HOP)] = v;
  }
  for (int i = tid; i < MEL_NFFT; i += MEL_THREADS) {
    win[i] = window[i];
    tw[i] = twiddle[i];
    tw[MEL_NFFT + i] = twiddle[MEL_NFFT + i];
  }
  if (tid < 2 * MEL_R) roots[tid] = dft20[tid];
  for (int i = tid; i < nnz; i += MEL_THREADS) fw[i] = mel_w[i];
  for (int i = tid; i < 3 * n_mels; i += MEL_THREADS) span[i] = mel_span[i];
  __syncthreads();

  // Stage 1: items n2 = group, group + 10 (the parity of n2 is the lane's
  // half, so the two halves read disjoint banks).
  float c20[MEL_R], s20[MEL_R];
#pragma unroll
  for (int m = 0; m < MEL_R; ++m) {
    c20[m] = roots[m];
    s20[m] = roots[MEL_R + m];
  }
#pragma unroll 1
  for (int it = 0; it < 2; ++it) {
    const int n2 = group + MEL_GROUPS * it;
    float s[MEL_R];
#pragma unroll
    for (int n1 = 0; n1 < MEL_R; ++n1) {
      const int i = f * MEL_HOP + MEL_R * n1 + n2;
      s[n1] = smp[i + 2 * (i / MEL_HOP)] * win[MEL_R * n1 + n2];
    }
    float* y = ys + f * MEL_YP + n2 * 2 * MEL_RH;
#pragma unroll
    for (int k1 = 0; k1 < MEL_RH; ++k1) {
      float re = s[0] + ((k1 & 1) ? -s[MEL_R / 2] : s[MEL_R / 2]);
      float im = 0.0f;
#pragma unroll
      for (int n1 = 1; n1 < MEL_R / 2; ++n1) {
        const int m = (n1 * k1) % MEL_R;
        re = fmaf(s[n1] + s[MEL_R - n1], c20[m], re);
        im = fmaf(s[n1] - s[MEL_R - n1], s20[m], im);
      }
      y[2 * k1] = re;
      y[2 * k1 + 1] = im;
    }
  }
  __syncthreads();

  // Stage 2: items k1 = group, group + 10; bins k = k1 + 20 k2 <= 200.  The
  // power overwrites the samples (all read in stage 1).
#pragma unroll 1
  for (int it = 0; it < 2; ++it) {
    const int k1 = group + MEL_GROUPS * it;
    const int kk = k1 <= MEL_R / 2 ? k1 : MEL_R - k1;
    const float sign = k1 <= MEL_R / 2 ? 1.0f : -1.0f;
    float yr[MEL_R], yi[MEL_R];
#pragma unroll
    for (int n2 = 0; n2 < MEL_R; ++n2) {
      const float* y = ys + f * MEL_YP + n2 * 2 * MEL_RH + 2 * kk;
      yr[n2] = y[0];
      yi[n2] = sign * y[1];
    }
    float* pw = smp + f * MEL_NF;
#pragma unroll 1
    for (int k = k1; k < MEL_NF; k += MEL_R) {
      float re = 0.0f, im = 0.0f;
      int m = 0;                          // (n2 * k) % 400
#pragma unroll
      for (int n2 = 0; n2 < MEL_R; ++n2) {
        const float c = tw[m], sn = tw[MEL_NFFT + m];
        re = fmaf(yr[n2], c, re);
        re = fmaf(-yi[n2], sn, re);
        im = fmaf(yr[n2], sn, im);
        im = fmaf(yi[n2], c, im);
        m += k;
        if (m >= MEL_NFFT) m -= MEL_NFFT;
      }
      pw[k] = re * re + im * im;
    }
  }
  __syncthreads();

  // Mel projection over each mel's nonzeros, in bin order; the log-mel rows
  // overwrite the stage-1 outputs (all read in stage 2).
  for (int mel = group; mel < n_mels; mel += MEL_GROUPS) {
    const int first = span[3 * mel], count = span[3 * mel + 1], off = span[3 * mel + 2];
    const float* pw = smp + f * MEL_NF + first;
    float acc = 0.0f;
    for (int i = 0; i < count; ++i) acc = fmaf(fw[off + i], pw[i], acc);
    ys[f * MEL_OP + mel] = log10f(fmaxf(acc, 1e-10f));
  }
  __syncthreads();
  float* dst = out + ((size_t)b * n_frames + f0) * n_mels;
  for (int i = tid; i < nf * n_mels; i += MEL_THREADS)
    dst[i] = ys[(i / n_mels) * MEL_OP + i % n_mels];
}

}  // namespace
}  // namespace wm

// audio (B, N) f32; window (400,), dft20 (2, 20), twiddle (2, 400) f32;
// mel_span (n_mels, 3) int32 (first bin, count, offset into mel_w); mel_w
// (nnz,) f32 (see ops/mel.py::fft_mel_tables); out (B, N / 160, n_mels) f32.
extern "C" int wm_log_mel(const void* audio, const void* window, const void* dft20,
                          const void* twiddle, const void* mel_span, const void* mel_w,
                          void* out, int b, int n_samples, int n_mels, int nnz,
                          void* stream) {
  using namespace wm;
  const int n_frames = n_samples / MEL_HOP;
  if (b < 1 || n_samples < MEL_NFFT || n_mels < 1 || n_mels > MEL_MAXMELS || nnz < 0 ||
      nnz > MEL_MAXNNZ)
    return (int)cudaErrorInvalidValue;
  // Per launch: the attribute belongs to the current device's context.
  cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       MEL_SMEM);
  const dim3 grid((n_frames + MEL_FT - 1) / MEL_FT, b);
  log_mel_kernel<<<grid, MEL_THREADS, MEL_SMEM, (cudaStream_t)stream>>>(
      static_cast<const float*>(audio), static_cast<const float*>(window),
      static_cast<const float*>(dft20), static_cast<const float*>(twiddle),
      static_cast<const int*>(mel_span), static_cast<const float*>(mel_w),
      static_cast<float*>(out), n_samples, n_frames, n_mels, nnz);
  return (int)cudaGetLastError();
}
