// Shared device code of the port's Hopper kernels (sm_90a): conversions,
// warp reductions, the mask constants and the epilogue codes.  The kernels'
// building blocks live beside it: the weight-streaming wgmma GEMM of K2,
// K11 and K4's stage A / wm_head_rows in wgemm.cuh, the TMA / mbarrier /
// wgmma PTX in hopper.cuh, the vocab stream of K4 and K5 in verify.cu, the
// tied-embedding stream of K3 and K7 in ntstream.cuh, and the cluster
// attention body of K2 and K10 in cluster_attn.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wm {
namespace {   // internal linkage: every .cu gets its own copy

using bf16 = __nv_bfloat16;

// Mask constants copied from the JAX package, one per site.
constexpr float NEG_SELF = -1e30f;                    // megastep.py NEG_SELF
constexpr float NEG_VERIFY = -3.4028234663852886e38f / 2.0f;  // verify.py NEG

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 f2bf(float x) { return __float2bfloat16(x); }
// Round a float to the nearest bf16 and back (the JAX ``.astype(bf16)``).
__device__ __forceinline__ float bfr(float x) { return bf2f(f2bf(x)); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// int8 -> bf16 (exact for |q| <= 127), little-endian byte order kept.
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return (float)(int8_t)(w >> (8 * i));
}
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint2 i8x4_to_bf16(uint32_t w) {
  return make_uint2(pack_bf2(i8_at(w, 0), i8_at(w, 1)), pack_bf2(i8_at(w, 2), i8_at(w, 3)));
}
__device__ __forceinline__ uint4 i8x8_to_bf16(uint2 w) {
  const uint2 lo = i8x4_to_bf16(w.x), hi = i8x4_to_bf16(w.y);
  return make_uint4(lo.x, lo.y, hi.x, hi.y);
}

// Four int8 (little-endian in w) as f32, exactly and off the I2F pipe:
// byte b ^ 0x80 = b + 128 becomes the low mantissa byte of 2^23 + (b + 128)
// (__byte_perm with the exponent bytes 0x4B00_00), and subtracting 2^23 +
// 128 leaves b (an integer of at most 8 bits: every step exact).
__device__ __forceinline__ float4 i8x4_to_f32(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float c = 8388736.0f;   // 2^23 + 128
  return make_float4(__fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)), c),
                     __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)), c),
                     __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)), c),
                     __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)), c));
}

// The epilogue of a GEMM output (wgemm.cuh), applied to acc = the f32 sum
// (times the column's scale for an int8 weight).
enum Epi : int {
  EPI_BIAS = 0,          // out = bf16(acc + b)
  EPI_BIAS_SCALE = 1,    // out = bf16(bf16(acc + b) * scale)   (q projections)
  EPI_BIAS_GELU = 2,     // out = bf16(gelu(acc + b))            (fc1)
  EPI_BIAS_RESID = 3,    // out = bf16(res + bf16(acc + b))      (o, fc2; res may be out)
  EPI_SILU_RESID = 4,    // out = bf16(res + bf16(silu(acc + b))) (Medusa res block)
};

}  // namespace
}  // namespace wm
