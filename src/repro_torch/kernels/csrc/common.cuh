// Helpers shared by the attention kernels: fp32 conversion of bf16/fp32
// elements, 16-byte vector loads (int8 rows too) and warp reductions.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

// The reference's mask value: a masked score is -1e30, never -inf, so a
// running max over masked scores stays finite.
constexpr float kNegInf = -1e30f;

// dtype codes of the C interface
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N contiguous elements at a 16-byte aligned address, widened to fp32.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  static_assert(N % 4 == 0, "fp32 rows load as float4");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    float4 t = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = t.x;
    out[4 * i + 1] = t.y;
    out[4 * i + 2] = t.z;
    out[4 * i + 3] = t.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  static_assert(N % 8 == 0, "bf16 rows load as 8-element uint4");
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    uint4 t = reinterpret_cast<const uint4*>(p)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      out[8 * i + 2 * j] = f.x;
      out[8 * i + 2 * j + 1] = f.y;
    }
  }
}

// int8 rows load as 16-byte int4 words, each widened to 16 floats.
template <int N>
__device__ __forceinline__ void load_vec(const int8_t* p, float* out) {
  static_assert(N % 16 == 0, "int8 rows load as 16-element int4");
#pragma unroll
  for (int i = 0; i < N / 16; ++i) {
    int4 t = reinterpret_cast<const int4*>(p)[i];
    const int8_t* c = reinterpret_cast<const int8_t*>(&t);
#pragma unroll
    for (int j = 0; j < 16; ++j) out[16 * i + j] = static_cast<float>(c[j]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace rt
