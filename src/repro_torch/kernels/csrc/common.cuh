// Helpers shared by the kernels: fp32 conversion of bf16/fp32 elements,
// 16-byte vector loads (int8 rows too), warp reductions, and the inline-PTX
// pieces of the tensor-core kernels (cp.async, ldmatrix, mma.sync).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

// The reference's mask value: a masked score is -1e30, never -inf, so a
// running max over masked scores stays finite.
constexpr float kNegInf = -1e30f;

// The log-sum-exp that kernel 1 saves for a row with nothing visible:
// finite, and large enough that exp(s - kLseEmpty) is 0 for any score.
// The backward masks such a row's every key, so it gets zero gradients.
constexpr float kLseEmpty = 1e30f;

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

// ------------------------------------------------------------------------
// Tensor-core and asynchronous-copy building blocks (inline PTX, sm_80+):
// 16-byte cp.async copies into shared memory, ldmatrix fragment loads and
// the bf16 m16n8k16 MMA with fp32 accumulation.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until the group is waited for;
// valid == false reads nothing and zero-fills the 16 bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (cp.async.ca: the .cg form takes only 16-byte
// copies); valid == false reads nothing and zero-fills them
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 8-element bf16 chunk of a row into shared memory: n valid elements
// (<= 0: none), the rest zero. vec: the row starts are 16-byte aligned and
// a chunk is whole or empty, so one cp.async moves it; otherwise scalar
// loads, stored at once (the caller's barrier publishes both kinds).
__device__ __forceinline__ void copy_chunk(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int n,
                                           bool vec) {
  if (vec) {
    cp_async16(dst, src, n > 0);
    return;
  }
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
  union {
    uint4 v;
    uint16_t h[8];
  } t;
#pragma unroll
  for (int i = 0; i < 8; ++i) t.h[i] = i < n ? s[i] : uint16_t(0);
  *reinterpret_cast<uint4*>(dst) = t.v;
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// the same, each matrix transposed: B fragments from a K-major tile
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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
