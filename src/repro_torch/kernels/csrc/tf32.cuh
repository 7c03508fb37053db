// 3xTF32: fp32 products on the tensor cores to fp32 accuracy (mma.sync
// m16n8k8), shared by kernel 7 (wkv6.cu) and its backward (wkv6_bwd.cu).
//
// x = hi + lo with hi = x rounded to TF32 (10 mantissa bits) and lo = the
// remainder rounded to TF32, and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi
// (the a_lo b_lo term, ~2^-22 a b, is dropped). A bf16 value is exact in
// TF32 (lo = 0), so a product with a bf16 operand takes two MMAs. Plain
// TF32 or bf16 operands would not hold the 2e-5 that the checks ask of
// these kernels' fp32 outputs; the split does.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace rt {

// x rounded to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for every x that does not round past the largest
// float, in two integer operations, which issue faster than the
// conversion
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}
// d += a (16x8, row) * b (8x8, col), tf32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// an A fragment, split: elements (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4) of a 16 x 8 tile, as at(row, col) gives them
struct FragA {
  uint32_t hi[4], lo[4];
};
template <typename F>
__device__ __forceinline__ FragA frag_a(F at, int g, int t) {
  const float x[4] = {at(g, t), at(g + 8, t), at(g, t + 4), at(g + 8, t + 4)};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(x[i]);
    f.hi[i] = s.hi, f.lo[i] = s.lo;
  }
  return f;
}
// a B fragment: elements (t, g), (t + 4, g) of an 8 x 8 tile
struct FragB {
  uint32_t hi[2], lo[2];
};
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  return {{s0.hi, s1.hi}, {s0.lo, s1.lo}};
}
__device__ __forceinline__ FragB frag_b(__nv_bfloat16 b0, __nv_bfloat16 b1) {
  return {{uint32_t(__bfloat16_as_ushort(b0)) << 16,
           uint32_t(__bfloat16_as_ushort(b1)) << 16},
          {0u, 0u}};
}
// hi += a_hi b_hi and lo += a_lo b_hi + a_hi b_lo (exact_b / exact_a: that
// operand's lo part is zero, its MMA skipped). The small terms have their
// own accumulator, added to hi once at the end: the tensor cores' fp32
// accumulation truncates, and every MMA into the large accumulator costs
// up to one of its ulps.
template <bool exact_b, bool exact_a = false>
__device__ __forceinline__ void mma3(float (&hi)[4], float (&lo)[4],
                                     const FragA& a, const FragB& b) {
  if constexpr (!exact_a) mma_tf32(lo, a.lo, b.hi[0], b.hi[1]);
  if constexpr (!exact_b) mma_tf32(lo, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(hi, a.hi, b.hi[0], b.hi[1]);
}

}  // namespace rt
