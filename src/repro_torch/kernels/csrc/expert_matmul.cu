// Capacity-bucketed expert GEMM for Hopper (sm_90a): the MoE FFN hot spot.
//
// Replaces the TPU kernel repro/kernels/grouped_matmul.py:expert_matmul
// (body _gmm_kernel): out[e, c, :] = xe[e, c, :] @ w[e] for c < fill[e],
// zero for c >= fill[e]; xe [E, C, D], w [E, D, F], out [E, C, F] in xe's
// dtype, fp32 accumulation.
//
// What bounds it on the H100: at decode (a few tokens per expert) the
// bytes of the live experts' weights; at a long prefill the 2 * rows * D *
// F products. This first version does the products as fp32 FMAs on the
// CUDA cores (67 TFLOP/s peak, not the tensor cores' 989), so a long
// prefill runs far from its bound; mma/wgmma tiles, TMA and a compact
// ragged layout in place of [E, C, D] are later work. What the design does:
//  * grid (F tiles, C tiles, E): a block computes a 64 x 128 tile of one
//    expert's output, looping over D in slabs of 16 staged in shared memory
//    as fp32 (bf16 widened on load);
//  * the block reads fill[e] itself: a tile whose first row is past it
//    writes zeros and returns without reading w, so an expert with no
//    token costs one pass of zeros and no weight bytes;
//  * each warp owns 8 rows of the tile and skips its products when all of
//    them lie past fill (at decode only the first warp computes), while
//    every warp helps stage the slabs; rows past fill are written as zeros
//    here, so no masking pass follows;
//  * each thread keeps a 4 x 8 register tile and reads its operands from
//    shared memory as float4s;
//  * any C, D and F: the ragged edges are masked here (the TPU version
//    asserts that they tile).

#include "common.cuh"

using namespace rt;

namespace {

constexpr int kBM = 64;   // rows (tokens) per tile
constexpr int kBN = 128;  // output columns per tile
constexpr int kBK = 16;   // depth per shared-memory slab
constexpr int kThreads = 256;
constexpr int kTM = 4;    // rows per thread
constexpr int kTN = 8;    // columns per thread: two float4 groups

template <typename T>
__global__ void __launch_bounds__(kThreads)
expert_gemm(const T* __restrict__ xe, const T* __restrict__ w,
            const int* __restrict__ fill, T* __restrict__ out, int C, int D,
            int F) {
  // A transposed (depth-major) and padded: the slab's stores hit 2-way
  // bank conflicts instead of 16-way, and rows stay 16-byte aligned
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int live = min(max(fill[e], 0), C);
  T* oe = out + (long long)e * C * F;

  if (r0 >= live) {  // padding tile: zeros, no weight bytes
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int r = r0 + i / kBN, n = n0 + i % kBN;
      if (r < C && n < F) oe[(long long)r * F + n] = from_float<T>(0.f);
    }
    return;
  }

  const T* xb = xe + (long long)e * C * D;
  const T* wb = w + (long long)e * D * F;
  const bool warp_live = r0 + (tid / 32) * 8 < live;  // warp-uniform
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    __syncthreads();  // the previous slab fully consumed
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int m = i / kBK, kk = i % kBK;
      const int r = r0 + m, k = k0 + kk;
      As[kk][m] = (r < live && k < D) ? to_float(xb[(long long)r * D + k])
                                      : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, n = i % kBN;
      const int k = k0 + kk, col = n0 + n;
      Bs[kk][n] = (k < D && col < F) ? to_float(wb[(long long)k * F + col])
                                     : 0.f;
    }
    __syncthreads();
    if (!warp_live) continue;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][kTM * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + 4 * tx]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += av[i] * bv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + kTM * ty + i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (col < F)
        oe[(long long)r * F + col] = from_float<T>(r < live ? acc[i][j] : 0.f);
    }
  }
}

template <typename T>
int launch(const void* xe, const void* w, const int* fill, void* out, int E,
           int C, int D, int F, cudaStream_t stream) {
  const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  expert_gemm<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xe), static_cast<const T*>(w), fill,
      static_cast<T*>(out), C, D, F);
  return (int)cudaGetLastError();
}

}  // namespace

// xe [E, C, D], w [E, D, F], out [E, C, F]: contiguous, of one dtype
// (dtype code as in common.cuh); fill [E] int32 on the device. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int expert_matmul_fwd(const void* xe, const void* w,
                                 const int* fill, void* out, int dtype, int E,
                                 int C, int D, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(xe, w, fill, out, E, C, D, F, s);
  if (dtype == kFloat32) return launch<float>(xe, w, fill, out, E, C, D, F, s);
  return (int)cudaErrorInvalidValue;
}
