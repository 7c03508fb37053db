// Capacity-bucketed expert GEMM for Hopper (sm_90a): the MoE FFN hot spot.
//
// Replaces the TPU kernel repro/kernels/grouped_matmul.py:expert_matmul
// (body _gmm_kernel): out[e, c, :] = xe[e, c, :] @ w[e] for c < fill[e],
// zero for c >= fill[e]; xe [E, C, D], w [E, D, F], out [E, C, F] in xe's
// dtype, fp32 accumulation.
//
// What bounds it on the H100: the bytes of the live experts' weights (D x F
// each) at decode, where an expert holds a few tokens, and at the serving
// prefill buckets the weights plus the [E, C, F] output; the 2 * rows * D *
// F products stay below that only on the tensor cores. Both kernels share:
//  * grid (F tiles, C tiles, E); the block reads fill[e] itself: a tile
//    whose first row is past it writes zeros and returns without reading
//    w, so an expert with no token costs one pass of zeros and no weight
//    bytes; rows past fill are written as zeros here, no masking pass
//    follows;
//  * any C, D and F: the ragged edges are masked here (the TPU version
//    asserts that they tile).
// bf16 (expert_gemm_mma, the serving path):
//  * a block computes an M x 128 tile by mma.sync m16n8k16 with fp32
//    accumulators in registers: A rows from xe [C, D] through ldmatrix, B
//    from w [D, F] (F contiguous, so K-major) through ldmatrix.trans;
//  * slabs of A and w come into a four-stage shared-memory ring by 16-byte
//    cp.async (rows padded by 16 bytes: ldmatrix without bank conflicts),
//    three slabs in flight while the tensor cores work on the oldest, so
//    each SM keeps tens of KB of weights in flight: decode is pure weight
//    streaming;
//  * decode (C <= 16): M = 16, one m16 fragment, the four warps split the
//    128 columns, 64-deep slabs (16 KB of weights a stage); prefill: M =
//    64, a 2 x 2 grid of 32 x 64 warp tiles, 32-deep slabs, and a warp
//    whose rows all lie past fill skips its products;
//  * a row's sum over D runs in 16-deep mma steps in order over D in both
//    shapes: it depends on (D, F) alone, not on C, fill or the other rows,
//    and no atomics are used, so a row's result is the same in any bucket;
//  * rows that are not 16-byte aligned (D or F not a multiple of 8) take
//    an instantiation with scalar loads into the same ring.
// fp32 (expert_gemm, the first version's body): fp32 FMAs on the CUDA cores
// from 16-deep slabs widened in shared memory. The tensor cores' fp32 input
// type is TF32 (10 mantissa bits), which cannot meet the fp32 checks (2e-5
// against the plain version, 1e-4 on logits), so fp32 keeps this body; the
// serving paths run bf16.

#include "common.cuh"

using namespace rt;

namespace {

// ------------------------------------------------------------ bf16: mma
// A tile shape: kWM x kWN warps, each owning kMT m16 by kNT n8 fragments;
// kBK-deep slabs of A and w in a ring of kStagesT, in dynamic shared memory.
template <int kWM, int kWN, int kMT, int kNT, int kBK, int kStagesT>
struct MmaTile {
  static constexpr int kWarpsM = kWM, kWarpsN = kWN, kM = kMT, kN = kNT;
  static constexpr int kStages = kStagesT;
  static constexpr int BM = kWM * kMT * 16;
  static constexpr int BN = kWN * kNT * 8;
  static constexpr int BK = kBK;
  static constexpr int kThreads = kWM * kWN * 32;
  static constexpr int kAStride = BK + 8;  // bf16 per row, padded 16 bytes
  static constexpr int kBStride = BN + 8;
  static constexpr int kAStage = BM * kAStride, kBStage = BK * kBStride;
  static constexpr size_t kSmem =
      kStages * (kAStage + kBStage) * sizeof(__nv_bfloat16);
};
using DecodeTile = MmaTile<1, 4, 1, 4, 64, 4>;   // 16 x 128, 77 KB
using PrefillTile = MmaTile<2, 2, 2, 8, 32, 4>;  // 64 x 128, 55 KB
constexpr int kDecodeRows = 16;  // C <= this runs DecodeTile

template <class Tl, bool kVec>
__global__ void __launch_bounds__(Tl::kThreads)
expert_gemm_mma(const __nv_bfloat16* __restrict__ xe,
                const __nv_bfloat16* __restrict__ w,
                const int* __restrict__ fill, __nv_bfloat16* __restrict__ out,
                int C, int D, int F) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = Tl::BM, BN = Tl::BN, BK = Tl::BK;
  constexpr int kS = Tl::kStages;
  extern __shared__ float4 smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);   // kS stages of A
  bf16* Bs = As + kS * Tl::kAStage;                // then kS stages of w

  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int live = min(max(fill[e], 0), C);
  bf16* oe = out + (long long)e * C * F;

  if (r0 >= live) {  // padding tile: zeros, no weight bytes
    if (kVec) {      // F % 8 == 0: 16-byte stores
      for (int i = tid; i < BM * BN / 8; i += Tl::kThreads) {
        const int r = r0 + i / (BN / 8), n = n0 + (i % (BN / 8)) * 8;
        if (r < C && n < F)
          *reinterpret_cast<uint4*>(oe + (long long)r * F + n) =
              make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int i = tid; i < BM * BN; i += Tl::kThreads) {
        const int r = r0 + i / BN, n = n0 + i % BN;
        if (r < C && n < F) oe[(long long)r * F + n] = from_float<bf16>(0.f);
      }
    }
    return;
  }

  const bf16* xb = xe + (long long)e * C * D;
  const bf16* wb = w + (long long)e * D * F;
  // each copy pass moves one 8-element chunk a thread: A chunk ac8 / 8 of
  // rows am0, am0 + kARows, ...; w chunk bc8 / 8 of depths bk0, bk0 +
  // kBRows, ... (n: the chunk's valid elements, <= 0 for none)
  constexpr int kARows = Tl::kThreads / (BK / 8);
  constexpr int kBRows = Tl::kThreads / (BN / 8);
  const int ac8 = (tid % (BK / 8)) * 8, am0 = tid / (BK / 8);
  const int bc8 = (tid % (BN / 8)) * 8, bk0 = tid / (BN / 8);
  const int bn = F - (n0 + bc8);
  const bf16* ap = xb + (long long)(r0 + am0) * D + ac8;
  const bf16* bp = wb + (long long)bk0 * F + n0 + bc8;
  auto load = [&](int kt, int s) {
    const int k0 = kt * BK;
#pragma unroll
    for (int m = am0; m < BM; m += kARows) {
      // rows past fill: zeros, no bytes
      const int n = r0 + m < live ? D - (k0 + ac8) : 0;
      copy_chunk(As + s * Tl::kAStage + m * Tl::kAStride + ac8,
                 n > 0 ? ap + (long long)(m - am0) * D + k0 : xb, n, kVec);
    }
#pragma unroll
    for (int kk = bk0; kk < BK; kk += kBRows) {
      const int n = k0 + kk < D ? bn : 0;
      copy_chunk(Bs + s * Tl::kBStage + kk * Tl::kBStride + bc8,
                 n > 0 ? bp + (long long)(k0 + kk - bk0) * F : wb, n, kVec);
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tl::kWarpsN, wn = warp % Tl::kWarpsN;
  const int wr = wm * Tl::kM * 16;   // the warp's first row in the tile
  const int wc = wn * Tl::kN * 8;    // and first column
  const bool warp_live = r0 + wr < live;  // warp-uniform
  float acc[Tl::kM][Tl::kN][4];
#pragma unroll
  for (int i = 0; i < Tl::kM; ++i)
#pragma unroll
    for (int j = 0; j < Tl::kN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int k_tiles = (D + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int next = kt + kS - 1;  // its stage was freed at kt - 1's end
    if (next < k_tiles) load(next, next % kS);
    cp_async_commit();
    cp_async_wait<kS - 1>();       // slab kt landed
    __syncthreads();
    if (warp_live) {
      const bf16* A = As + (kt % kS) * Tl::kAStage;
      const bf16* Bt = Bs + (kt % kS) * Tl::kBStage;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[Tl::kM][4];
#pragma unroll
        for (int i = 0; i < Tl::kM; ++i)
          ldmatrix_x4(af[i], A + (wr + i * 16 + (lane & 15)) * Tl::kAStride +
                                 ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < Tl::kN / 2; ++np) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, Bt + (ks * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * Tl::kBStride +
                                    wc + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < Tl::kM; ++i) {
            mma_bf16(acc[i][2 * np], af[i], bb[0], bb[1]);
            mma_bf16(acc[i][2 * np + 1], af[i], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is free for the next copy
  }
  cp_async_wait<0>();

  // accumulator rows lane / 4 (+ 8), columns 2 * (lane % 4) (+ 1)
  const bool pairs = F % 2 == 0;  // bf16 pairs 4-byte aligned
#pragma unroll
  for (int i = 0; i < Tl::kM; ++i)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = r0 + wr + i * 16 + lane / 4 + 8 * h2;
      if (r >= C) continue;
      const bool rl = r < live;
#pragma unroll
      for (int j = 0; j < Tl::kN; ++j) {
        const int col = n0 + wc + j * 8 + (lane & 3) * 2;
        const float v0 = rl ? acc[i][j][2 * h2] : 0.f;
        const float v1 = rl ? acc[i][j][2 * h2 + 1] : 0.f;
        bf16* p = oe + (long long)r * F + col;
        if (pairs && col + 1 < F) {
          *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
        } else {
          if (col < F) p[0] = from_float<bf16>(v0);
          if (col + 1 < F) p[1] = from_float<bf16>(v1);
        }
      }
    }
}

template <class Tl>
int launch_mma(const void* xe, const void* w, const int* fill, void* out,
               int E, int C, int D, int F, cudaStream_t stream) {
  // cp.async needs 16-byte aligned row starts: bases, D and F
  const bool vec = (reinterpret_cast<uintptr_t>(xe) |
                    reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0 &&
                   D % 8 == 0 && F % 8 == 0;
  const dim3 grid((F + Tl::BN - 1) / Tl::BN, (C + Tl::BM - 1) / Tl::BM, E);
  auto kern = vec ? expert_gemm_mma<Tl, true> : expert_gemm_mma<Tl, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, Tl::kThreads, Tl::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(xe),
      static_cast<const __nv_bfloat16*>(w), fill,
      static_cast<__nv_bfloat16*>(out), C, D, F);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ fp32: FMA
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
int launch_fma(const void* xe, const void* w, const int* fill, void* out,
               int E, int C, int D, int F, cudaStream_t stream) {
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
    return C <= kDecodeRows
               ? launch_mma<DecodeTile>(xe, w, fill, out, E, C, D, F, s)
               : launch_mma<PrefillTile>(xe, w, fill, out, E, C, D, F, s);
  if (dtype == kFloat32)
    return launch_fma<float>(xe, w, fill, out, E, C, D, F, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the instantiation that expert_matmul_fwd
// launches for (dtype, C), in bytes (0: static only, or not taken).
extern "C" int expert_matmul_smem_bytes(int dtype, int C) {
  if (dtype != kBFloat16) return 0;
  return (int)(C <= kDecodeRows ? DecodeTile::kSmem : PrefillTile::kSmem);
}
