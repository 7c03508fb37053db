// The backward of kernel 6 (the capacity-bucketed expert GEMM) for Hopper
// (sm_90a): dX and dW of out[e, c] = xe[e, c] @ w[e] for c < fill[e], zero
// past it.
//
// Replaces no TPU kernel: the reference trains the MoE family through its
// dense path (repro/models/moe.py: moe_dense_ref, _expert_ffn) and takes
// the gradient of the einsums from jax.value_and_grad, outside any Pallas
// kernel. It was added because the port's training step runs the expert FFN
// on kernel 6 over capacity buckets of C = T rows with fill[e] live ones: a
// library batched product on the buckets would do C / fill times the
// products of the live rows (8 at top-2 of 16) and ignore fill.
//   dX: dxe[e, c] = dy[e, c] @ w[e]^T for c < fill[e], zero past it (the
//       output there is a constant); dy [E, C, Dout], w [E, Din, Dout],
//       dxe [E, C, Din];
//   dW: dw[e] = xe[e, :fill]^T @ dy[e, :fill], [E, Din, Dout]; an expert
//       with fill 0 gets zeros.
// What bounds them on the H100 at phi3.5-moe's training microbatch (T = C
// = 4096, 16 experts, top-2, ~512 live rows an expert): dX the bytes of w
// (read once) and of the whole [E, C, Din] output (dead rows written as
// zeros); dW the 2 * live * Din * Dout products on the tensor cores.
// bf16 (expert_bwd_mma, the training path): a block computes a 128 x 128
// output tile by mma.sync m16n8k16 with fp32 accumulators (4 warps, each
// 64 x 64: a fragment read from shared memory feeds 4 or 8 products),
// from slabs of A and B in a shared-memory ring filled by 16-byte
// cp.async, the next slabs in flight while the tensor cores work on the
// oldest (kernel 6's forward pipeline, csrc/expert_matmul.cu): dX 64-deep
// slabs in 3 stages, dW 32-deep in 4 (the faster of the two for each on
// the card at phi3.5-moe's training shapes; 8 warps of 32 x 64 were
// slower for both). Rows are padded by 16 bytes (ldmatrix without bank
// conflicts). The operands are read where they lie, with no transposed
// copy (one of w would move 0.84 GB a GEMM at phi3.5's width):
//  * dX: A = dy rows (the contraction Dout contiguous), B = w[e] rows
//    [Din, Dout], also Dout-contiguous, i.e. B stored n-major, so plain
//    ldmatrix gives mma's column-major B fragments; a tile whose first
//    row is at or past fill writes zeros without reading w, and a warp
//    whose rows all lie past it skips its products;
//  * dW: the contraction runs over the live rows c < fill[e] only, in row
//    order, in one block per output tile: no split over c, no atomics, so
//    two runs are bitwise equal (the trainer's restart check relies on
//    it). A = xe read M-major (Din contiguous: ldmatrix.trans), B = dy
//    read as kernel 6 reads w (ldmatrix.trans).
// Rows that are not 16-byte aligned (Din or Dout not a multiple of 8, or
// an unaligned base) take an instantiation with scalar loads into the same
// ring; ragged C, Din and Dout are masked here.
// fp32 (expert_bwd_fma, the checks' path): fp32 FMAs on the CUDA cores
// from 16-deep slabs in shared memory, as the forward's fp32 body (TF32
// cannot meet the fp32 checks).

#include <type_traits>

#include "common.cuh"

using namespace rt;

namespace {

// kWM x kWN warps, each owning kMT m16 by kNT n8 fragments; kBK-deep slabs
// in a ring of kStagesT
template <int kWM, int kWN, int kMT, int kNT, int kBK, int kStagesT>
struct Tile {
  static constexpr int kWarpsN = kWN, kM = kMT, kN = kNT;
  static constexpr int kStages = kStagesT;
  static constexpr int BM = kWM * kMT * 16;
  static constexpr int BN = kWN * kNT * 8;
  static constexpr int BK = kBK;
  static constexpr int kThreads = kWM * kWN * 32;
};
using DxTile = Tile<2, 2, 4, 8, 64, 3>;   // 128 x 128, 4 warps, 110.6 KB
using DwTile = Tile<2, 2, 4, 8, 32, 4>;   // 128 x 128, 4 warps, 69.6 KB
template <bool kDW>
using BwdTile = std::conditional_t<kDW, DwTile, DxTile>;

// shared-memory layout of one body: dX keeps A [BM][BK] and B [BN][BK]
// (the contraction contiguous), dW A [BK][BM] and B [BK][BN]; each row
// padded by 8 elements (16 bytes)
template <class Tl, bool kDW>
struct Smem {
  static constexpr int kAStride = (kDW ? Tl::BM : Tl::BK) + 8;
  static constexpr int kBStride = (kDW ? Tl::BN : Tl::BK) + 8;
  static constexpr int kAStage = (kDW ? Tl::BK : Tl::BM) * kAStride;
  static constexpr int kBStage = (kDW ? Tl::BK : Tl::BN) * kBStride;
  static constexpr size_t bytes =
      Tl::kStages * (kAStage + kBStage) * sizeof(__nv_bfloat16);
};

// dX (kDW false): out [E, C, Din], rows < fill = a [E, C, Dout] (dy) times
//   b [E, Din, Dout] (w) transposed, rows past fill zero.
// dW (kDW true): out [E, Din, Dout] = a [E, C, Din] (xe) transposed over
//   its rows < fill, times b [E, C, Dout] (dy) over the same rows.
template <class Tl, bool kDW, bool kVec>
__global__ void __launch_bounds__(Tl::kThreads)
expert_bwd_mma(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ b,
               const int* __restrict__ fill, __nv_bfloat16* __restrict__ out,
               int C, int Din, int Dout) {
  using bf16 = __nv_bfloat16;
  using L = Smem<Tl, kDW>;
  constexpr int BM = Tl::BM, BN = Tl::BN, BK = Tl::BK;
  constexpr int kS = Tl::kStages;
  extern __shared__ float4 smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + kS * L::kAStage;

  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;      // output rows: c (dX) or din (dW)
  const int n0 = blockIdx.x * BN;      // output columns: din (dX), dout (dW)
  const int rows = kDW ? Din : C, cols = kDW ? Dout : Din;
  const int tid = threadIdx.x;
  const int live = min(max(fill[e], 0), C);
  bf16* oe = out + (long long)e * rows * cols;

  if (!kDW && r0 >= live) {   // dX past fill: zeros, no bytes of w
    if (kVec) {
      for (int i = tid; i < BM * BN / 8; i += Tl::kThreads) {
        const int r = r0 + i / (BN / 8), n = n0 + (i % (BN / 8)) * 8;
        if (r < rows && n < cols)
          *reinterpret_cast<uint4*>(oe + (long long)r * cols + n) =
              make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int i = tid; i < BM * BN; i += Tl::kThreads) {
        const int r = r0 + i / BN, n = n0 + i % BN;
        if (r < rows && n < cols)
          oe[(long long)r * cols + n] = from_float<bf16>(0.f);
      }
    }
    return;
  }

  const bf16* ab = a + (long long)e * C * (kDW ? Din : Dout);
  const bf16* bb_ = b + (long long)e * (kDW ? C : Din) * Dout;
  // one 8-element chunk a thread a pass: a slab row has kAC (kBC) chunks
  constexpr int kAC = (kDW ? BM : BK) / 8, kBC = (kDW ? BN : BK) / 8;
  constexpr int kARows = Tl::kThreads / kAC, kBRows = Tl::kThreads / kBC;
  constexpr int kAPass = (kDW ? BK : BM), kBPass = (kDW ? BK : BN);
  const int ac8 = (tid % kAC) * 8, ar0 = tid / kAC;
  const int bc8 = (tid % kBC) * 8, br0 = tid / kBC;
  auto load = [&](int kt, int s) {
    const int k0 = kt * BK;
    bf16* as = As + s * L::kAStage;
    bf16* bs = Bs + s * L::kBStage;
#pragma unroll
    for (int r = ar0; r < kAPass; r += kARows) {
      int n;
      const bf16* src;
      if constexpr (kDW) {   // xe row k0 + r, columns r0 + ac8 ..
        n = k0 + r < live ? Din - (r0 + ac8) : 0;
        src = ab + (long long)(k0 + r) * Din + r0 + ac8;
      } else {               // dy row r0 + r, columns k0 + ac8 ..
        n = r0 + r < live ? Dout - (k0 + ac8) : 0;
        src = ab + (long long)(r0 + r) * Dout + k0 + ac8;
      }
      copy_chunk(as + r * L::kAStride + ac8, n > 0 ? src : ab, n, kVec);
    }
#pragma unroll
    for (int r = br0; r < kBPass; r += kBRows) {
      int n;
      const bf16* src;
      if constexpr (kDW) {   // dy row k0 + r, columns n0 + bc8 ..
        n = k0 + r < live ? Dout - (n0 + bc8) : 0;
        src = bb_ + (long long)(k0 + r) * Dout + n0 + bc8;
      } else {               // w row n0 + r, columns k0 + bc8 ..
        n = n0 + r < Din ? Dout - (k0 + bc8) : 0;
        src = bb_ + (long long)(n0 + r) * Dout + k0 + bc8;
      }
      copy_chunk(bs + r * L::kBStride + bc8, n > 0 ? src : bb_, n, kVec);
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tl::kWarpsN, wn = warp % Tl::kWarpsN;
  const int wr = wm * Tl::kM * 16;   // the warp's first row in the tile
  const int wc = wn * Tl::kN * 8;    // and first column
  const int j8 = lane >> 3;          // the 8x8 matrix this lane addresses
  const bool warp_live = kDW || r0 + wr < live;   // warp-uniform
  float acc[Tl::kM][Tl::kN][4];
#pragma unroll
  for (int i = 0; i < Tl::kM; ++i)
#pragma unroll
    for (int j = 0; j < Tl::kN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int k_tiles = ((kDW ? live : Dout) + BK - 1) / BK;
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
      const bf16* A = As + (kt % kS) * L::kAStage;
      const bf16* Bt = Bs + (kt % kS) * L::kBStage;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[Tl::kM][4];
#pragma unroll
        for (int i = 0; i < Tl::kM; ++i) {
          // dW's A is [k][m]: lane group j8 addresses m block j8 & 1, k
          // block j8 >> 1
          if constexpr (kDW)
            ldmatrix_x4_trans(af[i], A + (ks * 16 + (j8 >> 1) * 8 +
                                          (lane & 7)) * L::kAStride +
                                         wr + i * 16 + (j8 & 1) * 8);
          else
            ldmatrix_x4(af[i], A + (wr + i * 16 + (lane & 15)) * L::kAStride +
                                   ks * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int np = 0; np < Tl::kN / 2; ++np) {
          uint32_t bf[4];
          // dW's B is [k][n], read as kernel 6 reads w; dX's is [n][k]:
          // lane group j8 addresses n block j8 >> 1, k block j8 & 1
          if constexpr (kDW)
            ldmatrix_x4_trans(bf, Bt + (ks * 16 + (lane & 7) +
                                        (j8 & 1) * 8) * L::kBStride +
                                      wc + np * 16 + (j8 >> 1) * 8);
          else
            ldmatrix_x4(bf, Bt + (wc + np * 16 + (j8 >> 1) * 8 + (lane & 7)) *
                                     L::kBStride + ks * 16 + (j8 & 1) * 8);
#pragma unroll
          for (int i = 0; i < Tl::kM; ++i) {
            mma_bf16(acc[i][2 * np], af[i], bf[0], bf[1]);
            mma_bf16(acc[i][2 * np + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is free for the next copy
  }
  cp_async_wait<0>();

  // accumulator rows lane / 4 (+ 8), columns 2 * (lane % 4) (+ 1)
  const bool pairs = cols % 2 == 0;  // bf16 pairs 4-byte aligned
#pragma unroll
  for (int i = 0; i < Tl::kM; ++i)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = r0 + wr + i * 16 + lane / 4 + 8 * h2;
      if (r >= rows) continue;
      const bool rl = kDW || r < live;
#pragma unroll
      for (int j = 0; j < Tl::kN; ++j) {
        const int col = n0 + wc + j * 8 + (lane & 3) * 2;
        const float v0 = rl ? acc[i][j][2 * h2] : 0.f;
        const float v1 = rl ? acc[i][j][2 * h2 + 1] : 0.f;
        bf16* p = oe + (long long)r * cols + col;
        if (pairs && col + 1 < cols) {
          *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
        } else {
          if (col < cols) p[0] = from_float<bf16>(v0);
          if (col + 1 < cols) p[1] = from_float<bf16>(v1);
        }
      }
    }
}

template <bool kDW>
int launch_mma(const void* a, const void* b, const int* fill, void* out,
               int E, int C, int Din, int Dout, cudaStream_t stream) {
  using Tl = BwdTile<kDW>;
  // cp.async needs 16-byte aligned row starts: bases, Din and Dout
  const bool vec = (reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0 &&
                   Din % 8 == 0 && Dout % 8 == 0;
  const int rows = kDW ? Din : C, cols = kDW ? Dout : Din;
  const dim3 grid((cols + Tl::BN - 1) / Tl::BN, (rows + Tl::BM - 1) / Tl::BM,
                  E);
  auto kern = vec ? expert_bwd_mma<Tl, kDW, true>
                  : expert_bwd_mma<Tl, kDW, false>;
  const size_t smem = Smem<Tl, kDW>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, Tl::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), fill,
      static_cast<__nv_bfloat16*>(out), C, Din, Dout);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ fp32: FMA
constexpr int kBM = 64;   // output rows per tile
constexpr int kBN = 128;  // output columns per tile
constexpr int kBK = 16;   // depth per shared-memory slab
constexpr int kThreads = 256;
constexpr int kTM = 4;    // rows per thread
constexpr int kTN = 8;    // columns per thread: two float4 groups

// the same two functions as expert_bwd_mma, fp32 operands and output
template <bool kDW>
__global__ void __launch_bounds__(kThreads)
expert_bwd_fma(const float* __restrict__ a, const float* __restrict__ b,
               const int* __restrict__ fill, float* __restrict__ out, int C,
               int Din, int Dout) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int rows = kDW ? Din : C, cols = kDW ? Dout : Din;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int live = min(max(fill[e], 0), C);
  float* oe = out + (long long)e * rows * cols;

  if (!kDW && r0 >= live) {   // dX past fill: zeros, no bytes of w
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int r = r0 + i / kBN, n = n0 + i % kBN;
      if (r < rows && n < cols) oe[(long long)r * cols + n] = 0.f;
    }
    return;
  }

  const float* ab = a + (long long)e * C * (kDW ? Din : Dout);
  const float* bb = b + (long long)e * (kDW ? C : Din) * Dout;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int K = kDW ? live : Dout;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous slab fully consumed
    if constexpr (kDW) {
      // xe rows k (live only), columns m; dy rows k, columns n
      for (int i = tid; i < kBK * kBM; i += kThreads) {
        const int kk = i / kBM, m = i % kBM, k = k0 + kk;
        As[kk][m] = k < live && r0 + m < Din
                        ? ab[(long long)k * Din + r0 + m] : 0.f;
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int kk = i / kBN, n = i % kBN, k = k0 + kk;
        Bs[kk][n] = k < live && n0 + n < Dout
                        ? bb[(long long)k * Dout + n0 + n] : 0.f;
      }
    } else {
      // dy rows m (live only), columns k; w rows n, columns k
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int m = i / kBK, kk = i % kBK, k = k0 + kk;
        As[kk][m] = r0 + m < live && k < Dout
                        ? ab[(long long)(r0 + m) * Dout + k] : 0.f;
      }
      for (int i = tid; i < kBN * kBK; i += kThreads) {
        const int n = i / kBK, kk = i % kBK, k = k0 + kk;
        Bs[kk][n] = n0 + n < Din && k < Dout
                        ? bb[(long long)(n0 + n) * Dout + k] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][kTM * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + 4 * tx]);
      const float x[kTM] = {av.x, av.y, av.z, av.w};
      const float y[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += x[i] * y[j];
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + kTM * ty + i;
    if (r >= rows) continue;
    const bool rl = kDW || r < live;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (col < cols) oe[(long long)r * cols + col] = rl ? acc[i][j] : 0.f;
    }
  }
}

template <bool kDW>
int launch_fma(const void* a, const void* b, const int* fill, void* out,
               int E, int C, int Din, int Dout, cudaStream_t stream) {
  const int rows = kDW ? Din : C, cols = kDW ? Dout : Din;
  const dim3 grid((cols + kBN - 1) / kBN, (rows + kBM - 1) / kBM, E);
  expert_bwd_fma<kDW><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), fill,
      static_cast<float*>(out), C, Din, Dout);
  return (int)cudaGetLastError();
}

template <bool kDW>
int launch(const void* a, const void* b, const int* fill, void* out,
           int dtype, int E, int C, int Din, int Dout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_mma<kDW>(a, b, fill, out, E, C, Din, Dout, s);
  if (dtype == kFloat32)
    return launch_fma<kDW>(a, b, fill, out, E, C, Din, Dout, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Contiguous tensors of one dtype (dtype code as in common.cuh); fill [E]
// int32 on the device. Each returns the cudaError_t of its launch (0 on
// success).

// dX: dxe [E, C, Din] from dy [E, C, Dout] and w [E, Din, Dout]; rows at or
// past fill[e] are zero.
extern "C" int expert_matmul_bwd_dx(const void* dy, const void* w,
                                    const int* fill, void* dxe, int dtype,
                                    int E, int C, int Din, int Dout,
                                    void* stream) {
  return launch<false>(dy, w, fill, dxe, dtype, E, C, Din, Dout, stream);
}

// dW: dw [E, Din, Dout] from xe [E, C, Din] and dy [E, C, Dout] over the
// rows below fill[e].
extern "C" int expert_matmul_bwd_dw(const void* xe, const void* dy,
                                    const int* fill, void* dw, int dtype,
                                    int E, int C, int Din, int Dout,
                                    void* stream) {
  return launch<true>(xe, dy, fill, dw, dtype, E, C, Din, Dout, stream);
}

// Dynamic shared memory of the bf16 launch of dX (dw 0) or dW (dw 1), in
// bytes (0 for fp32: static only).
extern "C" int expert_matmul_bwd_smem_bytes(int dtype, int dw) {
  if (dtype != kBFloat16) return 0;
  return (int)(dw ? Smem<DwTile, true>::bytes : Smem<DxTile, false>::bytes);
}
