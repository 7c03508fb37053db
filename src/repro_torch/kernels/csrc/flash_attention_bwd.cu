// The backward of kernel 1 (causal / prefix / non-causal GQA attention) for
// Hopper (sm_90a): dQ, dK and dV from the forward's saved log-sum-exp.
//
// Replaces no TPU kernel: the reference trains through XLA attention
// (repro/models/layers.py: multihead_attention, flash_attention_xla) and
// takes its gradient from jax.value_and_grad, outside any Pallas kernel.
// It was added because the port's training step attends through kernel 1
// (flash_attention.cu), which keeps no S x S matrix, so its gradient must
// not build one either. With s = q . k / sqrt(hd), P = exp(s - LSE) on the
// visible keys (j <= i or j < prefix_len under the causal mask, every key
// without it) and 0 elsewhere, D = rowsum(dO o O):
//   dV = P^T dO,  dS = P o (dO V^T - D),  dQ = dS K / sqrt(hd),
//   dK = dS^T Q / sqrt(hd), summed over the G query heads of a KV head.
// Three kernels, FlashAttention-2's split:
//  (a) bwd_dot: D[b, h, i] = sum_d dO . O in fp32: a block takes P
//      positions of one b and every head, whose rows lie contiguous in o
//      and dO, and reads them as 16-byte vectors, 4 of each tensor in
//      flight a thread (32 KB a block; one warp a row with 2-byte loads,
//      its first design, kept 256 bytes in flight a warp). P (4 to 16)
//      is as many positions as one such round of loads covers, so a
//      block waits for memory about once; the hd / 8 (bf16) lanes of a
//      row reduce by shuffles into shared memory at [position][head], and
//      the block writes D transposed, P consecutive i of each head at a
//      time (one lane a row wrote one float Sq floats from its
//      neighbour's);
//  (b) bwd_dkdv: a tile of keys of one (b, kvh) at a time. It loops over
//      the G query heads and, for each, over the query tiles from the key
//      tile's causal start (tile 0 where the key tile lies in the prefix,
//      or without the mask), recomputing S^T = K Q^T and P^T from the LSE
//      and dP^T = V dO^T, and keeps dK and dV in fp32 registers, written
//      once: the sum over G needs no atomics;
//  (c) bwd_dq: a tile of query rows of one (b, h) at a time: the key loop
//      stops at the causal diagonal of the tile's last query, or at the
//      prefix; dQ in fp32 registers, written once (a dQ summed across
//      (b)'s key tiles would need float atomics, so (c) recomputes S and
//      dP: 7 products in all, not 5).
// No float atomics anywhere: two runs on the same inputs are bitwise equal.
// A masked key gets P = 0 exactly by the predicate, never through
// exp(-1e30 - LSE), so the LSE sentinel of a row with nothing visible
// (kLseEmpty) gives zero gradients.
// What bounds it on the H100: at llama3.2-1b's training shape (B 2, 4096
// tokens, 32 heads over 8, hd 64, causal) the 7 Sq * Sk * hd products of
// (b) and (c) on the tensor cores (989 TFLOP/s in bf16 only through
// wgmma); (a) is bound by the bytes of dO and O.
// bf16 (the training path), both (b) and (c): one persistent block an SM
// of three warpgroups. Warpgroups 0 and 1 compute on wgmma m64n64k16
// (fp32 accumulators in registers; m64n32k16 for hd 128's S and dP, see
// below), 64 keys (b) or 64 query rows (c) each; warpgroup 2 drops to 40
// registers (setmaxnreg) so the two take
// 232, and its first warp produces with TMA under mbarriers: a 2-slot
// ring of the tiles a block keeps for one output tile (K and V of 128
// keys in (b), Q and dO of 128 rows of one head in (c)), so the next
// tile's loads overlap this one's steps, and a 4-slot ring of the tiles
// it streams (64 queries of Q, dO, LSE and D in (b); 64 keys of K and V
// in (c)); the 32 lanes copy (b)'s LSE and D rows by cp.async, arriving
// on the same barrier, since a ragged Sq breaks TMA's 16-byte stride rule
// for them. No thread that computes issues a copy. In (b), each warp
// takes its 16 keys of K and V from the 128-byte swizzled tile into A
// fragments once a tile (ldmatrix), and S^T = K Q^T and dP^T = V dO^T
// read only the Q and dO tiles (B) from shared memory: at N = 64 a
// product with both operands in shared memory moves 4 KB in its 32
// tensor-core clocks, all of shared memory's 128 bytes a clock, and
// register A halves that (faster on the card than K and V as shared-memory
// descriptors).
// P^T and dS^T go from those accumulators straight into bf16 A fragments
// (the accumulator layout is the A layout) for dV += P^T dO and dK +=
// dS^T Q, where dO and Q are B read MN-major through the descriptor's
// transpose bit. In (c) likewise Q and dO are register A for S = Q K^T
// and dP = dO V^T, then dQ += dS K with K as an MN-major B. Within a step
// (b)'s LSE and D come from shared memory while S^T and dP^T run, and the
// exponentials of P overlap the dP product (wgmma.wait_group 1).
// Tried and dropped (each slower on the card): issuing the next step's
// S and dP before the last dV/dK retire, and the FlashAttention-3
// ping-pong of the two warpgroups over named barriers (ptxas then
// serialises the wgmma for want of registers).
// Work order: the causal mask gives key tile n of (b) Sq / 64 - 2n query
// tiles and query tile m of (c) 2 (m + 1) key tiles, so an item pairs
// tile p with tile n - 1 - p of one (b, head) row: every item holds the
// same work, and block x takes items x, x + gridDim.x, ... (256 items
// for (b) and 1024 for (c) on 132 SMs at the training shape). A tile that
// a warpgroup sees in no part is skipped; one it sees only in part (the
// diagonal, the prefix's edge, ragged Sq and Sk) takes the masked
// instantiation of the step; TMA reads rows past Sq or Sk as zeros. The
// launcher encodes the four TMA maps (cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint: no -lcuda, no change of build flags)
// once a call, passed as __grid_constant__ parameters. No library kernel
// (no cuBLAS, cuDNN or CUTLASS GEMM): the PTX is in hopper.cuh.
// hd 128: a position is two 128-byte swizzle rows, so each tile is two
// TMA boxes of 64 columns (rows x 128 bytes apart), a k-step past column
// 64 moves to the second box, and load_a_sw128 reads 8 k-steps; dK, dV
// and dQ are two 64-column accumulators each, one wgmma m64n64k16 a box.
// At hd 64's layout a consumer thread of (b) would hold dK and dV 64 + 64
// fp32, K and V fragments 32 + 32, S^T and dP^T 32 + 32, P^T and dS^T 16
// + 16 = 288 registers, over 232, and its shared memory would be 258 KB,
// over 227. So the streamed tile shrinks to 32 queries (b) or 32 keys (c)
// and S (S^T) and dP (dP^T) run on wgmma m64n32k16: 16 + 16 registers,
// P^T and dS^T 8 + 8; in (b) K and V stay in shared memory as A
// descriptors (both operands in shared memory: 3 KB a k-step in 16
// tensor-core clocks, over shared memory's 128 bytes a clock, but the
// registers of K and V do not fit beside dK and dV); (c) keeps Q and dO
// as register A (dQ 64 + 32 + 32 + 16 + 16 + 8 = 168). Shared memory,
// both: 2 outer slots of 2 x 32 KB and 4 inner slots of 2 x 8 KB (193 KB
// with (b)'s LSE and D rows).
// hd 112 (zamba2's shared attention) takes hd 128's layout, as kernel 1's
// forward does: a row of 112 is not a whole number of 64-column boxes, so
// the tensor maps are encoded at the tensor's own inner extent (112, a
// 224-byte position stride) and the second box of each tile reads columns
// 112 .. 127 as zeros. S and dP run 7 k-steps (the 8th would add zeros),
// dK, dV and dQ the two 64-column accumulators, whose last 16 columns are
// products with those zeros and are never stored. Expect about 128 / 112
// of the tensor-core work of the width; (a) lays a row of 14 (bf16) or 28
// (fp32) vectors over 16 or 32 lanes.
// hd 256 (paligemma-3b: 8 query heads over one KV head) passes both budgets of
// hd 128's layout: a consumer thread of (b) would hold dK and dV for its 64
// keys in 2 x 64 x 256 / 128 = 256 fp32 registers (232 after setmaxnreg), and
// 2 outer slots of K and V at 128 keys take 256 KB (227 KB a block). So (b)
// gives the two warpgroups one 64-key tile and a half of the work each
// (kSplit, a kernel of its own, bwd_dkdv_split): warpgroup 0 computes S^T = K
// Q^T, P^T, and dV += P^T dO; warpgroup 1 computes dP^T = V dO^T and, with P^T
// read from a 64 x 32 fp32 exchange buffer in shared memory (two of them, one
// named barrier a step), dS^T and dK += dS^T Q. Each keeps 128 accumulators,
// 16 of S^T or dP^T, 8 of bf16 A fragments. K and V stay in shared memory as A
// descriptors (one outer slot of 2 x 32 KB), Q and dO stream as 32-query tiles
// (a ring of 4 slots of 32 KB), four 64-column TMA boxes a position: 215,120 B
// in all. (c) keeps 128 rows a block but reads Q and dO through shared-memory
// A descriptors (kQoSmem: as fragments they would add 64 + 64 registers to
// dQ's 128), in one outer slot of 128 KB, beside a ring of 3 slots of K and V
// at 32 keys: 231,232 B (its 128 accumulators of dQ, 16 + 16 of S and dP and
// the descriptors pass 232 registers by a few: ptxas spills some 128 bytes,
// which phase 2 of chip_smoke.py prints). Each warpgroup of (b) does half the
// products of a step, so one (b, KV head) gives a block only ceil(Sk / 64)
// items (48 at B 4 x 768); they are not paired (a 256-position prefix makes
// the pairs unequal: 256 steps the longest pair against 192 the longest tile
// at Sq 768).
// fp32 (the checks' path): FMAs on the CUDA cores, tiles of 32 keys and 32
// rows in shared memory (the tensor cores' fp32 input type is TF32, too
// coarse for the fp32 checks), as kernel 1's fp32 body. At hd 256 (a)
// lays an fp32 row of 64 vectors over 32 lanes, two a lane (DotCfg).
// Inputs and outputs are contiguous: q, o, dO, dq [B, Sq, H, hd], k, v,
// dk, dv [B, Sk, KVH, hd]; lse and D [B, H, Sq] fp32. Head dims: HD 64,
// 112, 128 and 256 (BWD_WIDTHS below).

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

using namespace rt;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ long long row_off(int b, int S, int i, int heads,
                                             int h, int hd) {
  return (((long long)b * S + i) * heads + h) * hd;
}

// ------------------------------------------------------------ (a) D
constexpr int kDotThreads = 256;
constexpr int kDotUnroll = 4;     // 16-byte vectors of each tensor in flight

// sum of the products of two 16-byte vectors of T, in fp32
__device__ __forceinline__ float dot16(uint4 a, uint4 b, float) {
  return __uint_as_float(a.x) * __uint_as_float(b.x) +
         __uint_as_float(a.y) * __uint_as_float(b.y) +
         __uint_as_float(a.z) * __uint_as_float(b.z) +
         __uint_as_float(a.w) * __uint_as_float(b.w);
}
__device__ __forceinline__ float dot16(uint4 a, uint4 b, __nv_bfloat16) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 u = __bfloat1622float2(x[j]), v = __bfloat1622float2(y[j]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}

// the lanes a row of `vecs` 16-byte vectors takes: the next power of two,
// so that a row's lanes lie aligned within a warp
__host__ __device__ constexpr int row_lanes(int vecs) {
  return vecs <= 1 ? 1 : 2 * row_lanes((vecs + 1) / 2);
}

// How (a) lays a row of HD elements of T over lanes: kV 16-byte vectors,
// kPer consecutive ones a lane (2 for an fp32 row of 256, 64 vectors, so
// that a row stays within a warp; else 1), over kL lanes (kC of them
// read), kU rounds of loads in flight a thread
template <typename T, int HD>
struct DotCfg {
  static constexpr int kV = HD * sizeof(T) / 16;
  static constexpr int kPer = (kV + 31) / 32;
  static constexpr int kC = kV / kPer;
  static constexpr int kL = row_lanes(kC);
  static constexpr int kU = kDotUnroll / kPer;
  static_assert(HD * sizeof(T) % 16 == 0 && kV % kPer == 0 && kL <= 32 &&
                    kU >= 1,
                "a row of whole vectors, its lanes within a warp");
};

// D[b, h, i] for P positions of one b and all H heads: their rows
// (position-major, head-minor) lie contiguous in o and dO. Lane v of the
// block's run belongs to row v / kL and reads that row's vectors kPer (v %
// kL) ..; the row's kL lanes (aligned within a warp; hd 112 leaves the
// last 2 of 16 lanes idle in bf16 and 4 of 32 in fp32) reduce by
// shuffles. Sums go to shared memory at [position][head] (rows padded by
// one float) and out transposed.
template <typename T, int HD>
__global__ void __launch_bounds__(kDotThreads)
bwd_dot(const T* __restrict__ o, const T* __restrict__ dO,
        float* __restrict__ D, int Sq, int H, int P, int tiles) {
  using C = DotCfg<T, HD>;
  constexpr int kV = C::kV, kPer = C::kPer, kL = C::kL, kU = C::kU;
  extern __shared__ float sums[];           // [P][H + 1]
  const int b = blockIdx.x / tiles, i0 = (blockIdx.x % tiles) * P;
  const int n_pos = min(P, Sq - i0);
  const int nlane = n_pos * H * kL;
  const long long at = ((long long)b * Sq + i0) * H * HD;
  const uint4* ov = reinterpret_cast<const uint4*>(o + at);
  const uint4* dv = reinterpret_cast<const uint4*>(dO + at);
  const int tid = threadIdx.x;
  for (int v0 = 0; v0 < nlane; v0 += kDotThreads * kU) {
    uint4 x[kU][kPer], y[kU][kPer];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int v = v0 + u * kDotThreads + tid, c = v % kL;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        x[u][e] = y[u][e] = make_uint4(0, 0, 0, 0);
        if (v < nlane && c < C::kC) {
          x[u][e] = ov[v / kL * kV + c * kPer + e];
          y[u][e] = dv[v / kL * kV + c * kPer + e];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float s = dot16(x[u][0], y[u][0], T());
#pragma unroll
      for (int e = 1; e < kPer; ++e) s += dot16(x[u][e], y[u][e], T());
#pragma unroll
      for (int off = kL / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int v = v0 + u * kDotThreads + tid;
      if (v < nlane && tid % kL == 0) {
        const int r = v / kL;               // position r / H, head r % H
        sums[(r / H) * (H + 1) + r % H] = s;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < H * P; idx += kDotThreads) {
    const int h = idx / P, il = idx % P;
    if (il < n_pos)
      D[((long long)b * H + h) * Sq + i0 + il] = sums[il * (H + 1) + h];
  }
}

// ------------------------------------------------------------ bf16: wgmma
// One persistent block an SM, three warpgroups: warpgroups 0 and 1 compute
// on wgmma, 64 keys (b) or 64 rows (c) each; warpgroup 2 gives up its
// registers (setmaxnreg) and its first warp produces. Two rings of tiles
// under mbarriers, filled by TMA (128-byte swizzled rows of 64 bf16): an
// outer ring of kOuterSlots slots for the tiles a block keeps while it
// works on one output tile (K and V of kOuter keys in (b), Q and dO of 128
// rows in (c)), loaded by one lane, and an inner ring of kStages slots for
// the tiles it streams (kInner queries of Q and dO in (b), with their LSE
// and D copied by the warp's 32 lanes by cp.async; kInner keys of K and V
// in (c)), read by wgmma through shared-memory descriptors. A consumer
// thread releases an inner slot once its warpgroup's last wgmma on it has
// completed, an outer slot at the end of its tile.
// HD is the tensor's width; the layout's, kHD, is the next multiple of 64
// (hd 112 takes hd 128's: see the header). kDq: the layout of (c), else
// (b)'s; they differ only at hd 256.
template <int HD, bool kDq>
struct Wg {
  static_assert(HD == 64 || HD == 112 || HD == 128 || HD == 256,
                "a position is 1, 2 or 4 swizzle rows");
  static constexpr int kHD = (HD + 63) / 64 * 64;
  static constexpr bool kWide = kHD == 256;
  static constexpr int kThreads = 3 * 128;
  static constexpr int kConsumers = 2 * 128;
  // hd 256: one outer slot ((c)'s Q and dO of 128 rows take 128 KB); the
  // inner ring 4 deep in (b), 3 in (c)
  static constexpr int kOuterSlots = kWide ? 1 : 2;
  static constexpr int kStages = kWide && kDq ? 3 : 4;
  // keys (b) or rows (c) a block: (b) at hd 256 takes 64, which both
  // warpgroups share (kSplit)
  static constexpr int kOuter = kWide && !kDq ? 64 : 128;
  // queries (b) or keys (c) a streamed tile, and the N of S and dP
  static constexpr int kInner = kHD == 64 ? 64 : 32;
  static constexpr int kBoxes = kHD / 64;   // 64-column TMA boxes a tile
  // (b): K and V as A fragments in registers (hd 64), or read by wgmma
  // from shared memory (hd 112, 128, 256)
  static constexpr bool kKvSmem = kHD > 64;
  // (b) at hd 256: warpgroup 0 forms P^T and accumulates dV, warpgroup 1
  // dP^T and dK, over the same 64 keys, P^T passed through shared memory;
  // each key tile an item of its own (no pairing: see the header)
  static constexpr bool kSplit = kWide && !kDq;
  // (c) at hd 256: Q and dO read by wgmma from shared memory, not held as
  // A fragments
  static constexpr bool kQoSmem = kWide && kDq;
  // TMA maps of a width the boxes do not tile need only 16-byte strides
  static constexpr int kHdMultiple = kHD == HD ? 64 : 8;
  static constexpr int kRow = kHD * 2;  // bytes
  static constexpr int kOuterTile = kOuter * kRow;   // one tensor's tile
  static constexpr int kInnerTile = kInner * kRow;
  // a tile's box x (columns 64 x ..) lies x boxes of rows x 128 bytes on
  static constexpr int kOuterBox = kOuter * 128, kInnerBox = kInner * 128;
  // byte offsets from the 1024-byte aligned base: kOuterSlots outer slots
  // of two tiles, kStages inner slots of two tiles, kStages (LSE, D) rows
  // of kInner floats ((b) only), kSplit's two P^T buffers of 64 x kInner
  // floats, the barriers
  static constexpr int kInnerAt = kOuterSlots * 2 * kOuterTile;
  static constexpr int kStatsAt = kInnerAt + kStages * 2 * kInnerTile;
  static constexpr int kXchAt = kStatsAt + kStages * 2 * kInner * 4;
  static constexpr int kBarsAt = kXchAt + (kSplit ? 2 * 64 * kInner * 4 : 0);
  static constexpr int kBars = 2 * kStages + 2 * kOuterSlots;
  static constexpr size_t bytes = 1024 + kBarsAt + kBars * 8;
  static_assert(bytes <= 232448, "227 KB of shared memory a block");

  __device__ static uint8_t* outer(uint8_t* sm, int slot) {
    return sm + slot * 2 * kOuterTile;
  }
  __device__ static uint8_t* inner(uint8_t* sm, int st) {
    return sm + kInnerAt + st * 2 * kInnerTile;
  }
  __device__ static float* stats(uint8_t* sm, int st) {
    return reinterpret_cast<float*>(sm + kStatsAt) + st * 2 * kInner;
  }
  __device__ static float* xch(uint8_t* sm, int buf) {
    return reinterpret_cast<float*>(sm + kXchAt) + buf * 64 * kInner;
  }
};

// a ring's slot and the parity of its current round
struct Ring {
  int st = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next(int n) {
    if (++st == n) {
      st = 0;
      ph ^= 1;
    }
  }
};

// full[kStages], empty[kStages], outer full[kOuterSlots], outer
// empty[kOuterSlots]: an inner slot is full after `full_count` arrivals
// and its bytes, empty after every consumer thread's arrival; an outer
// slot likewise with one arrival
template <class L>
__device__ __forceinline__ uint64_t* init_bars(uint8_t* sm,
                                               uint32_t full_count) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBarsAt);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bars + s, full_count);
      mbar_init(bars + L::kStages + s, L::kConsumers);
    }
    for (int s = 0; s < L::kOuterSlots; ++s) {
      mbar_init(bars + 2 * L::kStages + s, 1);
      mbar_init(bars + 2 * L::kStages + L::kOuterSlots + s, L::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return bars;
}

// The work order, both kernels: item `it` pairs outer tile p with tile
// n - 1 - p (one tile where the two meet) of one (b, head) row, so under
// the causal mask every item holds the same work (the long tile of one
// end with the short of the other); block x takes items x, x + gridDim.x,
// ... The two tiles of item p: tile_of(p, n, 0) and tile_of(p, n, 1), < 0
// where there is no second one. (hd 256's dK/dV, bwd_dkdv_split, takes
// one tile an item.)
__device__ __forceinline__ int tile_of(int p, int n, int half) {
  const int t = half ? n - 1 - p : p;
  return half && t == p ? -1 : t;
}

// the kBoxes TMA loads of one tile of `rows` positions from position `at`
// of head `head`, all counted on `bar`
template <class L>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int head,
                                         int at, int b) {
#pragma unroll
  for (int x = 0; x < L::kBoxes; ++x)
    tma_load_4d(dst + x * rows * 128, map, bar, 64 * x, head, at, b);
}

// (b): S^T = K Q^T and dP^T = V dO^T with the warp's K and V rows as A
// fragments in registers (hd 64) or the warpgroup's K and V as K-major A
// in shared memory (hd 112, 128), and the Q and dO tiles as K-major B; P^T and
// dS^T from those accumulators, rounded to bf16 in registers, as A of
// dV += P^T dO and dK += dS^T Q, dO and Q read MN-major (the transpose
// bit), one 64-column box of dK and dV at a time.
template <int HD>
__global__ void __launch_bounds__(Wg<HD, false>::kThreads, 1)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ lse, const float* __restrict__ D,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int B, int Sq, int Sk, int H, int KVH, int causal,
               int prefix_len, float scale_log2, float scale) {
  using L = Wg<HD, false>;
  constexpr int kN = L::kOuter, kM = L::kInner, kSlots = L::kOuterSlots;
  extern __shared__ float4 smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  // the TMA lane's arrival with its bytes, and the 32 lanes' cp.async
  uint64_t* full = init_bars<L>(sm, 1 + 32);
  uint64_t* empty = full + L::kStages;
  uint64_t* ofull = empty + L::kStages;
  uint64_t* oempty = ofull + kSlots;
  const int G = H / KVH;
  const int n_kt = (Sk + kN - 1) / kN, n_pair = (n_kt + 1) / 2;
  const int n_qt = (Sq + kM - 1) / kM;
  const int items = n_pair * B * KVH;
  const int tid = threadIdx.x;
  // query tiles of key tile j0: from its causal start (0 inside the
  // prefix, or without the mask) to Sq, for each of the G heads
  auto first_qt = [&](int j0) {
    return causal && j0 >= prefix_len ? j0 / kM : 0;
  };

  if (tid >= L::kConsumers) {   // ---------------------------- producer
    setmaxnreg_dec<40>();
    if (tid < L::kConsumers + 32) {
      const int lane = tid & 31;
      Ring in, out;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int p = it % n_pair, bh = it / n_pair;
        const int b = bh / KVH, kvh = bh % KVH;
        for (int half = 0; half < 2; ++half) {
          const int n = tile_of(p, n_kt, half);
          if (n < 0) break;
          const int j0 = n * kN;
          mbar_wait(&oempty[out.st], out.ph ^ 1);
          if (lane == 0) {
            uint8_t* kv = L::outer(sm, out.st);
            mbar_expect_tx(&ofull[out.st], 2 * L::kOuterTile);
            tma_tile<L>(kv, &tk, &ofull[out.st], kN, kvh, j0, b);
            tma_tile<L>(kv + L::kOuterTile, &tv, &ofull[out.st], kN, kvh,
                         j0, b);
          }
          out.next(kSlots);
          for (int g = 0; g < G; ++g) {
            const int h = kvh * G + g;
            const long long row = ((long long)b * H + h) * Sq;
            for (int qt = first_qt(j0); qt < n_qt; ++qt) {
              const int i0 = qt * kM;
              mbar_wait(&empty[in.st], in.ph ^ 1);
              if (lane == 0) {
                uint8_t* qo = L::inner(sm, in.st);
                mbar_expect_tx(&full[in.st], 2 * L::kInnerTile);
                tma_tile<L>(qo, &tq, &full[in.st], kM, h, i0, b);
                tma_tile<L>(qo + L::kInnerTile, &tdo, &full[in.st], kM, h,
                             i0, b);
              }
              float* ls = L::stats(sm, in.st);
#pragma unroll
              for (int r = lane; r < kM; r += 32) {   // zeros past Sq
                const bool ok = i0 + r < Sq;
                cp_async4(ls + r, ok ? lse + row + i0 + r : lse, ok);
                cp_async4(ls + kM + r, ok ? D + row + i0 + r : D, ok);
              }
              mbar_arrive_cp_async(&full[in.st]);
              in.next(L::kStages);
            }
          }
        }
      }
      cp_async_wait<0>();
    }
  } else {                      // ---------------------------- consumers
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2);   // accumulator rows r0, r0 + 8
    const int c0 = (lane & 3) * 2;            // columns 8 j + c0 (+ 1)
    Ring in, out;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int p = it % n_pair, bh = it / n_pair;
      const int b = bh / KVH, kvh = bh % KVH;
      for (int half = 0; half < 2; ++half) {
        const int n = tile_of(p, n_kt, half);
        if (n < 0) break;
        const int j0 = n * kN, jw0 = j0 + wg * 64;   // this warpgroup's keys
        mbar_wait(&ofull[out.st], out.ph);
        const uint8_t* Ks = L::outer(sm, out.st) + wg * 64 * 128;
        const uint8_t* Vs = Ks + L::kOuterTile;
        // hd 64: this warp's 16 keys of K and V as A fragments, for the
        // whole tile; hd 128: the warpgroup's 64 keys as A descriptors
        constexpr int kKf = L::kKvSmem ? 1 : HD / 16;
        uint32_t kf[kKf][4], vf[kKf][4];
        if constexpr (!L::kKvSmem) {
          load_a_sw128(kf, Ks, warp, lane);
          load_a_sw128(vf, Vs, warp, lane);
        }
        const uint64_t kad = desc_k_major(Ks), vad = desc_k_major(Vs);
        constexpr int kB = L::kBoxes;
        float dka[kB][32], dva[kB][32];
#pragma unroll
        for (int x = 0; x < kB; ++x)
#pragma unroll
          for (int i = 0; i < 32; ++i) dka[x][i] = dva[x][i] = 0.f;

        auto step = [&](const uint8_t* qo, const float* ls, int i0,
                        auto kMask) {
          float s[kM / 2], dp[kM / 2];
          const uint64_t qd = desc_k_major(qo);
          const uint64_t od = desc_k_major(qo + L::kInnerTile);
          // k-step kk of a K-major tile: box kk / 4, 32 bytes a step
          auto ks = [](uint64_t d, int kk, int box) {
            return d + (kk / 4) * (box >> 4) + 2 * (kk % 4);
          };
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {               // S^T
            if constexpr (L::kKvSmem)
              wgmma_ss(s, ks(kad, kk, L::kOuterBox), ks(qd, kk, L::kInnerBox),
                       kk);
            else
              wgmma_rs<0>(s, kf[kk], ks(qd, kk, L::kInnerBox), kk);
          }
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {               // dP^T
            if constexpr (L::kKvSmem)
              wgmma_ss(dp, ks(vad, kk, L::kOuterBox), ks(od, kk, L::kInnerBox),
                       kk);
            else
              wgmma_rs<0>(dp, vf[kk], ks(od, kk, L::kInnerBox), kk);
          }
          wgmma_commit();
          // this thread's queries' LSE (times log2 e) and D, read while the
          // products run
          float l2[kM / 4], dd[kM / 4];
#pragma unroll
          for (int j = 0; j < kM / 4; ++j) {
            const int c = 8 * (j / 2) + c0 + (j & 1);
            l2[j] = ls[c] * kLog2e;
            dd[j] = ls[kM + c];
          }
          wgmma_wait<1>();
          fence_regs(s);
#pragma unroll
          for (int i = 0; i < kM / 2; ++i) {
            const int c = 8 * (i / 4) + c0 + (i & 1);         // query i0 + c
            bool ok = true;
            if constexpr (decltype(kMask)::value) {
              const int j = jw0 + r0 + 8 * ((i >> 1) & 1), q = i0 + c;
              ok = j < Sk && q < Sq && (!causal || j <= q || j < prefix_len);
            }
            s[i] = ok ? ex2(fmaf(s[i], scale_log2, -l2[2 * (i / 4) + (i & 1)]))
                      : 0.f;
          }
          wgmma_wait<0>();
          fence_regs(dp);
          uint32_t pa[kM / 16][4], da[kM / 16][4];
#pragma unroll
          for (int kk = 0; kk < kM / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = 8 * kk + 2 * r, j = 2 * (i / 4);
              pa[kk][r] = pack_bf16(s[i], s[i + 1]);
              da[kk][r] = pack_bf16(s[i] * (dp[i] - dd[j]),
                                    s[i + 1] * (dp[i + 1] - dd[j + 1]));
            }
          const uint64_t qt_ = desc_mn_major(qo);
          const uint64_t ot = desc_mn_major(qo + L::kInnerTile);
          wgmma_fence();
#pragma unroll
          for (int x = 0; x < kB; ++x) {
            fence_regs(dva[x]);
            fence_regs(dka[x]);
          }
#pragma unroll
          for (int x = 0; x < kB; ++x)
#pragma unroll
            for (int kk = 0; kk < kM / 16; ++kk)                // dV += P^T dO
              wgmma_rs<1>(dva[x], pa[kk],
                          ot + x * (L::kInnerBox >> 4) + 128 * kk, 1);
#pragma unroll
          for (int x = 0; x < kB; ++x)
#pragma unroll
            for (int kk = 0; kk < kM / 16; ++kk)                // dK += dS^T Q
              wgmma_rs<1>(dka[x], da[kk],
                          qt_ + x * (L::kInnerBox >> 4) + 128 * kk, 1);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int x = 0; x < kB; ++x) {
            fence_regs(dva[x]);
            fence_regs(dka[x]);
          }
          fence_regs(pa);
          fence_regs(da);
          if constexpr (!L::kKvSmem) {
            fence_regs(kf);   // see load_a_sw128
            fence_regs(vf);
          }
        };

        for (int g = 0; g < G; ++g) {
          for (int qt = first_qt(j0); qt < n_qt; ++qt) {
            const int i0 = qt * kM;
            mbar_wait(&full[in.st], in.ph);
            // some key of this warpgroup sees some query of the tile
            const bool seen = jw0 < Sk && (!causal || jw0 < prefix_len ||
                                           i0 + kM - 1 >= jw0);
            if (seen) {
              const uint8_t* qo = L::inner(sm, in.st);
              const float* ls = L::stats(sm, in.st);
              const bool whole = jw0 + 64 <= Sk && i0 + kM <= Sq &&
                                 (!causal || jw0 + 63 <= i0 ||
                                  jw0 + 64 <= prefix_len);
              if (whole) step(qo, ls, i0, std::false_type{});
              else step(qo, ls, i0, std::true_type{});
            }
            mbar_arrive(&empty[in.st]);
            in.next(L::kStages);
          }
        }
        mbar_arrive(&oempty[out.st]);
        out.next(kSlots);

#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int j = jw0 + r0 + 8 * h2;
          if (j >= Sk) continue;
          const long long at = row_off(b, Sk, j, KVH, kvh, HD) + c0;
#pragma unroll
          for (int x = 0; x < kB; ++x)
#pragma unroll
            for (int d = 0; d < 8; ++d) {
              if (64 * x + 8 * d >= HD) continue;   // layout padding
              const long long c = at + 64 * x + d * 8;
              *reinterpret_cast<uint32_t*>(dk + c) =
                  pack_bf16(dka[x][4 * d + 2 * h2] * scale,
                            dka[x][4 * d + 2 * h2 + 1] * scale);
              *reinterpret_cast<uint32_t*>(dv + c) =
                  pack_bf16(dva[x][4 * d + 2 * h2],
                            dva[x][4 * d + 2 * h2 + 1]);
            }
        }
      }
    }
  }
}

// (c): S = Q K^T and dP = dO V^T with the warp's Q and dO rows as A
// (b) at hd 256 (Wg::kSplit): the two warpgroups share one tile of 64
// keys. Warpgroup 0 computes S^T = K Q^T and P^T, writes P^T (fp32) to
// shared memory and accumulates dV += P^T dO; warpgroup 1 computes dP^T
// = V dO^T, reads P^T beside it to form dS^T = P^T o (dP^T - D), and
// accumulates dK += dS^T Q. K and V are K-major A descriptors, Q and dO
// K-major B (S^T, dP^T) and MN-major B (dV, dK). One named barrier over
// the 256 consumer threads a step; two P^T buffers, so warpgroup 0
// writes one while warpgroup 1 may still read the other, and a buffer is
// written again only after the next step's barrier, which warpgroup 1
// reaches once it has read it.
template <int HD>
__global__ void __launch_bounds__(Wg<HD, false>::kThreads, 1)
bwd_dkdv_split(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ lse, const float* __restrict__ D,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int B, int Sq, int Sk, int H, int KVH, int causal,
               int prefix_len, float scale_log2, float scale) {
  using L = Wg<HD, false>;
  static_assert(L::kSplit, "hd 256's layout");
  constexpr int kN = L::kOuter, kM = L::kInner, kB = L::kBoxes;
  extern __shared__ float4 smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  // the TMA lane's arrival with its bytes, and the 32 lanes' cp.async
  uint64_t* full = init_bars<L>(sm, 1 + 32);
  uint64_t* empty = full + L::kStages;
  uint64_t* ofull = empty + L::kStages;
  uint64_t* oempty = ofull + L::kOuterSlots;
  const int G = H / KVH;
  const int n_kt = (Sk + kN - 1) / kN, n_qt = (Sq + kM - 1) / kM;
  const int items = n_kt * B * KVH;
  const int tid = threadIdx.x;
  // query tiles of key tile j0: from its causal start (0 inside the
  // prefix, or without the mask) to Sq, for each of the G heads
  auto first_qt = [&](int j0) {
    return causal && j0 >= prefix_len ? j0 / kM : 0;
  };

  if (tid >= L::kConsumers) {   // ---------------------------- producer
    setmaxnreg_dec<40>();
    if (tid < L::kConsumers + 32) {
      const int lane = tid & 31;
      Ring in, out;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int j0 = it % n_kt * kN, bh = it / n_kt;
        const int b = bh / KVH, kvh = bh % KVH;
        mbar_wait(&oempty[out.st], out.ph ^ 1);
        if (lane == 0) {
          uint8_t* kv = L::outer(sm, out.st);
          mbar_expect_tx(&ofull[out.st], 2 * L::kOuterTile);
          tma_tile<L>(kv, &tk, &ofull[out.st], kN, kvh, j0, b);
          tma_tile<L>(kv + L::kOuterTile, &tv, &ofull[out.st], kN, kvh, j0,
                      b);
        }
        out.next(L::kOuterSlots);
        for (int g = 0; g < G; ++g) {
          const int h = kvh * G + g;
          const long long row = ((long long)b * H + h) * Sq;
          for (int qt = first_qt(j0); qt < n_qt; ++qt) {
            const int i0 = qt * kM;
            mbar_wait(&empty[in.st], in.ph ^ 1);
            if (lane == 0) {
              uint8_t* qo = L::inner(sm, in.st);
              mbar_expect_tx(&full[in.st], 2 * L::kInnerTile);
              tma_tile<L>(qo, &tq, &full[in.st], kM, h, i0, b);
              tma_tile<L>(qo + L::kInnerTile, &tdo, &full[in.st], kM, h, i0,
                          b);
            }
            float* ls = L::stats(sm, in.st);
            const bool ok = i0 + lane < Sq;           // zeros past Sq
            cp_async4(ls + lane, ok ? lse + row + i0 + lane : lse, ok);
            cp_async4(ls + kM + lane, ok ? D + row + i0 + lane : D, ok);
            mbar_arrive_cp_async(&full[in.st]);
            in.next(L::kStages);
          }
        }
      }
      cp_async_wait<0>();
    }
  } else {                      // ---------------------------- consumers
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2);   // accumulator rows r0, r0 + 8
    const int c0 = (lane & 3) * 2;            // columns 8 j + c0 (+ 1)
    const bool has_dv = wg == 0;              // else dK
    int xs = 0;                               // the P^T buffer
    Ring in, out;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int j0 = it % n_kt * kN, bh = it / n_kt;
      const int b = bh / KVH, kvh = bh % KVH;
      mbar_wait(&ofull[out.st], out.ph);
      // K (S^T) or V (dP^T) as A
      const uint64_t ad = desc_k_major(L::outer(sm, out.st) +
                                       (has_dv ? 0 : L::kOuterTile));
      float acc[kB][32];
#pragma unroll
      for (int x = 0; x < kB; ++x)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;

      auto step = [&](const uint8_t* qo, const float* ls, int i0,
                      auto kMask) {
        float s[kM / 2];
        // Q (S^T) or dO (dP^T) as K-major B; k-step kk: box kk / 4, 32
        // bytes a step
        const uint64_t bd = desc_k_major(has_dv ? qo : qo + L::kInnerTile);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(s, ad + (kk / 4) * (L::kOuterBox >> 4) + 2 * (kk % 4),
                   bd + (kk / 4) * (L::kInnerBox >> 4) + 2 * (kk % 4), kk);
        wgmma_commit();
        // this thread's queries' LSE (times log2 e; warpgroup 0) or D
        // (warpgroup 1), read while the product runs
        float st[kM / 4];
#pragma unroll
        for (int j = 0; j < kM / 4; ++j) {
          const int c = 8 * (j / 2) + c0 + (j & 1);
          st[j] = has_dv ? ls[c] * kLog2e : ls[kM + c];
        }
        wgmma_wait<0>();
        fence_regs(s);
        float* px = L::xch(sm, xs) + (tid & 127);
        uint32_t af[kM / 16][4];
        if (has_dv) {
#pragma unroll
          for (int i = 0; i < kM / 2; ++i) {
            const int c = 8 * (i / 4) + c0 + (i & 1);         // query i0 + c
            bool ok = true;
            if constexpr (decltype(kMask)::value) {
              const int j = j0 + r0 + 8 * ((i >> 1) & 1), q = i0 + c;
              ok = j < Sk && q < Sq && (!causal || j <= q || j < prefix_len);
            }
            s[i] = ok ? ex2(fmaf(s[i], scale_log2, -st[2 * (i / 4) + (i & 1)]))
                      : 0.f;
            px[i * 128] = s[i];
          }
#pragma unroll
          for (int kk = 0; kk < kM / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              af[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        }
        bar_sync(1, L::kConsumers);
        if (!has_dv) {
#pragma unroll
          for (int kk = 0; kk < kM / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = 8 * kk + 2 * r, j = 2 * (i / 4);
              af[kk][r] = pack_bf16(px[i * 128] * (s[i] - st[j]),
                                    px[(i + 1) * 128] * (s[i + 1] - st[j + 1]));
            }
        }
        xs ^= 1;
        // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1), dO or Q MN-major
        const uint64_t bt = desc_mn_major(has_dv ? qo + L::kInnerTile : qo);
        wgmma_fence();
#pragma unroll
        for (int x = 0; x < kB; ++x) fence_regs(acc[x]);
#pragma unroll
        for (int x = 0; x < kB; ++x)
#pragma unroll
          for (int kk = 0; kk < kM / 16; ++kk)
            wgmma_rs<1>(acc[x], af[kk], bt + x * (L::kInnerBox >> 4) + 128 * kk,
                        1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < kB; ++x) fence_regs(acc[x]);
        fence_regs(af);
      };

      for (int g = 0; g < G; ++g) {
        for (int qt = first_qt(j0); qt < n_qt; ++qt) {
          const int i0 = qt * kM;
          mbar_wait(&full[in.st], in.ph);
          // some key of the tile sees some query of this one
          const bool seen = j0 < Sk && (!causal || j0 < prefix_len ||
                                        i0 + kM - 1 >= j0);
          if (seen) {
            const uint8_t* qo = L::inner(sm, in.st);
            const float* ls = L::stats(sm, in.st);
            const bool whole = j0 + kN <= Sk && i0 + kM <= Sq &&
                               (!causal || j0 + kN - 1 <= i0 ||
                                j0 + kN <= prefix_len);
            if (whole) step(qo, ls, i0, std::false_type{});
            else step(qo, ls, i0, std::true_type{});
          }
          mbar_arrive(&empty[in.st]);
          in.next(L::kStages);
        }
      }
      mbar_arrive(&oempty[out.st]);
      out.next(L::kOuterSlots);

      __nv_bfloat16* dst = has_dv ? dv : dk;
      const float f = has_dv ? 1.f : scale;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = j0 + r0 + 8 * h2;
        if (j >= Sk) continue;
        const long long at = row_off(b, Sk, j, KVH, kvh, HD) + c0;
#pragma unroll
        for (int x = 0; x < kB; ++x)
#pragma unroll
          for (int d = 0; d < 8; ++d)
            *reinterpret_cast<uint32_t*>(dst + at + 64 * x + d * 8) =
                pack_bf16(acc[x][4 * d + 2 * h2] * f,
                          acc[x][4 * d + 2 * h2 + 1] * f);
      }
    }
  }
}

// (c): S = Q K^T and dP = dO V^T with the warp's Q and dO rows as A
// fragments in registers (hd 64 .. 128) or the warpgroup's Q and dO as
// K-major A in shared memory (hd 256, kQoSmem) and the K and V tiles as
// K-major B; dS from those accumulators, rounded to bf16 in registers, as
// A of dQ += dS K, K read MN-major, one 64-column box of dQ at a time.
// Rows are 128 queries of one head (64 a warpgroup); the key loop stops
// at the causal diagonal of the block's last query, or at the prefix.
template <int HD>
__global__ void __launch_bounds__(Wg<HD, true>::kThreads, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const float* __restrict__ lse, const float* __restrict__ D,
             __nv_bfloat16* __restrict__ dq, int B, int Sq, int Sk, int H,
             int KVH, int causal, int prefix_len, float scale_log2,
             float scale) {
  using L = Wg<HD, true>;
  constexpr int kM = L::kOuter, kN = L::kInner, kSlots = L::kOuterSlots;
  extern __shared__ float4 smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = init_bars<L>(sm, 1);
  uint64_t* empty = full + L::kStages;
  uint64_t* ofull = empty + L::kStages;
  uint64_t* oempty = ofull + kSlots;
  const int G = H / KVH;
  const int n_mt = (Sq + kM - 1) / kM, n_pair = (n_mt + 1) / 2;
  const int items = n_pair * B * H;
  const int tid = threadIdx.x;
  // the keys that rows below `end` (and the prefix) see
  auto keys_below = [&](int end) {
    return causal ? min(Sk, max(min(end, Sq), prefix_len)) : Sk;
  };

  if (tid >= L::kConsumers) {   // ---------------------------- producer
    setmaxnreg_dec<40>();
    if (tid == L::kConsumers) {
      Ring in, out;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int p = it % n_pair, bh = it / n_pair;
        const int b = bh / H, h = bh % H, kvh = h / G;
        for (int half = 0; half < 2; ++half) {
          const int m = tile_of(p, n_mt, half);
          if (m < 0) break;
          const int i0 = m * kM;
          mbar_wait(&oempty[out.st], out.ph ^ 1);
          uint8_t* qo = L::outer(sm, out.st);
          mbar_expect_tx(&ofull[out.st], 2 * L::kOuterTile);
          tma_tile<L>(qo, &tq, &ofull[out.st], kM, h, i0, b);
          tma_tile<L>(qo + L::kOuterTile, &tdo, &ofull[out.st], kM, h, i0,
                      b);
          out.next(kSlots);
          const int n_t = (keys_below(i0 + kM) + kN - 1) / kN;
          for (int t = 0; t < n_t; ++t) {
            mbar_wait(&empty[in.st], in.ph ^ 1);
            uint8_t* kv = L::inner(sm, in.st);
            mbar_expect_tx(&full[in.st], 2 * L::kInnerTile);
            tma_tile<L>(kv, &tk, &full[in.st], kN, kvh, t * kN, b);
            tma_tile<L>(kv + L::kInnerTile, &tv, &full[in.st], kN, kvh,
                        t * kN, b);
            in.next(L::kStages);
          }
        }
      }
    }
  } else {                      // ---------------------------- consumers
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2);   // accumulator rows r0, r0 + 8
    const int c0 = (lane & 3) * 2;            // columns 8 j + c0 (+ 1)
    Ring in, out;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int p = it % n_pair, bh = it / n_pair;
      const int b = bh / H, h = bh % H;
      for (int half = 0; half < 2; ++half) {
        const int m = tile_of(p, n_mt, half);
        if (m < 0) break;
        const int i0 = m * kM, iw0 = i0 + wg * 64;   // this warpgroup's rows
        // this lane's rows: their LSE (times log2 e), D and key limit
        float lse2[2], Dr[2];
        int lim[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = iw0 + r0 + 8 * h2;
          lse2[h2] = Dr[h2] = 0.f;
          lim[h2] = 0;
          if (i < Sq) {
            const long long at = ((long long)b * H + h) * Sq + i;
            lse2[h2] = lse[at] * kLog2e;
            Dr[h2] = D[at];
            lim[h2] = causal ? min(Sk, max(i + 1, prefix_len)) : Sk;
          }
        }
        // tiles from wg_end on are masked for every row of the warpgroup;
        // those below whole_end are seen by all of them
        const int wg_end = iw0 < Sq ? keys_below(iw0 + 64) : 0;
        const int whole_end = causal ? min(Sk, max(iw0 + 1, prefix_len)) : Sk;
        const int n_t = (keys_below(i0 + kM) + kN - 1) / kN;
        mbar_wait(&ofull[out.st], out.ph);
        const uint8_t* Qs = L::outer(sm, out.st) + wg * 64 * 128;
        // this warp's 16 rows of Q and dO as A fragments, for the whole
        // tile; hd 256: the warpgroup's 64 rows as A descriptors
        constexpr int kQf = L::kQoSmem ? 1 : HD / 16;
        uint32_t qf[kQf][4], of[kQf][4];
        if constexpr (!L::kQoSmem) {
          load_a_sw128(qf, Qs, warp, lane, L::kOuterBox);
          load_a_sw128(of, Qs + L::kOuterTile, warp, lane, L::kOuterBox);
        }
        const uint64_t qad = desc_k_major(Qs);
        const uint64_t oad = desc_k_major(Qs + L::kOuterTile);
        constexpr int kB = L::kBoxes;
        float dqa[kB][32];
#pragma unroll
        for (int x = 0; x < kB; ++x)
#pragma unroll
          for (int i = 0; i < 32; ++i) dqa[x][i] = 0.f;

        auto step = [&](const uint8_t* kv, int t0, auto kMask) {
          float s[kN / 2], dp[kN / 2];
          const uint64_t kd = desc_k_major(kv);
          const uint64_t vd = desc_k_major(kv + L::kInnerTile);
          // k-step kk of a K-major tile: box kk / 4, 32 bytes a step
          auto ks = [](uint64_t d, int kk, int box) {
            return d + (kk / 4) * (box >> 4) + 2 * (kk % 4);
          };
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {               // S
            if constexpr (L::kQoSmem)
              wgmma_ss(s, ks(qad, kk, L::kOuterBox), ks(kd, kk, L::kInnerBox),
                       kk);
            else
              wgmma_rs<0>(s, qf[kk], ks(kd, kk, L::kInnerBox), kk);
          }
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {               // dP
            if constexpr (L::kQoSmem)
              wgmma_ss(dp, ks(oad, kk, L::kOuterBox), ks(vd, kk, L::kInnerBox),
                       kk);
            else
              wgmma_rs<0>(dp, of[kk], ks(vd, kk, L::kInnerBox), kk);
          }
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(s);
#pragma unroll
          for (int i = 0; i < kN / 2; ++i) {
            const int h2 = (i >> 1) & 1;
            bool ok = true;
            if constexpr (decltype(kMask)::value)
              ok = t0 + 8 * (i / 4) + c0 + (i & 1) < lim[h2];
            s[i] = ok ? ex2(fmaf(s[i], scale_log2, -lse2[h2])) : 0.f;
          }
          wgmma_wait<0>();
          fence_regs(dp);
          uint32_t da[kN / 16][4];
#pragma unroll
          for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = 8 * kk + 2 * r, h2 = r & 1;
              da[kk][r] = pack_bf16(s[i] * (dp[i] - Dr[h2]),
                                    s[i + 1] * (dp[i + 1] - Dr[h2]));
            }
          const uint64_t kt = desc_mn_major(kv);
          wgmma_fence();
#pragma unroll
          for (int x = 0; x < kB; ++x) fence_regs(dqa[x]);
#pragma unroll
          for (int x = 0; x < kB; ++x)
#pragma unroll
            for (int kk = 0; kk < kN / 16; ++kk)                // dQ += dS K
              wgmma_rs<1>(dqa[x], da[kk],
                          kt + x * (L::kInnerBox >> 4) + 128 * kk, 1);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int x = 0; x < kB; ++x) fence_regs(dqa[x]);
          fence_regs(da);
          if constexpr (!L::kQoSmem) {
            fence_regs(qf);   // see load_a_sw128
            fence_regs(of);
          }
        };

        for (int t = 0; t < n_t; ++t) {
          const int t0 = t * kN;
          mbar_wait(&full[in.st], in.ph);
          if (t0 < wg_end) {
            const uint8_t* kv = L::inner(sm, in.st);
            if (t0 + kN <= whole_end) step(kv, t0, std::false_type{});
            else step(kv, t0, std::true_type{});
          }
          mbar_arrive(&empty[in.st]);
          in.next(L::kStages);
        }
        mbar_arrive(&oempty[out.st]);
        out.next(kSlots);

#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = iw0 + r0 + 8 * h2;
          if (i >= Sq) continue;
          const long long at = row_off(b, Sq, i, H, h, HD) + c0;
#pragma unroll
          for (int x = 0; x < kB; ++x)
#pragma unroll
            for (int d = 0; d < 8; ++d)
              if (64 * x + 8 * d < HD)   // not the layout's padding
                *reinterpret_cast<uint32_t*>(dq + at + 64 * x + d * 8) =
                    pack_bf16(dqa[x][4 * d + 2 * h2] * scale,
                              dqa[x][4 * d + 2 * h2 + 1] * scale);
        }
      }
    }
  }
}

// ------------------------------------------------------------ fp32: FMA
// 32 keys (b) or 32 rows (c) a block; thread t owns key (row) t / 4 and
// head-dim columns t % 4 + 4 m of its accumulators, and scores its key
// (row) against queries (keys) t % 4 + 4 n of the tile. Rows in shared
// memory are padded by one float.
template <int HD>
struct FmaBwd {
  static constexpr int kN = 32;
  static constexpr int kStride = HD + 1;
  static constexpr int kTile = kN * kStride;
  static constexpr int kPStride = kN + 1;
  // four [32, HD] tiles, two [32, 32] score tiles, LSE and D
  static constexpr size_t bytes =
      (4 * kTile + 2 * kN * kPStride + 2 * kN) * sizeof(float);
};

template <int HD>
__device__ __forceinline__ void fma_tile(float* dst, const float* src,
                                         int n_valid, long long row_stride) {
  for (int i = threadIdx.x; i < FmaBwd<HD>::kN * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * FmaBwd<HD>::kStride + d] =
        r < n_valid ? src[r * row_stride + d] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_fma(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ D,
             float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
             int H, int KVH, int causal, int prefix_len, float scale) {
  using L = FmaBwd<HD>;
  constexpr int kN = L::kN, kM = HD / 4;
  extern __shared__ float4 smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + L::kTile;
  float* Qs = Vs + L::kTile;
  float* Os = Qs + L::kTile;
  float* Ps = Os + L::kTile;
  float* dSs = Ps + kN * L::kPStride;
  float* Ls = dSs + kN * L::kPStride;
  float* Ds = Ls + kN;
  const int G = H / KVH;
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int bh = lin % gridDim.y;
  const int b = bh / KVH, kvh = bh % KVH;
  const int j0 = lin / gridDim.y * kN;
  const int tid = threadIdx.x, jj = tid >> 2, qd = tid & 3;
  const int n_qt = (Sq + kN - 1) / kN;
  const int qt0 = causal && j0 >= prefix_len ? j0 / kN : 0;

  const long long kvs = (long long)KVH * HD;   // a key's stride
  fma_tile<HD>(Ks, k + row_off(b, Sk, j0, KVH, kvh, HD), Sk - j0, kvs);
  fma_tile<HD>(Vs, v + row_off(b, Sk, j0, KVH, kvh, HD), Sk - j0, kvs);
  float dka[kM], dva[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) dka[m] = dva[m] = 0.f;
  const int j = j0 + jj;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int i0 = qt * kN;
      __syncthreads();   // the previous tile fully consumed
      fma_tile<HD>(Qs, q + row_off(b, Sq, i0, H, h, HD), Sq - i0,
                   (long long)H * HD);
      fma_tile<HD>(Os, dO + row_off(b, Sq, i0, H, h, HD), Sq - i0,
                   (long long)H * HD);
      if (tid < kN) {
        const bool ok = i0 + tid < Sq;
        const long long at = ((long long)b * H + h) * Sq + i0 + tid;
        Ls[tid] = ok ? lse[at] : 0.f;
        Ds[tid] = ok ? D[at] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < kN / 4; ++n) {
        const int ii = qd + 4 * n, i = i0 + ii;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          s += Ks[jj * L::kStride + d] * Qs[ii * L::kStride + d];
          dp += Vs[jj * L::kStride + d] * Os[ii * L::kStride + d];
        }
        const bool ok = j < Sk && i < Sq &&
                        (!causal || j <= i || j < prefix_len);
        const float p = ok ? expf(s * scale - Ls[ii]) : 0.f;
        Ps[jj * L::kPStride + ii] = p;
        dSs[jj * L::kPStride + ii] = p * (dp - Ds[ii]);
      }
      __syncthreads();
      for (int ii = 0; ii < kN; ++ii) {
        const float p = Ps[jj * L::kPStride + ii];
        const float ds = dSs[jj * L::kPStride + ii];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          dva[m] += p * Os[ii * L::kStride + qd + 4 * m];
          dka[m] += ds * Qs[ii * L::kStride + qd + 4 * m];
        }
      }
    }
  }
  if (j < Sk) {
    const long long at = row_off(b, Sk, j, KVH, kvh, HD);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      dk[at + qd + 4 * m] = dka[m] * scale;
      dv[at + qd + 4 * m] = dva[m];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dO,
           const float* __restrict__ lse, const float* __restrict__ D,
           float* __restrict__ dq, int Sq, int Sk, int H, int KVH, int causal,
           int prefix_len, float scale) {
  using L = FmaBwd<HD>;
  constexpr int kN = L::kN, kM = HD / 4;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Os = Qs + L::kTile;
  float* Ks = Os + L::kTile;
  float* Vs = Ks + L::kTile;
  float* dSs = Vs + L::kTile;
  float* Ls = dSs + 2 * kN * L::kPStride;
  float* Ds = Ls + kN;
  const int G = H / KVH;
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int bh = lin % gridDim.y;
  const int b = bh / KVH, kvh = bh % KVH;
  const int rows_total = Sq * G;
  const int r0 = (gridDim.x - 1 - lin / gridDim.y) * kN;
  const int tid = threadIdx.x, rr = tid >> 2, qd = tid & 3;
  const int last_q = (min(r0 + kN, rows_total) - 1) / G;
  const int n_keys = causal ? min(Sk, max(last_q + 1, prefix_len)) : Sk;

  // rows (query fr / G, head kvh * G + fr % G)
  for (int i = tid; i < kN * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, fr = r0 + r;
    float x = 0.f, y = 0.f;
    if (fr < rows_total) {
      const long long at = row_off(b, Sq, fr / G, H, kvh * G + fr % G, HD);
      x = q[at + d];
      y = dO[at + d];
    }
    Qs[r * L::kStride + d] = x;
    Os[r * L::kStride + d] = y;
  }
  if (tid < kN) {
    const int fr = r0 + tid;
    float l = 0.f, dd = 0.f;
    if (fr < rows_total) {
      const long long at = ((long long)b * H + kvh * G + fr % G) * Sq + fr / G;
      l = lse[at];
      dd = D[at];
    }
    Ls[tid] = l;
    Ds[tid] = dd;
  }
  const int fr = r0 + rr;
  const int qp = fr / G;
  float dqa[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) dqa[m] = 0.f;

  const long long kvs = (long long)KVH * HD;
  for (int t0 = 0; t0 < n_keys; t0 += kN) {
    __syncthreads();   // Q stored; the previous tile fully consumed
    fma_tile<HD>(Ks, k + row_off(b, Sk, t0, KVH, kvh, HD), n_keys - t0, kvs);
    fma_tile<HD>(Vs, v + row_off(b, Sk, t0, KVH, kvh, HD), n_keys - t0, kvs);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kN / 4; ++n) {
      const int jj = qd + 4 * n, key = t0 + jj;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        s += Qs[rr * L::kStride + d] * Ks[jj * L::kStride + d];
        dp += Os[rr * L::kStride + d] * Vs[jj * L::kStride + d];
      }
      const bool ok = fr < rows_total && key < n_keys &&
                      (!causal || key <= qp || key < prefix_len);
      const float p = ok ? expf(s * scale - Ls[rr]) : 0.f;
      dSs[rr * L::kPStride + jj] = p * (dp - Ds[rr]);
    }
    __syncthreads();
    for (int jj = 0; jj < kN; ++jj) {
      const float ds = dSs[rr * L::kPStride + jj];
#pragma unroll
      for (int m = 0; m < kM; ++m) dqa[m] += ds * Ks[jj * L::kStride + qd + 4 * m];
    }
  }
  if (fr < rows_total) {
    const long long at = row_off(b, Sq, qp, H, kvh * G + fr % G, HD);
#pragma unroll
    for (int m = 0; m < kM; ++m) dq[at + qd + 4 * m] = dqa[m] * scale;
  }
}

template <typename T, int HD>
int launch_dot(const void* o, const void* dO, void* D, int B, int Sq, int H,
               cudaStream_t stream) {
  using C = DotCfg<T, HD>;
  const int P = std::min(16, std::max(4, kDotThreads * C::kU / (H * C::kL)));
  const int tiles = (Sq + P - 1) / P;
  bwd_dot<T, HD><<<B * tiles, kDotThreads, P * (H + 1) * sizeof(float),
                   stream>>>(static_cast<const T*>(o),
                             static_cast<const T*>(dO),
                             static_cast<float*>(D), Sq, H, P, tiles);
  return (int)cudaGetLastError();
}

template <typename Kern>
int set_smem(Kern kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// (b)'s and (c)'s dynamic shared memory (the larger of the two at hd 256,
// where their layouts differ)
template <typename T, int HD>
size_t smem_bytes(int part = 2) {
  if constexpr (std::is_same<T, float>::value) return FmaBwd<HD>::bytes;
  else
    return part == 0 ? Wg<HD, false>::bytes
           : part == 1 ? Wg<HD, true>::bytes
           : std::max(Wg<HD, false>::bytes, Wg<HD, true>::bytes);
}

// bf16 [B, S, heads, hd] outputs of zeros: the gradient where the other
// side has no position (Sq = 0 for dK/dV, Sk = 0 for dQ)
inline int zero(void* p, long long n, cudaStream_t stream) {
  return (int)cudaMemsetAsync(p, 0, n * sizeof(__nv_bfloat16), stream);
}

template <typename T, int HD>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dO,
                const float* lse, const float* D, void* dk, void* dv, int B,
                int Sq, int Sk, int H, int KVH, int causal, int prefix_len,
                float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(0);
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((Sk + FmaBwd<HD>::kN - 1) / FmaBwd<HD>::kN, B * KVH);
    int e = set_smem(bwd_dkdv_fma<HD>, smem);
    if (e) return e;
    bwd_dkdv_fma<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dO), lse, D,
        static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, KVH,
        causal, prefix_len, scale);
  } else {
    using L = Wg<HD, false>;
    if (Sq == 0) {
      const long long n = (long long)B * Sk * KVH * HD;
      const int e = zero(dk, n, stream);
      return e ? e : zero(dv, n, stream);
    }
    CUtensorMap tq, tdo, tk, tv;
    constexpr int m = L::kHdMultiple;
    if (!encode_rows(&tq, q, HD, H, Sq, B, L::kInner, m) ||
        !encode_rows(&tdo, dO, HD, H, Sq, B, L::kInner, m) ||
        !encode_rows(&tk, k, HD, KVH, Sk, B, L::kOuter, m) ||
        !encode_rows(&tv, v, HD, KVH, Sk, B, L::kOuter, m))
      return (int)cudaErrorInvalidValue;
    const int n_kt = (Sk + L::kOuter - 1) / L::kOuter;
    const int items = (L::kSplit ? n_kt : (n_kt + 1) / 2) * B * KVH;
    const int grid = std::min(items, sm_count());
    if constexpr (L::kSplit) {
      int e = set_smem(bwd_dkdv_split<HD>, smem);
      if (e) return e;
      bwd_dkdv_split<HD><<<grid, L::kThreads, smem, stream>>>(
          tq, tdo, tk, tv, lse, D, static_cast<T*>(dk), static_cast<T*>(dv),
          B, Sq, Sk, H, KVH, causal, prefix_len, scale * kLog2e, scale);
    } else {
      int e = set_smem(bwd_dkdv_wgmma<HD>, smem);
      if (e) return e;
      bwd_dkdv_wgmma<HD><<<grid, L::kThreads, smem, stream>>>(
          tq, tdo, tk, tv, lse, D, static_cast<T*>(dk), static_cast<T*>(dv),
          B, Sq, Sk, H, KVH, causal, prefix_len, scale * kLog2e, scale);
    }
  }
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* D, void* dq, int B, int Sq,
              int Sk, int H, int KVH, int causal, int prefix_len, float scale,
              cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(1);
  if constexpr (std::is_same<T, float>::value) {
    const int rows = Sq * (H / KVH);
    const dim3 grid((rows + FmaBwd<HD>::kN - 1) / FmaBwd<HD>::kN, B * KVH);
    int e = set_smem(bwd_dq_fma<HD>, smem);
    if (e) return e;
    bwd_dq_fma<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dO), lse, D,
        static_cast<float*>(dq), Sq, Sk, H, KVH, causal, prefix_len, scale);
  } else {
    using L = Wg<HD, true>;
    if (Sk == 0) return zero(dq, (long long)B * Sq * H * HD, stream);
    CUtensorMap tq, tdo, tk, tv;
    constexpr int m = L::kHdMultiple;
    if (!encode_rows(&tq, q, HD, H, Sq, B, L::kOuter, m) ||
        !encode_rows(&tdo, dO, HD, H, Sq, B, L::kOuter, m) ||
        !encode_rows(&tk, k, HD, KVH, Sk, B, L::kInner, m) ||
        !encode_rows(&tv, v, HD, KVH, Sk, B, L::kInner, m))
      return (int)cudaErrorInvalidValue;
    const int n_mt = (Sq + L::kOuter - 1) / L::kOuter;
    const int items = (n_mt + 1) / 2 * B * H;
    int e = set_smem(bwd_dq_wgmma<HD>, smem);
    if (e) return e;
    bwd_dq_wgmma<HD><<<std::min(items, sm_count()), L::kThreads, smem,
                       stream>>>(
        tq, tdo, tk, tv, lse, D, static_cast<T*>(dq), B, Sq, Sk, H, KVH,
        causal, prefix_len, scale * kLog2e, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The head dims the backward is built for, one line a width.
#define BWD_WIDTHS(X) X(64) X(112) X(128) X(256)

// Every entry takes contiguous tensors (see the header) and returns the
// cudaError_t of its launch (0 on success); a width or dtype it was not
// built for gives cudaErrorInvalidValue. An empty grid launches nothing.

// (a) D [B, H, Sq] = sum over the head dim of dO * O.
extern "C" int flash_attention_bwd_dot(const void* o, const void* dO, void* D,
                                       int dtype, int hd, int B, int Sq,
                                       int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD_DOT(HD)                                                          \
  if (hd == HD) {                                                           \
    if (dtype == kBFloat16)                                                 \
      return launch_dot<__nv_bfloat16, HD>(o, dO, D, B, Sq, H, s);          \
    if (dtype == kFloat32)                                                  \
      return launch_dot<float, HD>(o, dO, D, B, Sq, H, s);                  \
    return (int)cudaErrorInvalidValue;                                      \
  }
  BWD_WIDTHS(BWD_DOT)
#undef BWD_DOT
  return (int)cudaErrorInvalidValue;
}

// (b) dk, dv [B, Sk, KVH, hd] from q, k, v, dO, the forward's lse and D.
extern "C" int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* D, void* dk, void* dv, int dtype, int hd,
    int B, int Sq, int Sk, int H, int KVH, int causal, int prefix_len,
    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(D);
#define BWD_DKDV(HD)                                                         \
  if (hd == HD) {                                                           \
    if (dtype == kBFloat16)                                                 \
      return launch_dkdv<__nv_bfloat16, HD>(q, k, v, dO, l, d, dk, dv, B,   \
                                            Sq, Sk, H, KVH, causal,         \
                                            prefix_len, scale, s);          \
    if (dtype == kFloat32)                                                  \
      return launch_dkdv<float, HD>(q, k, v, dO, l, d, dk, dv, B, Sq, Sk,   \
                                    H, KVH, causal, prefix_len, scale, s);  \
  }
  BWD_WIDTHS(BWD_DKDV)
#undef BWD_DKDV
  return (int)cudaErrorInvalidValue;
}

// (c) dq [B, Sq, H, hd] from q, k, v, dO, the forward's lse and D.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dO,
                                      const void* lse, const void* D,
                                      void* dq, int dtype, int hd, int B,
                                      int Sq, int Sk, int H, int KVH,
                                      int causal, int prefix_len, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(D);
#define BWD_DQ(HD)                                                           \
  if (hd == HD) {                                                           \
    if (dtype == kBFloat16)                                                 \
      return launch_dq<__nv_bfloat16, HD>(q, k, v, dO, l, d, dq, B, Sq, Sk, \
                                          H, KVH, causal, prefix_len,       \
                                          scale, s);                        \
    if (dtype == kFloat32)                                                  \
      return launch_dq<float, HD>(q, k, v, dO, l, d, dq, B, Sq, Sk, H, KVH, \
                                  causal, prefix_len, scale, s);            \
  }
  BWD_WIDTHS(BWD_DQ)
#undef BWD_DQ
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the dK/dV and dQ launches at (dtype, hd), in
// bytes (the larger of the two where their layouts differ); 0 for one not
// built.
extern "C" int flash_attention_bwd_smem_bytes(int dtype, int hd) {
#define BWD_SMEM(HD)                                                         \
  if (hd == HD) {                                                           \
    if (dtype == kBFloat16) return (int)smem_bytes<__nv_bfloat16, HD>();    \
    if (dtype == kFloat32) return (int)smem_bytes<float, HD>();             \
  }
  BWD_WIDTHS(BWD_SMEM)
#undef BWD_SMEM
  return 0;
}
