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
// = 4096, 16 experts, top-2, ~512 live rows an expert, D 4096, F 6400): dX
// as much its bytes (w read once, the whole [E, C, Din] output written,
// 7/8 of it dead rows of zeros) as its 2 * live * Din * Dout products; dW
// the products (its output, 0.84 GB at that width, takes 0.6 of their
// time).
//
// bf16 (expert_bwd_wgmma, the training path): one persistent block an SM
// walks a list of 128 x 256 output tiles that every thread builds from
// fill on the device (no host read of fill, no counter, no scratch):
// block b takes tiles b, b + gridDim.x, ...
//  * dX: the live tiles only, expert by expert, ceil(live / 128) row tiles
//    by ceil(Din / 256) column tiles, the row tile fastest, so the blocks
//    that run together share one column tile of w[e] and it comes from
//    device memory about once;
//  * dW: every tile of every expert, expert-major (its live rows of xe and
//    dy stay in L2 while its tiles run), the row tile fastest.
// Three warpgroups: the third gives up its registers (setmaxnreg) and one
// of its threads produces, TMA loads of 64-deep slabs of A and B (boxes of
// 64 columns, 128-byte swizzled) into a ring of 3 slots under full/empty
// mbarriers; the first two consume, 64 output rows each, on wgmma
// m64n256k16 (128 fp32 accumulators a thread, 224 registers), reading both
// operands from shared memory, and release a slot as soon as their own
// products on it are done (the other warpgroup's keep the tensor cores
// busy meanwhile). The operands are read where they lie, with no
// transposed copy:
//  * dX: A = dy rows and B = w[e] rows, both with Dout contiguous: plain
//    K-major descriptors;
//  * dW: A = xe[e, k-slab, rows] and B = dy[e, k-slab, columns], both
//    MN-major, read through wgmma's transpose bits; B spans four 64-column
//    boxes, 8 KB apart (the descriptor's leading byte offset).
// The epilogue's stores overlap the next tile: each consumer warpgroup
// rounds its 64 x 256 accumulators to bf16 into its own half of a staging
// tile (the 128-byte swizzle, so the writes hit no bank twice) and one
// thread writes it with TMA stores; it waits for those stores to have read
// the half only when it next writes it, while the producer already fills
// the ring with the next tile's slabs. The rounding and staging writes
// themselves are not overlapped with products: two warpgroups taking turns
// over separate tiles would each read all of B for half the rows, and the
// wgmma operands and TMA fills already take most of the shared memory's
// bandwidth; writing straight from the accumulators to device memory (4
// bytes a thread a row) was slower for dW on the card. Two runs are
// bitwise equal: one block owns each output tile and sums its slabs in
// order, no atomics.
// fill masking:
//  * dX: output row c depends on dy row c alone, so A needs no mask: rows
//    at or past fill inside the last live tile of an expert are zeroed in
//    the staging tile, and a consumer warpgroup whose 64 rows all lie past
//    fill skips its wgmmas. The rows past the last live tile of expert e
//    form one contiguous span of the output, [ceil(fill[e] / 128) 128,
//    C) x Din; the producer writes it with bulk stores of an 8 KB zeroed
//    buffer, one piece every few slabs of its tiles (paced so that the
//    zeros' bytes spread over the products), never reading w there.
//  * dW: a TMA box clips at the tensor's bounds, not at fill, so in the
//    slab that holds fill the consumers zero dy's rows at or past it in
//    shared memory (what the plain version masks), fence them to the async
//    proxy and meet at a named barrier before the wgmmas read them. An
//    expert with fill 0 has no slabs and stores its zeroed accumulators.
// Shapes TMA cannot address (a base not 16-byte aligned, Din or Dout not a
// multiple of 8) take expert_bwd_mma, mma.sync m16n8k16 over 128 x 128
// tiles from ldmatrix, slabs copied by scalar loads into a shared-memory
// ring: a dispatch by shape (body() below, which the wrapper and its tests
// query), not a fallback: a launch that fails raises.
// fp32 (expert_bwd_fma, the checks' path): fp32 FMAs on the CUDA cores
// from 16-deep slabs in shared memory, as the forward's fp32 body (TF32
// cannot meet the fp32 checks).

#include <algorithm>
#include <climits>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using namespace rt;

namespace {

// ------------------------------------------------------------ bf16: wgmma
// The wgmma body's layout: a BM x BN output tile, 64 rows a consumer
// warpgroup; BK-deep slabs of A (BM x BK) and B (BN x BK) in kStages ring
// slots, TMA boxes of 64 columns (128 bytes) by 64 or more rows; a staging
// tile for the bf16 output, one half a consumer warpgroup, each half BN /
// 64 boxes of [64 rows][64 columns]; dX also keeps kZero bytes of zeros,
// the source of its dead-row stores; the full and empty barriers.
template <bool kDW>
struct Gw {
  static constexpr int BM = 128, BN = 256, BK = 64;
  static constexpr int kStages = 3;
  static constexpr int kThreads = 3 * 128;
  static constexpr int kConsumers = 2 * 128;
  static constexpr int kBox = 64 * 128;                 // [64][64] bf16
  // rows of a TMA box of A and of B: dX [BM or BN rows][64 columns of
  // k]; dW [BK rows of k][64 columns], BM / 64 and BN / 64 boxes a slab
  static constexpr int kARows = kDW ? BK : BM, kBRows = kDW ? BK : BN;
  static constexpr int kATile = BM * BK * 2;
  static constexpr int kStage = kATile + BN * BK * 2;   // 48 KB
  static constexpr int kOutAt = kStages * kStage;
  static constexpr int kOutHalf = BN / 64 * kBox;       // 32 KB
  static constexpr int kZeroAt = kOutAt + 2 * kOutHalf;
  static constexpr int kZero = kDW ? 0 : 8192;
  static constexpr int kBarsAt = kZeroAt + kZero;
  // 1024 bytes more than the layout: the swizzled tiles start 1024-aligned
  static constexpr size_t bytes = 1024 + kBarsAt + 2 * kStages * 8;
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

// The tile list that every thread of the block walks in the same order,
// from fill alone (see the header): `seek` gives tile t's expert (e, its
// live rows) and first output row and column; t never goes back.
template <bool kDW>
struct Tiles {
  using L = Gw<kDW>;
  const int* fill;
  int E, C, mt, nt;   // row tiles an expert (dW) and column tiles
  int e = 0, live = 0, base = 0, rows_e = 0;   // dX: the expert cursor
  __device__ Tiles(const int* f, int E_, int C_, int Din, int Dout)
      : fill(f), E(E_), C(C_), mt((Din + L::BM - 1) / L::BM),
        nt(((kDW ? Dout : Din) + L::BN - 1) / L::BN) {
    if (!kDW) set(0);
  }
  __device__ int live_of(int x) const {
    return min(max(__ldg(fill + x), 0), C);
  }
  __device__ void set(int x) {
    e = x;
    live = x < E ? live_of(x) : 0;
    rows_e = (live + L::BM - 1) / L::BM;
  }
  __device__ int total() const {
    if (kDW) return E * mt * nt;
    int n = 0;
    for (int x = 0; x < E; ++x) n += (live_of(x) + L::BM - 1) / L::BM;
    return n * nt;
  }
  __device__ void seek(int t, int& m0, int& n0) {
    int local, per;
    if constexpr (kDW) {
      e = t / (mt * nt);
      live = live_of(e);
      local = t - e * mt * nt;
      per = mt;
    } else {
      while (t >= base + rows_e * nt) {
        base += rows_e * nt;
        set(e + 1);
      }
      local = t - base;
      per = rows_e;
    }
    m0 = local % per * L::BM;
    n0 = local / per * L::BN;
  }
};

// dX's dead rows: expert e's span of the output from the end of its last
// live tile to C, cut in pieces of kZero bytes (the last one shorter),
// numbered expert by expert; `seek` gives piece z's byte offset in the
// output and its length; z never goes back.
struct Dead {
  static constexpr int kPiece = Gw<false>::kZero;
  const int* fill;
  int E, C;
  long long row_bytes;
  int e = 0, base = 0, n = 0;     // expert e's pieces: [base, base + n)
  long long start = 0, bytes = 0;
  __device__ Dead(const int* f, int E_, int C_, int Din)
      : fill(f), E(E_), C(C_), row_bytes(2LL * Din) {
    set(0);
  }
  __device__ void set(int x) {
    e = x;
    if (x >= E) return;
    const int live = min(max(__ldg(fill + x), 0), C);
    const int r0 = min(C, (live + Gw<false>::BM - 1) / Gw<false>::BM *
                              Gw<false>::BM);
    start = ((long long)x * C + r0) * row_bytes;
    bytes = (long long)(C - r0) * row_bytes;
    n = (int)((bytes + kPiece - 1) / kPiece);
  }
  __device__ int total() {
    int z = 0;
    for (int x = 0; x < E; ++x) {
      set(x);
      z += n;
    }
    set(0);
    return z;
  }
  __device__ void seek(int z, long long& off, uint32_t& len) {
    while (z >= base + n) {
      base += n;
      set(e + 1);
    }
    const long long o = (long long)(z - base) * kPiece;
    off = start + o;
    len = (uint32_t)min((long long)kPiece, bytes - o);
  }
};

// dX (kDW false): out [E, C, Din], rows < fill = a [E, C, Dout] (dy) times
//   b [E, Din, Dout] (w) transposed, rows past fill zero.
// dW (kDW true): out [E, Din, Dout] = a [E, C, Din] (xe) transposed over
//   its rows < fill, times b [E, C, Dout] (dy) over the same rows.
// ta, tb, tout: their 3-d tensor maps (encode_3d), boxes of Gw's kARows,
// kBRows and 64 rows.
template <bool kDW>
__global__ void __launch_bounds__(Gw<kDW>::kThreads, 1)
expert_bwd_wgmma(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tout,
                 const int* __restrict__ fill, uint8_t* __restrict__ out,
                 int E, int C, int Din, int Dout) {
  using L = Gw<kDW>;
  constexpr int BM = L::BM, BN = L::BN, BK = L::BK, kS = L::kStages;
  extern __shared__ float4 smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBarsAt);
  uint64_t* empty = full + kS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + s, 1);                      // the producer's, + bytes
      mbar_init(empty + s, L::kConsumers / 32);    // one a consumer warp
    }
    mbar_fence_init();
  }
  if constexpr (!kDW) {
    for (int i = tid; i < L::kZero / 16; i += L::kThreads)
      reinterpret_cast<uint4*>(sm + L::kZeroAt)[i] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();   // before the producer's bulk stores read them
  }
  __syncthreads();
  Tiles<kDW> tiles(fill, E, C, Din, Dout);
  const int n_tiles = tiles.total();
  const int nk_dx = (Dout + BK - 1) / BK;   // dX's slabs: all of Dout

  if (tid >= L::kConsumers) {   // ----------------------------- producer
    setmaxnreg_dec<56>();
    if (tid != L::kConsumers) return;
    const int b = blockIdx.x, G = gridDim.x;
    // dX: this block's pieces of dead rows (b, b + G, ...), issued in step
    // with its slabs: after slab s of S, s * pieces / S of them
    Dead dead(fill, E, C, Din);
    int pieces = 0, issued = 0;
    long long slabs = 1, done = 0;
    if constexpr (!kDW) {
      const int z = dead.total();
      pieces = z > b ? (z - 1 - b) / G + 1 : 0;
      slabs = (long long)(n_tiles > b ? (n_tiles - 1 - b) / G + 1 : 0) *
              nk_dx;
    }
    auto zeros = [&](long long upto) {
      for (; issued < upto; ++issued) {
        long long off;
        uint32_t len;
        dead.seek(b + issued * G, off, len);
        bulk_store(out + off, sm + L::kZeroAt, len);
        bulk_commit();
      }
    };
    Ring r;
    for (int t = b; t < n_tiles; t += G) {
      int m0, n0;
      tiles.seek(t, m0, n0);
      const int e = tiles.e;
      const int nk = kDW ? (tiles.live + BK - 1) / BK : nk_dx;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&empty[r.st], r.ph ^ 1);
        uint8_t* st = sm + r.st * L::kStage;
        mbar_expect_tx(&full[r.st], L::kStage);
        if constexpr (kDW) {   // [BK rows of k][64 columns] boxes
#pragma unroll
          for (int x = 0; x < BM / 64; ++x)
            tma_load_3d(st + x * BK * 128, &ta, &full[r.st], m0 + 64 * x,
                        kb * BK, e);
#pragma unroll
          for (int x = 0; x < BN / 64; ++x)
            tma_load_3d(st + L::kATile + x * BK * 128, &tb, &full[r.st],
                        n0 + 64 * x, kb * BK, e);
        } else {               // [rows][64 columns of k] boxes
          tma_load_3d(st, &ta, &full[r.st], kb * BK, m0, e);
          tma_load_3d(st + L::kATile, &tb, &full[r.st], kb * BK, n0, e);
        }
        r.next(kS);
        if constexpr (!kDW) zeros(++done * pieces / slabs);
      }
    }
    zeros(pieces);
    bulk_wait_read<0>();
    return;
  }

  // ---------------------------------------------------------- consumers
  setmaxnreg_inc<224>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q = lane >> 2;   // accumulator rows 16 warp + q (+ 8)
  const bool leader = (tid & 127) == 0;
  const int rows = kDW ? Din : C, cols = kDW ? Dout : Din;
  uint8_t* half = sm + L::kOutAt + wg * L::kOutHalf;
  Ring r;
  float acc[128];
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int m0, n0;
    tiles.seek(t, m0, n0);
    const int live = tiles.live;
    const int nk = kDW ? (live + BK - 1) / BK : nk_dx;
    const int mw = m0 + 64 * wg;   // this warpgroup's first output row
    const bool on = kDW || mw < live;   // dX: rows past fill skip products
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[r.st], r.ph);
      uint8_t* st = sm + r.st * L::kStage;
      if constexpr (kDW) {
        // the slab that holds fill: dy's rows at or past it to zeros (rows
        // past C came as zeros)
        const int rz = live - kb * BK;
        if (rz < BK && live < C) {
          for (int i = tid; i < BN / 64 * BK * 8; i += L::kConsumers)
            if ((i >> 3) % BK >= rz)
              reinterpret_cast<uint4*>(st + L::kATile)[i] =
                  make_uint4(0, 0, 0, 0);
          fence_proxy_async();
          bar_sync(1, L::kConsumers);
        }
      }
      if (on) {
        uint64_t da, db;
        if constexpr (kDW) {   // MN-major: B's four boxes BK rows apart
          da = desc_mn_major(st + wg * BK * 128, BK * 128);
          db = desc_mn_major(st + L::kATile, BK * 128);
        } else {               // K-major: this warpgroup's 64 rows of A
          da = desc_k_major(st + wg * 64 * 128);
          db = desc_k_major(st + L::kATile);
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // a k-step: 32 bytes along a K-major row, 16 rows (2048 bytes)
          // down an MN-major box
          const uint64_t step = kDW ? 128 * kk : 2 * kk;
          wgmma_ss<kDW, kDW>(acc, da + step, db + step);
        }
        wgmma_commit();
        // the slot is free once this warpgroup's products on it are done;
        // the other warpgroup's keep the tensor cores busy meanwhile
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[r.st]);
      } else if (lane == 0) {
        mbar_arrive(&empty[r.st]);
      }
      r.next(kS);
    }

    // epilogue: the previous tile's stores have read this half
    if (leader) bulk_wait_read<0>();
    bar_sync(2 + wg, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + q + 8 * h;   // of the warpgroup's 64
      const bool keep = kDW || mw + row < live;
      // row % 8 == q: the swizzle moves 16-byte chunk c to c ^ q
      uint8_t* rp = half + row * 128 + (lane & 3) * 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t v =
            keep ? pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]) : 0u;
        *reinterpret_cast<uint32_t*>(rp + (j >> 3) * L::kBox +
                                     (((j & 7) ^ q) << 4)) = v;
      }
    }
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if (leader && mw < rows) {
#pragma unroll
      for (int x = 0; x < BN / 64; ++x)
        if (n0 + 64 * x < cols)
          tma_store_3d(&tout, half + x * L::kBox, n0 + 64 * x, mw, tiles.e);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_read<0>();
}

template <bool kDW>
int launch_wgmma(const void* a, const void* b, const int* fill, void* out,
                 int E, int C, int Din, int Dout, cudaStream_t stream) {
  using L = Gw<kDW>;
  const int rows = kDW ? Din : C, cols = kDW ? Dout : Din;
  if (kDW ? C == 0 : Dout == 0)   // no contraction: zeros
    return (int)cudaMemsetAsync(out, 0, (size_t)E * rows * cols * 2, stream);
  CUtensorMap ta, tb, to;
  const bool ok = encode_3d(&ta, a, kDW ? Din : Dout, C, E, L::kARows) &&
                  encode_3d(&tb, b, Dout, kDW ? C : Din, E, L::kBRows) &&
                  encode_3d(&to, out, cols, rows, E, 64);
  const long long tiles = (long long)E * ((rows + L::BM - 1) / L::BM) *
                          ((cols + L::BN - 1) / L::BN);
  if (!ok || tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  // dX: every SM (its dead rows are spread over all blocks); dW: at most
  // one block a tile
  const int grid =
      kDW ? (int)std::min<long long>(tiles, sm_count()) : sm_count();
  const size_t smem = L::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      expert_bwd_wgmma<kDW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  expert_bwd_wgmma<kDW><<<grid, L::kThreads, smem, stream>>>(
      ta, tb, to, fill, static_cast<uint8_t*>(out), E, C, Din, Dout);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bf16: mma.sync
// The body of the shapes TMA cannot address: 128 x 128 tiles, 4 warps of
// 64 x 64 on mma.sync m16n8k16 from ldmatrix, slabs copied by scalar loads
// into a ring (dX 64-deep in 3 stages, dW 32-deep in 4).

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

// the same two functions as expert_bwd_wgmma, on any shape
template <class Tl, bool kDW>
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
    for (int i = tid; i < BM * BN; i += Tl::kThreads) {
      const int r = r0 + i / BN, n = n0 + i % BN;
      if (r < rows && n < cols)
        oe[(long long)r * cols + n] = from_float<bf16>(0.f);
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
      copy_chunk(as + r * L::kAStride + ac8, n > 0 ? src : ab, n, false);
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
      copy_chunk(bs + r * L::kBStride + bc8, n > 0 ? src : bb_, n, false);
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

  // the scalar copies store at once: the barriers publish each slab
  const int k_tiles = ((kDW ? live : Dout) + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kS - 1; ++s)
    if (s < k_tiles) load(s, s);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int next = kt + kS - 1;  // its stage was freed at kt - 1's end
    if (next < k_tiles) load(next, next % kS);
    __syncthreads();               // slab kt stored
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
  const int rows = kDW ? Din : C, cols = kDW ? Dout : Din;
  const dim3 grid((cols + Tl::BN - 1) / Tl::BN, (rows + Tl::BM - 1) / Tl::BM,
                  E);
  const size_t smem = Smem<Tl, kDW>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      expert_bwd_mma<Tl, kDW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  expert_bwd_mma<Tl, kDW><<<grid, Tl::kThreads, smem, stream>>>(
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

// The body a shape takes (bwd_body): fp32 the FMA body; bf16 the wgmma
// body where TMA can address every row (16-byte aligned bases, Din and
// Dout multiples of 8: the rows' byte strides multiples of 16), else the
// mma.sync body. A dispatch by shape, stated here and queried by the
// wrapper: a launch of the body chosen that fails returns its error.
enum Body { kFmaBody = 0, kMmaBody = 1, kWgmmaBody = 2, kNoBody = -1 };

int body(const void* a, const void* b, const void* out, int dtype, int Din,
         int Dout) {
  if (dtype == kFloat32) return kFmaBody;
  if (dtype != kBFloat16) return kNoBody;
  const bool tma = (reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0 &&
                   Din % 8 == 0 && Dout % 8 == 0;
  return tma ? kWgmmaBody : kMmaBody;
}

template <bool kDW>
int launch(const void* a, const void* b, const int* fill, void* out,
           int dtype, int E, int C, int Din, int Dout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body(a, b, out, dtype, Din, Dout)) {
    case kWgmmaBody:
      return launch_wgmma<kDW>(a, b, fill, out, E, C, Din, Dout, s);
    case kMmaBody:
      return launch_mma<kDW>(a, b, fill, out, E, C, Din, Dout, s);
    case kFmaBody:
      return launch_fma<kDW>(a, b, fill, out, E, C, Din, Dout, s);
  }
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

// The body that a launch with these operands (a, b, out in the order of
// the entry's arguments) takes: 0 the fp32 FMA body, 1 bf16 mma.sync, 2
// bf16 wgmma; -1 for a dtype neither entry takes.
extern "C" int expert_matmul_bwd_body(const void* a, const void* b,
                                      const void* out, int dtype, int Din,
                                      int Dout) {
  return body(a, b, out, dtype, Din, Dout);
}

// Dynamic shared memory of a body's launch (as expert_matmul_bwd_body
// numbers them) of dX (dw 0) or dW (dw 1), in bytes (the FMA body: 0,
// static only).
extern "C" int expert_matmul_bwd_smem_bytes(int body_, int dw) {
  switch (body_) {
    case kWgmmaBody:
      return (int)(dw ? Gw<true>::bytes : Gw<false>::bytes);
    case kMmaBody:
      return (int)(dw ? Smem<DwTile, true>::bytes
                      : Smem<DxTile, false>::bytes);
  }
  return 0;
}
