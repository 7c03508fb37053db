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
//  (a) bwd_dot: D[b, h, i] = sum_d dO . O in fp32, one warp a row;
//  (b) bwd_dkdv: one block per (tile of keys, b * KVH + kvh). It loops over
//      the G query heads and, for each, over the query tiles from the key
//      tile's causal start (tile 0 where the key tile lies in the prefix,
//      or without the mask), recomputing S^T = K Q^T and P^T from the LSE
//      and dP^T = V dO^T, and keeps dK and dV in fp32 registers, written
//      once: the sum over G needs no atomics;
//  (c) bwd_dq: one block per (tile of (query, grouped head) rows, b * KVH
//      + kvh), laid out as the forward: the key loop stops at the causal
//      diagonal of the block's last query, or at the prefix; dQ in fp32
//      registers, written once.
// No float atomics anywhere: two runs on the same inputs are bitwise equal.
// A masked key gets P = 0 exactly by the predicate, never through
// exp(-1e30 - LSE), so the LSE sentinel of a row with nothing visible
// (kLseEmpty) gives zero gradients.
// What bounds it on the H100: at llama3.2-1b's training shape (B 2, 4096
// tokens, 32 heads over 8, hd 64, causal) the 7 Sq * Sk * hd products of
// (b) and (c) on the tensor cores; (a) is bound by the bytes of dO and O.
// bf16 (the training path): four warps; mma.sync m16n8k16 with fp32
// accumulation, fragments by ldmatrix from shared-memory tiles padded 16
// bytes a row (kernel 1's helpers, common.cuh); P and dS are rounded to
// bf16 in registers as A operands, as FlashAttention-2 does. In (b) each
// warp owns 16 keys and holds their K and V fragments in registers; the
// query tiles (Q, dO, and the tile's LSE and D) come into two stages by
// cp.async, the next tile's copies in flight during this tile's math. In
// (c) each warp owns 16 rows and holds their Q and dO fragments; K/V tiles
// come into two stages the same way. Tiles that some row or key of the
// block sees only in part (the diagonal, the prefix's edge, ragged Sq and
// Sk) take a masked instantiation of the tile's body.
// fp32 (the checks' path): FMAs on the CUDA cores, tiles of 32 keys and 32
// rows in shared memory (the tensor cores' fp32 input type is TF32, too
// coarse for the fp32 checks), as kernel 1's fp32 body.
// Inputs and outputs are contiguous: q, o, dO, dq [B, Sq, H, hd], k, v,
// dk, dv [B, Sk, KVH, hd]; lse and D [B, H, Sq] fp32. Head dims: HD 64
// (BWD_WIDTHS below: one line a width).

#include <type_traits>

#include "common.cuh"

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
template <typename T, int HD>
__global__ void __launch_bounds__(256)
bwd_dot(const T* __restrict__ o, const T* __restrict__ dO,
        float* __restrict__ D, int rows, int Sq, int H) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* orow = o + (long long)r * HD;
  const T* drow = dO + (long long)r * HD;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) s += to_float(orow[d]) * to_float(drow[d]);
  s = warp_sum(s);
  if (lane == 0) {                     // row r is (b, i, h) -> D[b, h, i]
    const int h = r % H, bi = r / H;
    D[((long long)(bi / Sq) * H + h) * Sq + bi % Sq] = s;
  }
}

// ------------------------------------------------------------ bf16: mma
// 64 keys (b) or 64 rows (c) a block, 16 a warp; tiles of 64 queries (b)
// or 64 keys (c). Shared memory: six [64, HD] bf16 tiles, rows padded 16
// bytes: (b) K, V, then two stages of (Q, dO), then two stages of the
// query tile's LSE (times log2 e) and D; (c) Q, dO, then two stages of
// (K, V).
template <int HD>
struct MmaBwd {
  static constexpr int kTileRows = 64;
  static constexpr int kStride = HD + 8;
  static constexpr int kTile = kTileRows * kStride;
  static constexpr size_t bytes =
      6 * kTile * sizeof(__nv_bfloat16) + 4 * kTileRows * sizeof(float);
};

// a [64, HD] tile of rows src(r) (null: past the edge, zero-filled) into
// shared memory, 16-byte cp.async chunks
template <int HD, typename Src>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, Src src,
                                          const __nv_bfloat16* any) {
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int it = 0; it < MmaBwd<HD>::kTileRows * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i % kChunks * 8;
    const __nv_bfloat16* s = src(r);
    cp_async16(dst + r * MmaBwd<HD>::kStride + c, s ? s + c : any, s != nullptr);
  }
}

// acc[nt] (+)= A (16 rows: a[kk] fragments over HD) . B^T, B's 64 rows in
// shared memory as the col-major operand (row n of B is column n): S^T =
// K Q^T and dP^T = V dO^T in (b), S = Q K^T and dP = dO V^T in (c)
template <int HD>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[HD / 16][4],
                                        const __nv_bfloat16* Bs, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t bb[4][4];
#pragma unroll
    for (int np = 0; np < 4; ++np)
      ldmatrix_x4(bb[np], Bs + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                   MmaBwd<HD>::kStride +
                              kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      mma_bf16(acc[2 * np], a[kk], bb[np][0], bb[np][1]);
      mma_bf16(acc[2 * np + 1], a[kk], bb[np][2], bb[np][3]);
    }
  }
}

// out[dt] += X . B, X the 16 x 64 accumulator tile x (rounded to bf16 as
// the A operand), B [64, HD] row-major in shared memory (hence .trans):
// dV += P^T dO, dK += dS^T Q in (b), dQ += dS K in (c)
template <int HD>
__device__ __forceinline__ void mma_xb(float (&out)[HD / 8][4],
                                       const float (&x)[8][4],
                                       const __nv_bfloat16* Bs, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, Bs + (kk * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * MmaBwd<HD>::kStride +
                                dp * 16 + (lane >> 4) * 8);
      mma_bf16(out[2 * dp], xa, bb[0], bb[1]);
      mma_bf16(out[2 * dp + 1], xa, bb[2], bb[3]);
    }
  }
}

// the warp's 16 rows of a [64, HD] shared-memory tile as A fragments
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4],
                                       const __nv_bfloat16* s, int warp,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(a[kk], s + (warp * 16 + (lane & 15)) * MmaBwd<HD>::kStride +
                           kk * 16 + (lane >> 4) * 8);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ D,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
             int Sq, int Sk, int H, int KVH, int causal, int prefix_len,
             float scale_log2, float scale) {
  using bf16 = __nv_bfloat16;
  using L = MmaBwd<HD>;
  constexpr int kR = L::kTileRows;
  extern __shared__ float4 smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  float* fsm = reinterpret_cast<float*>(sm + 6 * L::kTile);
  const int G = H / KVH;
  // (b, kvh) fastest; key tile 0, which the most query tiles see under the
  // causal mask, first
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int bh = lin % gridDim.y;
  const int b = bh / KVH, kvh = bh % KVH;
  const int j0 = lin / gridDim.y * kR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // query tiles: from the key tile's causal start to Sq, for each g
  const int n_qt = (Sq + kR - 1) / kR;
  const int qt0 = causal && j0 >= prefix_len ? j0 / kR : 0;
  const int nq = max(n_qt - qt0, 0);
  const int items = G * nq;

  auto kv_row = [&](const bf16* base) {
    return [=](int r) -> const bf16* {
      return j0 + r < Sk ? base + row_off(b, Sk, j0 + r, KVH, kvh, HD)
                         : nullptr;
    };
  };
  copy_tile<HD>(sm, kv_row(k), k);
  copy_tile<HD>(sm + L::kTile, kv_row(v), v);
  auto load_item = [&](int it, int st) {
    const int g = it / nq, i0 = (qt0 + it % nq) * kR, h = kvh * G + g;
    auto q_row = [&](const bf16* base) {
      return [=](int r) -> const bf16* {
        return i0 + r < Sq ? base + row_off(b, Sq, i0 + r, H, h, HD)
                           : nullptr;
      };
    };
    copy_tile<HD>(sm + (2 + 2 * st) * L::kTile, q_row(q), q);
    copy_tile<HD>(sm + (3 + 2 * st) * L::kTile, q_row(dO), dO);
    if (tid < kR) {   // plain loads: the next barrier publishes them
      const bool ok = i0 + tid < Sq;
      const long long at = ((long long)b * H + h) * Sq + i0 + tid;
      fsm[st * 2 * kR + tid] = ok ? lse[at] * kLog2e : 0.f;
      fsm[st * 2 * kR + kR + tid] = ok ? D[at] : 0.f;
    }
  };
  if (items > 0) load_item(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t kf[HD / 16][4], vf[HD / 16][4];
  load_a<HD>(kf, sm, warp, lane);
  load_a<HD>(vf, sm + L::kTile, warp, lane);
  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[d][i] = dva[d][i] = 0.f;
  // this lane's keys: accumulator rows lane / 4 and lane / 4 + 8
  const int jw = j0 + warp * 16 + lane / 4;

  auto item = [&](int it, auto kMask) {
    const int st = it & 1;
    if (it > 0) {
      cp_async_wait<0>();   // item it landed; every warp is done with it - 1
      __syncthreads();
    }
    if (it + 1 < items) load_item(it + 1, st ^ 1);
    cp_async_commit();
    const bf16* Qs = sm + (2 + 2 * st) * L::kTile;
    const bf16* Os = sm + (3 + 2 * st) * L::kTile;
    const float* Ls = fsm + st * 2 * kR;
    const float* Ds = Ls + kR;
    const int i0 = (qt0 + it % nq) * kR;

    float s[8][4], dp[8][4];
    mma_abt<HD>(s, kf, Qs, lane);      // S^T: keys x queries
    mma_abt<HD>(dp, vf, Os, lane);     // dP^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (lane & 3) * 2 + (e & 1);
        bool ok = true;
        if constexpr (decltype(kMask)::value) {
          const int j = jw + 8 * (e >> 1), i = i0 + c;
          ok = j < Sk && i < Sq && (!causal || j <= i || j < prefix_len);
        }
        const float p = ok ? ex2(fmaf(s[nt][e], scale_log2, -Ls[c])) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - Ds[c]);
      }
    mma_xb<HD>(dva, s, Os, lane);      // dV += P^T dO
    mma_xb<HD>(dka, dp, Qs, lane);     // dK += dS^T Q
  };
  for (int it = 0; it < items; ++it) {
    const int i0 = (qt0 + it % nq) * kR;
    const bool whole = j0 + kR <= Sk && i0 + kR <= Sq &&
                       (!causal || j0 + kR - 1 <= i0 || j0 + kR <= prefix_len);
    if (whole) item(it, std::false_type{});
    else item(it, std::true_type{});
  }
  cp_async_wait<0>();   // nothing in flight at exit

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int j = jw + 8 * h2;
    if (j >= Sk) continue;
    const long long at = row_off(b, Sk, j, KVH, kvh, HD) + (lane & 3) * 2;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      *reinterpret_cast<uint32_t*>(dk + at + d * 8) =
          pack_bf16(dka[d][2 * h2] * scale, dka[d][2 * h2 + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + d * 8) =
          pack_bf16(dva[d][2 * h2], dva[d][2 * h2 + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dq_mma(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           const __nv_bfloat16* __restrict__ dO,
           const float* __restrict__ lse, const float* __restrict__ D,
           __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int KVH,
           int causal, int prefix_len, float scale_log2, float scale) {
  using bf16 = __nv_bfloat16;
  using L = MmaBwd<HD>;
  constexpr int kR = L::kTileRows;
  extern __shared__ float4 smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int G = H / KVH;
  // as the forward: (b, kvh) fastest, the longest causal row blocks first
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int bh = lin % gridDim.y;
  const int b = bh / KVH, kvh = bh % KVH;
  const int rows_total = Sq * G;
  const int r0 = (gridDim.x - 1 - lin / gridDim.y) * kR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int last_q = (min(r0 + kR, rows_total) - 1) / G;
  const int n_keys = causal ? min(Sk, max(last_q + 1, prefix_len)) : Sk;
  const int n_tiles = (n_keys + kR - 1) / kR;

  // rows (query fr / G, head kvh * G + fr % G)
  auto q_row = [&](const bf16* base) {
    return [=](int r) -> const bf16* {
      const int fr = r0 + r;
      return fr < rows_total
                 ? base + row_off(b, Sq, fr / G, H, kvh * G + fr % G, HD)
                 : nullptr;
    };
  };
  copy_tile<HD>(sm, q_row(q), q);
  copy_tile<HD>(sm + L::kTile, q_row(dO), dO);
  auto load_kv = [&](int t, int st) {
    auto kv_row = [&](const bf16* base) {
      return [=](int r) -> const bf16* {
        const int j = t * kR + r;
        return j < n_keys ? base + row_off(b, Sk, j, KVH, kvh, HD) : nullptr;
      };
    };
    copy_tile<HD>(sm + (2 + 2 * st) * L::kTile, kv_row(k), k);
    copy_tile<HD>(sm + (3 + 2 * st) * L::kTile, kv_row(v), v);
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // this lane's rows: accumulator rows lane / 4 and lane / 4 + 8; each
  // sees the keys below lim (none past the last row)
  float lse2[2], Dr[2];
  int lim[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int fr = r0 + warp * 16 + lane / 4 + 8 * h2;
    lse2[h2] = Dr[h2] = 0.f;
    lim[h2] = 0;
    if (fr < rows_total) {
      const int qp = fr / G, h = kvh * G + fr % G;
      const long long at = ((long long)b * H + h) * Sq + qp;
      lse2[h2] = lse[at] * kLog2e;
      Dr[h2] = D[at];
      lim[h2] = causal ? min(n_keys, max(qp + 1, prefix_len)) : n_keys;
    }
  }
  auto row_lim = [&](int fr) {
    return causal ? min(n_keys, max(fr / G + 1, prefix_len)) : n_keys;
  };
  const int n_whole =
      min(n_tiles, (r0 + kR <= rows_total ? row_lim(r0) : 0) / kR);

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[HD / 16][4], of[HD / 16][4];
  load_a<HD>(qf, sm, warp, lane);
  load_a<HD>(of, sm + L::kTile, warp, lane);
  float dqa[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[d][i] = 0.f;

  auto tile = [&](int t, auto kMask) {
    const int st = t & 1;
    if (t > 0) {
      cp_async_wait<0>();   // tile t landed; every warp is done with t - 1
      __syncthreads();
    }
    if (t + 1 < n_tiles) load_kv(t + 1, st ^ 1);
    cp_async_commit();
    const bf16* Ks = sm + (2 + 2 * st) * L::kTile;
    const bf16* Vs = sm + (3 + 2 * st) * L::kTile;
    float s[8][4], dp[8][4];
    mma_abt<HD>(s, qf, Ks, lane);      // S: rows x keys
    mma_abt<HD>(dp, of, Vs, lane);     // dP
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if constexpr (decltype(kMask)::value)
          ok = t * kR + nt * 8 + (lane & 3) * 2 + (e & 1) < lim[e >> 1];
        const float p =
            ok ? ex2(fmaf(s[nt][e], scale_log2, -lse2[e >> 1])) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - Dr[e >> 1]);
      }
    mma_xb<HD>(dqa, dp, Ks, lane);     // dQ += dS K
  };
  for (int t = 0; t < n_whole; ++t) tile(t, std::false_type{});
  for (int t = n_whole; t < n_tiles; ++t) tile(t, std::true_type{});
  cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int fr = r0 + warp * 16 + lane / 4 + 8 * h2;
    if (fr >= rows_total) continue;
    const long long at =
        row_off(b, Sq, fr / G, H, kvh * G + fr % G, HD) + (lane & 3) * 2;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(dq + at + d * 8) =
          pack_bf16(dqa[d][2 * h2] * scale, dqa[d][2 * h2 + 1] * scale);
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

template <typename Kern>
int set_smem(Kern kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
size_t smem_bytes() {
  if constexpr (std::is_same<T, float>::value) return FmaBwd<HD>::bytes;
  else return MmaBwd<HD>::bytes;
}

template <typename T>
constexpr int tile_rows() {
  return std::is_same<T, float>::value ? FmaBwd<64>::kN : MmaBwd<64>::kTileRows;
}

template <typename T, int HD>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dO,
                const float* lse, const float* D, void* dk, void* dv, int B,
                int Sq, int Sk, int H, int KVH, int causal, int prefix_len,
                float scale, cudaStream_t stream) {
  const dim3 grid((Sk + tile_rows<T>() - 1) / tile_rows<T>(), B * KVH);
  const size_t smem = smem_bytes<T, HD>();
  if constexpr (std::is_same<T, float>::value) {
    int e = set_smem(bwd_dkdv_fma<HD>, smem);
    if (e) return e;
    bwd_dkdv_fma<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dO), lse, D,
        static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, KVH,
        causal, prefix_len, scale);
  } else {
    int e = set_smem(bwd_dkdv_mma<HD>, smem);
    if (e) return e;
    bwd_dkdv_mma<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dO), lse, D,
        static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KVH, causal,
        prefix_len, scale * kLog2e, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* D, void* dq, int B, int Sq,
              int Sk, int H, int KVH, int causal, int prefix_len, float scale,
              cudaStream_t stream) {
  const int rows = Sq * (H / KVH);
  const dim3 grid((rows + tile_rows<T>() - 1) / tile_rows<T>(), B * KVH);
  const size_t smem = smem_bytes<T, HD>();
  if constexpr (std::is_same<T, float>::value) {
    int e = set_smem(bwd_dq_fma<HD>, smem);
    if (e) return e;
    bwd_dq_fma<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dO), lse, D,
        static_cast<float*>(dq), Sq, Sk, H, KVH, causal, prefix_len, scale);
  } else {
    int e = set_smem(bwd_dq_mma<HD>, smem);
    if (e) return e;
    bwd_dq_mma<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dO), lse, D,
        static_cast<T*>(dq), Sq, Sk, H, KVH, causal, prefix_len,
        scale * kLog2e, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The head dims the backward is built for, one line a width.
#define BWD_WIDTHS(X) X(64)

// Every entry takes contiguous tensors (see the header) and returns the
// cudaError_t of its launch (0 on success); a width or dtype it was not
// built for gives cudaErrorInvalidValue. An empty grid launches nothing.

// (a) D [B, H, Sq] = sum over the head dim of dO * O.
extern "C" int flash_attention_bwd_dot(const void* o, const void* dO, void* D,
                                       int dtype, int hd, int B, int Sq,
                                       int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * Sq * H;
  const dim3 grid((rows + 7) / 8);
#define BWD_DOT(HD)                                                          \
  if (hd == HD) {                                                           \
    if (dtype == kBFloat16)                                                 \
      bwd_dot<__nv_bfloat16, HD><<<grid, 256, 0, s>>>(                      \
          static_cast<const __nv_bfloat16*>(o),                             \
          static_cast<const __nv_bfloat16*>(dO), static_cast<float*>(D),    \
          rows, Sq, H);                                                     \
    else if (dtype == kFloat32)                                             \
      bwd_dot<float, HD><<<grid, 256, 0, s>>>(                              \
          static_cast<const float*>(o), static_cast<const float*>(dO),      \
          static_cast<float*>(D), rows, Sq, H);                             \
    else                                                                    \
      return (int)cudaErrorInvalidValue;                                    \
    return (int)cudaGetLastError();                                         \
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
// bytes (the two share a layout size); 0 for one not built.
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
