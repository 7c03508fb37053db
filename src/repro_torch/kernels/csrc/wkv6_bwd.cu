// Backward of the chunked RWKV6 (WKV6) recurrence for Hopper (sm_90a):
// kernel 7-bwd.
//
// No TPU kernel computes it: the reference differentiates its chunked
// scan (repro/models/rwkv6.py:wkv6_chunked) in XLA. The forward is
// csrc/wkv6.cu (kernel 7), which saves the state at each chunk's start.
// Per (batch b, head h), with the forward's chunk of kChunk = 32 tokens,
// c the inclusive cumsum of logw inside the chunk, c_prev = c - logw and
// c_L its last row:
//   A  = r e^{c_prev},  Bm = k e^{-c},  Kd = k e^{c_L - c},
//   P[t, j] = A_t . Bm_j (j < t), r_t . (u k_t) (j = t),
//   out_t = sum_{j <= t} P[t, j] v_j + A_t S0,
//   S1    = e^{c_L} S0 + Kd^T v.
// Given dout and dS (the gradient of S1; the final state's gradient for
// the last chunk), with dP[t, j] = dout_t . v_j (j < t), dd_t = dout_t .
// v_t:
//   dv_t  = sum_{s >= t} P[s, t] dout_s + Kd_t dS
//   dA_t  = sum_{j < t} dP[t, j] Bm_j + S0 dout_t
//   dBm_j = sum_{t > j} dP[t, j] A_t
//   dKd_t = dS v_t
//   dr_t  = dA_t e^{c_prev_t} + dd_t u k_t
//   dk_t  = dBm_t e^{-c_t} + dKd_t e^{c_L - c_t} + dd_t u r_t
//   du   += dd_t r_t k_t
//   dlogw_s = sum_{t >= s} x_t + sum_{t > s} y_t + dc_L, where
//     x_t = -(dBm_t Bm_t + dKd_t Kd_t), y_t = dA_t A_t,
//     dc_L = sum_t dKd_t Kd_t + e^{c_L} rowsum(dS * S0)
//   dS   <- e^{c_L} dS + A^T dout   (the previous chunk's; at the first
//           chunk, dstate0)
// ref.wkv6_bwd_ds_ref (the dS pass) and ref.wkv6_chunked_bwd_ref (the
// whole) are the plain versions, the same formulas.
//
// The design. Only dS runs in sequence, and e^{c_L} scales whole rows of
// it, so its recurrence is independent across its elements; given S0 (the
// forward's chunk states) and dS at a chunk's end, every other output is
// local to the chunk. Four kernels on the caller's stream, in order:
//  1. wkv6_bwd_local, a block of 256 threads per (b, chunk i, h), four
//     blocks an SM: the chunk's A^T dout into the scratch slot of chunk
//     i - 1's end (chunk 0's into dstate0), and e^{c_L};
//  2. wkv6_bwd_scan, a thread per 4 elements of a (b, h) state: the
//     elementwise reverse scan dS_{i-1} = e^{c_L,i} dS_i + (A^T dout)_i
//     over the slots, in place, from the final state's gradient; then
//     dstate0. Its loads do not depend on the carry, so 8 chunks' are in
//     flight at once;
//  3. wkv6_bwd_chunk, a block of 256 threads per (b, chunk i, h), two
//     blocks an SM (~109 KB of shared memory at hd 64): the chunk's
//     inputs, S0 and dS into shared memory; the decayed operands from
//     E = e^c (one expf an element, the other factors as E of the token
//     before and correctly rounded reciprocals); P and dP (six warps, a
//     band of two tiles each); dv and dA (-> dv, dr) in one group of four
//     warps and dBm and dKd (-> dk) in the other, a warp one m16 tile by
//     half the channels; dlogw's reverse scan within the chunk (segment
//     sums, then suffixes); du's partial for the chunk;
//  4. wkv6_bwd_du: du's partials summed over the chunks in chunk order.
// 4096 blocks at rwkv6-1.6b's training microbatch (B 1, 4096 tokens, 32
// heads) where one block a (b, h) gave 32. Every product (P, dP, the
// within-chunk sums, S0 dout, dS v, Kd dS, A^T dout) runs on the tensor
// cores as 3xTF32 MMAs (tf32.cuh; a bf16 v is exact and takes two). The
// tiles are fp32 rows whose columns are XOR-swizzled by row (swz), so
// that the fragment loads of every product, row-major and transposed
// alike, are free of bank conflicts without padding. No float atomics,
// and every sum in a fixed order that depends on neither B nor the grid,
// so a row's bits do not depend on B and two runs are equal. du leaves as
// per-(b, h) partials [B, H, hd], summed by the caller. A ragged last
// chunk is padded with r = k = v = dout = 0 and logw = 0 (which leaves
// c_L as it is); its padded rows are not written.
//
// Why the dS pass is a chunk-parallel pass and a scan, not one serial walk
// a block per (b, h, slice of value columns) with dS in registers: each
// such block needs the whole chunk's A (a cumsum and an expf an element),
// so the mma's smallest slice of 8 columns computes A 8 times over (~67 M
// expf at that microbatch), and a slice of all 64 columns leaves 32
// blocks each walking 128 chunks in series. The split costs the scratch's
// bytes instead: written, read and written by the scan, read again.
//
// The scratch, from the caller: the dS at each chunk's end [B, n_chunks,
// H, hd, hd] fp32 (67 MB at that microbatch), e^{c_L} and du's per-chunk
// partials [B, n_chunks, H, hd] fp32 each.
//
// What bounds it on the H100: the function's bytes. It reads r/k/v,
// logw, dout and the chunk states and writes dr/dk/dv, dlogw, du and
// dstate0: ~269 MB at that microbatch, 0.080 ms at 3.35 TB/s, while its
// ~5.65 GFLOP of products take 0.034 ms as 3xTF32 (three TF32 MMAs at 495
// TFLOP/s). The passes move ~540 MB in all with the scratch, and the
// chunk pass, ~70 % of the time, is bound by issuing instructions: the
// splits of the operands (five integer and float operations an element a
// fragment) beside the MMAs, with two blocks an SM to overlap one block's
// loads with the other's products.

#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"

using namespace rt;

namespace {

constexpr int kChunk = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 128;
constexpr int kScanUnroll = 8;  // chunks whose loads are in flight at once
constexpr int kDuParts = 8;     // lanes that share one du sum

// the passes of the C interface, as bits
constexpr int kPassLocal = 1, kPassScan = 2, kPassChunk = 4, kPassDu = 8;

// Tiles in shared memory are fp32 rows of kLD(HD) floats (at least 32),
// and the float at (row, col) sits at column col ^ swz(row): 8 (row & 3)
// + 4 (row >> 2 & 1) permutes the 16-byte groups of each 32 floats. An
// mma.sync fragment reads 8 rows x 4 columns (a row-major operand) or 4
// rows x 8 columns (a transposed one); both land in 32 distinct banks.
// 16-byte groups stay whole, for float4 and cp.async.
template <int HD>
constexpr int kLD = HD < 32 ? 32 : HD;

__device__ __forceinline__ int swz(int row) {
  return ((row & 3) << 3) | (row & 4);
}
template <int LD>
__device__ __forceinline__ int at(int row, int col) {
  return row * LD + (col ^ swz(row));
}

// rows [0, ROWS) of a slab (row t at src + t * stride, COLS floats) into a
// swizzled tile as 16-byte parts, rows >= n zero: cp.async when vec (the
// caller commits and waits), else scalar loads stored at once
template <int LD, int ROWS, int COLS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long stride, int n,
                                          bool vec) {
  constexpr int kParts = COLS / 4;
  for (int e = threadIdx.x; e < ROWS * kParts; e += kThreads) {
    const int t = e / kParts, c = (e % kParts) * 4;
    const bool ok = t < n;
    float* d = dst + at<LD>(t, c);
    const float* s = src + t * stride + c;
    if (vec) {
      cp_async16(d, ok ? s : src, ok);
    } else {
      *reinterpret_cast<float4*>(d) =
          ok ? make_float4(s[0], s[1], s[2], s[3])
             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// a chunk's rows of NA bf16 slabs into fp32 tiles, 8 elements a part:
// every load of a thread issued before its first store
template <int HD, int NA>
__device__ __forceinline__ void stage_bf16(
    float* const (&dst)[NA], const __nv_bfloat16* const (&src)[NA],
    long long stride, int n, bool vec) {
  constexpr int kParts = HD / 8, kAll = kChunk * kParts;
  constexpr int kIt = (kAll + kThreads - 1) / kThreads;
  float x[NA][kIt][8];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int t = e / kParts, c = (e % kParts) * 8;
    const bool ok = e < kAll && t < n;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const __nv_bfloat16* s = src[a] + t * stride + c;
      if (ok && vec) {
        load_vec<8>(s, x[a][it]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) x[a][it][j] = ok ? to_float(s[j]) : 0.f;
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int e = threadIdx.x + it * kThreads;
    if (e >= kAll) break;
    const int t = e / kParts, c = (e % kParts) * 8;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const float* y = x[a][it];
      *reinterpret_cast<float4*>(dst[a] + at<kLD<HD>>(t, c)) =
          make_float4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<float4*>(dst[a] + at<kLD<HD>>(t, c + 4)) =
          make_float4(y[4], y[5], y[6], y[7]);
    }
  }
}

// r/k/v-like slabs of type T (fp32 or bf16) into fp32 tiles
template <typename T, int HD, int NA>
__device__ __forceinline__ void stage_tok(float* const (&dst)[NA],
                                          const T* const (&src)[NA],
                                          long long stride, int n,
                                          bool vec) {
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
      stage_f32<kLD<HD>, kChunk, HD>(dst[a], src[a], stride, n, vec);
  } else {
    stage_bf16<HD, NA>(dst, src, stride, n, vec);
  }
}

// column d's inclusive cumsum of logw over the chunk, in token order: at
// the tokens of segment seg (cs), before them (before), and at the
// chunk's end (returned)
template <int HD, int L>
__device__ __forceinline__ float col_cumsum(const float* W, int d, int seg,
                                            float (&cs)[L], float& before) {
  float c = 0.f;
  int t = 0;
  for (; t < seg * L; ++t) c += W[at<kLD<HD>>(t, d)];
  before = c;
#pragma unroll
  for (int e = 0; e < L; ++e, ++t) cs[e] = c += W[at<kLD<HD>>(t, d)];
  for (; t < kChunk; ++t) c += W[at<kLD<HD>>(t, d)];
  return c;
}

// hi/lo[q] += sum over k-steps [k0, k1) of a(m0 + row, 8 ks + col) b(8 ks
// + kk, n0 + 8 q + col): one m16 tile against NQ n8 tiles, 3xTF32
template <int NQ, bool kExactA, bool kExactB, typename FA, typename FB>
__device__ __forceinline__ void chain(float (&hi)[NQ][4], float (&lo)[NQ][4],
                                      FA a, FB b, int m0, int n0, int k0,
                                      int k1, int fg, int ft) {
  for (int ks = k0; ks < k1; ++ks) {
    const FragA fa = frag_a(
        [&](int row, int col) { return a(m0 + row, 8 * ks + col); }, fg, ft);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int nn = n0 + 8 * q + fg;
      const FragB fb = frag_b(b(8 * ks + ft, nn), b(8 * ks + ft + 4, nn));
      mma3<kExactB, kExactA>(hi[q], lo[q], fa, fb);
    }
  }
}

template <int NQ>
__device__ __forceinline__ void zero(float (&hi)[NQ][4], float (&lo)[NQ][4]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) hi[q][e] = lo[q][e] = 0.f;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------- 1. local
// (A^T dout) of chunk i into ds_end's slot i - 1 (chunk 0's into dstate0),
// e^{c_L} into ecl. Tiles: r (then A), logw, dout.
template <int HD>
struct LocalLayout {
  static constexpr int kTok = kChunk * kLD<HD>;
  static constexpr int a = 0, w = a + kTok, dout = w + kTok,
                       bytes = (dout + kTok) * 4;
};

// four blocks an SM (at most 64 registers a thread): the pass moves
// bytes, and more blocks keep more of them in flight
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 4)
wkv6_bwd_local(const T* __restrict__ r, const float* __restrict__ logw,
               const float* __restrict__ dout, float* __restrict__ ds_end,
               float* __restrict__ ecl, float* __restrict__ dstate0, int S,
               int H, int vec) {
  using L = LocalLayout<HD>;
  constexpr int LD = kLD<HD>;
  constexpr int kSegs = kThreads / HD, kSegLen = kChunk / kSegs;
  constexpr int kMT = HD / 16, kNT = HD / 8;
  constexpr int kNL = kMT * kNT >= kWarps ? kMT * kNT / kWarps : 1;
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float *A = sm + L::a, *W = sm + L::w, *DO = sm + L::dout;

  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int h = blockIdx.x % H, bi = blockIdx.x / H;  // bi = b n + i
  const int i = bi % n_chunks, b = bi / n_chunks;
  const int n = min(kChunk, S - i * kChunk);
  const long long tok = (long long)H * HD;
  const long long base = (((long long)b * S + i * kChunk) * H + h) * HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  {
    float* const dst[1] = {A};
    const T* const src[1] = {r + base};
    stage_f32<LD, kChunk, HD>(W, logw + base, tok, n, vec);
    stage_f32<LD, kChunk, HD>(DO, dout + base, tok, n, vec);
    stage_tok<T, HD, 1>(dst, src, tok, n, vec);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  {  // A = r e^{c_prev} in place; thread (d, seg) owns its tokens of column d
    const int d = tid % HD, seg = tid / HD;
    float cs[kSegLen], before;
    const float cl = col_cumsum<HD>(W, d, seg, cs, before);
#pragma unroll
    for (int e = 0; e < kSegLen; ++e) {
      const int s = at<LD>(seg * kSegLen + e, d);
      A[s] *= expf(e == 0 ? before : cs[e - 1]);
    }
    if (seg == 0) ecl[((long long)bi * H + h) * HD + d] = expf(cl);
  }
  __syncthreads();
  // M[m, n] = sum_t A[t, m] dout[t, n]: warp w takes m-tile w % kMT and
  // kNL n-tiles
  const int mt = warp % kMT, nt0 = (warp / kMT) * kNL;
  if (nt0 >= kNT) return;
  const int fg = lane / 4, ft = lane % 4;
  float hi[kNL][4], lo[kNL][4];
  zero(hi, lo);
  chain<kNL, false, false>(
      hi, lo, [&](int m, int kk) { return A[at<LD>(kk, m)]; },
      [&](int kk, int nn) { return DO[at<LD>(kk, nn)]; }, 16 * mt, 8 * nt0, 0,
      kChunk / 8, fg, ft);
  float* dst = i > 0 ? ds_end + (((long long)bi - 1) * H + h) * HD * HD
                     : dstate0 + ((long long)b * H + h) * HD * HD;
#pragma unroll
  for (int q = 0; q < kNL; ++q)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      store2(dst + (16 * mt + fg + 8 * hf) * HD + 8 * (nt0 + q) + 2 * ft,
             hi[q][2 * hf] + lo[q][2 * hf],
             hi[q][2 * hf + 1] + lo[q][2 * hf + 1]);
}

// -------------------------------------------------------------- 2. scan
// dS at each chunk's end, in place over ds_end (slot j: chunk j + 1's A^T
// dout on entry, dS at chunk j's end on exit); then dstate0.
template <int HD>
__global__ void __launch_bounds__(kScanThreads)
wkv6_bwd_scan(float* __restrict__ ds_end, const float* __restrict__ ecl,
              const float* __restrict__ dstate, float* __restrict__ dstate0,
              int B, int n_chunks, int H) {
  constexpr int kQ = HD * HD / 4;  // float4s of a state
  const long long e = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  if (e >= (long long)B * H * kQ) return;
  const int q = e % kQ, row = q / (HD / 4);
  const long long bh = e / kQ, b = bh / H;
  const int h = bh % H;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  if (dstate) {
    const float* s = dstate + bh * HD * HD + 4 * q;
    carry = make_float4(s[0], s[1], s[2], s[3]);
  }
  auto slot = [&](int j) {
    return reinterpret_cast<float4*>(
               ds_end + ((b * n_chunks + j) * H + h) * HD * HD) + q;
  };
  auto decay = [&](int j) {
    return ecl[((b * n_chunks + j) * H + h) * HD + row];
  };
  auto step = [](float e, float4 c, float4 m) {
    return make_float4(fmaf(e, c.x, m.x), fmaf(e, c.y, m.y),
                       fmaf(e, c.z, m.z), fmaf(e, c.w, m.w));
  };
  float4* d0 = reinterpret_cast<float4*>(dstate0 + bh * HD * HD) + q;
  if (n_chunks == 0) {
    *d0 = carry;
    return;
  }
  *slot(n_chunks - 1) = carry;
  for (int j0 = n_chunks - 1; j0 >= 1; j0 -= kScanUnroll) {
    float4 m[kScanUnroll];
    float ev[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u)
      if (j0 - u >= 1) {
        m[u] = *slot(j0 - u - 1);
        ev[u] = decay(j0 - u);
      }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u)
      if (j0 - u >= 1) {
        carry = step(ev[u], carry, m[u]);
        *slot(j0 - u - 1) = carry;
      }
  }
  *d0 = step(decay(0), carry, *d0);
}

// ------------------------------------------------------------- 3. chunk
// Tiles: r, k, v, dout (then x, y over dout and v), c (logw, then e^c of
// its cumsum), A, Bm, Kd; S0, dS; P, dP; then the per-token and
// per-column vectors.
template <int HD>
struct ChunkLayout {
  static constexpr int kTok = kChunk * kLD<HD>, kSq = HD * kLD<HD>;
  static constexpr int kPair = kChunk * kChunk;
  static constexpr int kSegs = kThreads / HD;
  static constexpr int r = 0, k = r + kTok, v = k + kTok, dout = v + kTok,
                       c = dout + kTok, a = c + kTok, bm = a + kTok,
                       kd = bm + kTok, s0 = kd + kTok, ds = s0 + kSq,
                       p = ds + kSq, dp = p + kPair, dd = dp + kPair,
                       bonus = dd + kChunk, u = bonus + kChunk, ecl = u + HD,
                       rs = ecl + HD, dcl = rs + HD, segx = dcl + 2 * HD,
                       segy = segx + kSegs * HD, segu = segy + kSegs * HD,
                       bytes = (segu + kSegs * HD) * 4;
};

// two blocks an SM (at most 128 registers a thread, ~109 KB of shared
// memory each at hd 64)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_chunk(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, const float* __restrict__ states,
               const float* __restrict__ ds_end,
               const float* __restrict__ dout, T* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dlogw, float* __restrict__ du_chunk, int S,
               int H, int vec) {
  using L = ChunkLayout<HD>;
  constexpr int LD = kLD<HD>;
  constexpr bool kExactV = sizeof(T) == 2;  // bf16 v is exact in TF32
  constexpr int kSegs = L::kSegs, kSegLen = kChunk / kSegs;
  constexpr int kNT = HD / 8;   // n8 tiles of a channel row
  constexpr int kNQ = kNT / 2;  // n-tiles a warp of phase 4 takes
  constexpr int kTR = kThreads / HD;  // threads a row of dS * S0
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float *R = sm + L::r, *K = sm + L::k, *V = sm + L::v, *DO = sm + L::dout,
        *C = sm + L::c, *A = sm + L::a, *Bm = sm + L::bm, *Kd = sm + L::kd,
        *S0 = sm + L::s0, *DS = sm + L::ds, *P = sm + L::p, *DP = sm + L::dp,
        *DD = sm + L::dd, *BON = sm + L::bonus, *U = sm + L::u,
        *ECL = sm + L::ecl, *RS = sm + L::rs, *DCL = sm + L::dcl,
        *SGX = sm + L::segx, *SGY = sm + L::segy, *SGU = sm + L::segu;
  float *X = DO, *Y = V;  // x and y, once the products are done

  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int h = blockIdx.x % H, bi = blockIdx.x / H;  // bi = b n + i
  const int i = bi % n_chunks, b = bi / n_chunks;
  const int n = min(kChunk, S - i * kChunk);
  const long long tok = (long long)H * HD;
  const long long base = (((long long)b * S + i * kChunk) * H + h) * HD;
  const long long sq = ((long long)bi * H + h) * HD * HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4;
  const int d = tid % HD, seg = tid / HD;

  // ---- 1. the chunk's inputs, S0 and dS at its end, u
  {
    float* const dst[3] = {R, K, V};
    const T* const src[3] = {r + base, k + base, v + base};
    stage_f32<LD, kChunk, HD>(C, logw + base, tok, n, vec);
    stage_f32<LD, kChunk, HD>(DO, dout + base, tok, n, vec);
    stage_f32<LD, HD, HD>(S0, states + sq, HD, HD, vec);
    stage_f32<LD, HD, HD>(DS, ds_end + sq, HD, HD, true);
    stage_tok<T, HD, 3>(dst, src, tok, n, vec);
    if (tid < HD) U[tid] = u[h * HD + tid];
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  // ---- 2. the decayed operands (thread (d, seg)) from E = e^c, one expf
  // an element: e^{c_prev} is the previous token's E, e^{-c} = 1 / E and
  // e^{c_L - c} = e^{c_L} / E (each reciprocal correctly rounded); the
  // bonus r.(u k) and dd = dout.v (a warp a token, summed by shuffles);
  // rowsum(dS * S0)
  {
    float cs[kSegLen], before;
    const float cl = col_cumsum<HD>(C, d, seg, cs, before);
#pragma unroll
    for (int q = 0; q < kChunk / kWarps; ++q) {
      const int t = warp * (kChunk / kWarps) + q;
      float pb = 0.f, pd = 0.f;
      for (int c = lane; c < HD; c += 32) {
        const int s = at<LD>(t, c);
        pb = fmaf(R[s] * U[c], K[s], pb);
        pd = fmaf(DO[s], V[s], pd);
      }
      pb = warp_sum(pb);
      pd = warp_sum(pd);
      if (lane == 0) BON[t] = pb, DD[t] = pd;
    }
    {
      const int row = tid / kTR, part = tid % kTR;
      float s = 0.f;
      for (int c = part; c < HD; c += kTR)
        s = fmaf(DS[at<LD>(row, c)], S0[at<LD>(row, c)], s);
#pragma unroll
      for (int off = 1; off < kTR; off <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (part == 0) RS[row] = s;
    }
    __syncthreads();  // every logw is read before e^c replaces it
    const float el = expf(cl);
    float ep = expf(before);
#pragma unroll
    for (int e = 0; e < kSegLen; ++e) {
      const int s = at<LD>(seg * kSegLen + e, d);
      const float ec = expf(cs[e]), inv = __frcp_rn(ec);
      C[s] = ec;
      A[s] = R[s] * ep;
      Bm[s] = K[s] * inv;
      Kd[s] = K[s] * (el * inv);
      ep = ec;
    }
    if (seg == 0) ECL[d] = el;
  }
  __syncthreads();

  // ---- 3. P = A Bm^T and dP = dout v^T below the diagonal (P's diagonal
  // the bonus, dP's zero): a warp each takes one of the three bands of two
  // m16 x n8 tiles at or below it, (0, 0-1), (1, 0-1), (1, 2-3), of P
  // (warps 0-2) or dP (3-5); tiles above it are never read
  if (warp < 6) {
    const bool isp = warp < 3;
    const int band = warp % 3;
    const int mt = band == 0 ? 0 : 1, nt0 = band == 2 ? 2 : 0;
    float hi[2][4], lo[2][4];
    zero(hi, lo);
    if (isp)
      chain<2, false, false>(
          hi, lo, [&](int m, int kk) { return A[at<LD>(m, kk)]; },
          [&](int kk, int nn) { return Bm[at<LD>(nn, kk)]; }, 16 * mt,
          8 * nt0, 0, HD / 8, fg, ft);
    else
      chain<2, false, kExactV>(
          hi, lo, [&](int m, int kk) { return DO[at<LD>(m, kk)]; },
          [&](int kk, int nn) { return V[at<LD>(nn, kk)]; }, 16 * mt,
          8 * nt0, 0, HD / 8, fg, ft);
    float* out = isp ? P : DP;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = 16 * mt + fg + 8 * hf, j = 8 * (nt0 + q) + 2 * ft;
        float x[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          x[cc] = j + cc < t    ? hi[q][2 * hf + cc] + lo[q][2 * hf + cc]
                  : j + cc == t && isp ? BON[t]
                                       : 0.f;
        store2(out + at<kChunk>(t, j), x[0], x[1]);
      }
  }
  __syncthreads();

  // ---- 4. the per-token gradients, each product one 3xTF32 chain in a
  // fixed order, from two groups of four warps: warp (group, nh, mt)
  // takes m-tile mt (tokens) and half nh of the channels (kNQ n-tiles);
  // the first group dv and dA (-> dv, dr, y), the second dBm and dKd (->
  // dk, x, dc_L's partials); dv, dr and dk leave from the registers
  const bool second = warp >= 4;
  const int mt = warp & 1, nt0 = ((warp >> 1) & 1) * kNQ;
  const int m0 = 16 * mt, n0 = 8 * nt0;
  float xy[kNQ][4], dclp[kNQ][2];  // y (first group) or x (second)
  auto row_of = [&](int e) { return m0 + fg + 8 * (e >> 1); };
  auto col_of = [&](int q, int e) { return n0 + 8 * q + 2 * ft + (e & 1); };
  auto gout = [&](int t, int col) { return base + t * tok + col; };
  {
    float hi[kNQ][4], lo[kNQ][4];
    if (!second) {
      // dv = P^T dout + Kd dS
      zero(hi, lo);
      chain<kNQ, false, false>(
          hi, lo, [&](int m, int kk) { return P[at<kChunk>(kk, m)]; },
          [&](int kk, int nn) { return DO[at<LD>(kk, nn)]; }, m0, n0, 2 * mt,
          kChunk / 8, fg, ft);
      chain<kNQ, false, false>(
          hi, lo, [&](int m, int kk) { return Kd[at<LD>(m, kk)]; },
          [&](int kk, int nn) { return DS[at<LD>(kk, nn)]; }, m0, n0, 0,
          HD / 8, fg, ft);
#pragma unroll
      for (int q = 0; q < kNQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          if (row_of(e) < n)
            store2(dv + gout(row_of(e), col_of(q, e)), hi[q][e] + lo[q][e],
                   hi[q][e + 1] + lo[q][e + 1]);
      // dA = dP Bm + dout S0^T -> dr, y
      zero(hi, lo);
      chain<kNQ, false, false>(
          hi, lo, [&](int m, int kk) { return DP[at<kChunk>(m, kk)]; },
          [&](int kk, int nn) { return Bm[at<LD>(kk, nn)]; }, m0, n0, 0,
          2 * mt + 2, fg, ft);
      chain<kNQ, false, false>(
          hi, lo, [&](int m, int kk) { return DO[at<LD>(m, kk)]; },
          [&](int kk, int nn) { return S0[at<LD>(nn, kk)]; }, m0, n0, 0,
          HD / 8, fg, ft);
#pragma unroll
      for (int q = 0; q < kNQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int t = row_of(e);
          float g[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = col_of(q, e + cc), s = at<LD>(t, col);
            const float ga = hi[q][e + cc] + lo[q][e + cc];
            const float ecp = t == 0 ? 1.f : C[at<LD>(t - 1, col)];
            xy[q][e + cc] = ga * A[s];
            g[cc] = fmaf(ga, ecp, DD[t] * U[col] * K[s]);
          }
          if (t < n) store2(dr + gout(t, col_of(q, e)), g[0], g[1]);
        }
    } else {
      // dBm = dP^T A, then dKd = v dS^T -> dk, x, dc_L's partial
      float gb[kNQ][4];
      zero(hi, lo);
      chain<kNQ, false, false>(
          hi, lo, [&](int m, int kk) { return DP[at<kChunk>(kk, m)]; },
          [&](int kk, int nn) { return A[at<LD>(kk, nn)]; }, m0, n0, 2 * mt,
          kChunk / 8, fg, ft);
#pragma unroll
      for (int q = 0; q < kNQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) gb[q][e] = hi[q][e] + lo[q][e];
      zero(hi, lo);
      chain<kNQ, kExactV, false>(
          hi, lo, [&](int m, int kk) { return V[at<LD>(m, kk)]; },
          [&](int kk, int nn) { return DS[at<LD>(nn, kk)]; }, m0, n0, 0,
          HD / 8, fg, ft);
#pragma unroll
      for (int q = 0; q < kNQ; ++q) {
        dclp[q][0] = dclp[q][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int t = row_of(e);
          float g[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = col_of(q, e + cc), s = at<LD>(t, col);
            const float gk = hi[q][e + cc] + lo[q][e + cc];
            const float inv = __frcp_rn(C[s]);
            xy[q][e + cc] = -(gb[q][e + cc] * Bm[s] + gk * Kd[s]);
            dclp[q][cc] = fmaf(gk, Kd[s], dclp[q][cc]);
            g[cc] = gb[q][e + cc] * inv + gk * (ECL[col] * inv) +
                    DD[t] * U[col] * R[s];
          }
          if (t < n) store2(dk + gout(t, col_of(q, e)), g[0], g[1]);
        }
        // over the 8 row pairs of the m-tile (lanes fg), a fixed tree
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            dclp[q][cc] += __shfl_xor_sync(0xffffffffu, dclp[q][cc], off);
      }
    }
  }
  __syncthreads();  // every product has read dout and v
  {
    float* XY = second ? X : Y;
#pragma unroll
    for (int q = 0; q < kNQ; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        XY[at<LD>(row_of(e), col_of(q, e))] = xy[q][e];
      if (second && fg == 0) {
        DCL[mt * HD + col_of(q, 0)] = dclp[q][0];
        DCL[mt * HD + col_of(q, 1)] = dclp[q][1];
      }
    }
  }
  __syncthreads();

  // ---- 5. dlogw_s = sum_{t >= s} x_t + sum_{t > s} y_t + dc_L down column
  // d: thread (d, seg) sums its segment, then walks it from the sums of
  // the segments after it; du's partial over the chunk
  {
    float sx = 0.f, sy = 0.f, su = 0.f;
#pragma unroll
    for (int e = 0; e < kSegLen; ++e) {
      const int t = seg * kSegLen + e, s = at<LD>(t, d);
      sx += X[s];
      sy += Y[s];
      su = fmaf(DD[t], R[s] * K[s], su);
    }
    SGX[seg * HD + d] = sx;
    SGY[seg * HD + d] = sy;
    SGU[seg * HD + d] = su;
  }
  __syncthreads();
  {
    float ax = 0.f, ay = 0.f;
    for (int g = kSegs - 1; g > seg; --g) {
      ax += SGX[g * HD + d];
      ay += SGY[g * HD + d];
    }
    const float dcl = fmaf(ECL[d], RS[d], DCL[d] + DCL[HD + d]);
#pragma unroll
    for (int e = kSegLen - 1; e >= 0; --e) {
      const int t = seg * kSegLen + e, s = at<LD>(t, d);
      ax += X[s];
      if (t < n) dlogw[base + t * tok + d] = ax + ay + dcl;
      ay += Y[s];
    }
    if (seg == 0) {
      float s = 0.f;
      for (int g = 0; g < kSegs; ++g) s += SGU[g * HD + d];
      du_chunk[((long long)bi * H + h) * HD + d] = s;
    }
  }
}

// ---------------------------------------------------------------- 4. du
// du_part[b, h, d] = sum over the chunks of du_chunk[b, i, h, d]: kDuParts
// lanes a sum, each over a run of chunks in order, then a fixed tree
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_du(const float* __restrict__ du_chunk, float* __restrict__ du_part,
            int B, int n_chunks, int H, int HD) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long o = e / kDuParts;  // (b, h, d)
  const int part = e % kDuParts;
  const int per = (n_chunks + kDuParts - 1) / kDuParts;
  float s = 0.f;
  if (o < (long long)B * H * HD) {
    const int dd = o % HD, h = (o / HD) % H;
    const long long b = o / HD / H;
    const int i0 = part * per, i1 = min(n_chunks, i0 + per);
#pragma unroll 8
    for (int i = i0; i < i1; ++i)
      s += du_chunk[((b * n_chunks + i) * H + h) * HD + dd];
  }
#pragma unroll
  for (int off = 1; off < kDuParts; off <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (part == 0 && o < (long long)B * H * HD) du_part[o] = s;
}

struct Args {
  const void *r, *k, *v;
  const float *logw, *u, *states, *dout, *dstate;
  void *dr, *dk, *dv;
  float *dlogw, *du_part, *dstate0, *scratch;
  int passes, B, S, H;
  cudaStream_t stream;
};

template <typename T, int HD>
int smem_of(int pass) {
  return pass == kPassLocal   ? LocalLayout<HD>::bytes
         : pass == kPassChunk ? ChunkLayout<HD>::bytes
                              : 0;
}

// a launch's dynamic shared memory, from the largest carveout
template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// blocks of a pass resident on one SM at once
template <typename K>
int occupancy(K kern, int threads, int bytes) {
  int n = 0;
  if (allow_smem(kern, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads,
                                                    bytes) != cudaSuccess)
    return -1;
  return n;
}

template <typename T, int HD>
int run(const Args& a) {
  const int n_chunks = (a.S + kChunk - 1) / kChunk;
  const long long blocks = (long long)a.B * n_chunks * a.H;
  float* ds_end = a.scratch;
  float* ecl = ds_end + blocks * HD * HD;
  float* du_chunk = ecl + blocks * HD;
  const int vec = (reinterpret_cast<uintptr_t>(a.r) |
                   reinterpret_cast<uintptr_t>(a.k) |
                   reinterpret_cast<uintptr_t>(a.v) |
                   reinterpret_cast<uintptr_t>(a.logw) |
                   reinterpret_cast<uintptr_t>(a.states) |
                   reinterpret_cast<uintptr_t>(a.dout)) % 16 == 0;
  cudaError_t e;
  if ((a.passes & kPassLocal) && blocks > 0) {
    constexpr int smem = LocalLayout<HD>::bytes;
    if ((e = allow_smem(wkv6_bwd_local<T, HD>, smem)) != cudaSuccess)
      return (int)e;
    wkv6_bwd_local<T, HD><<<(unsigned)blocks, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.r), a.logw, a.dout, ds_end, ecl, a.dstate0,
        a.S, a.H, vec);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (a.passes & kPassScan) {
    const long long threads = (long long)a.B * a.H * HD * HD / 4;
    wkv6_bwd_scan<HD><<<(unsigned)((threads + kScanThreads - 1) / kScanThreads),
                        kScanThreads, 0, a.stream>>>(
        ds_end, ecl, a.dstate, a.dstate0, a.B, n_chunks, a.H);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if ((a.passes & kPassChunk) && blocks > 0) {
    constexpr int smem = ChunkLayout<HD>::bytes;
    if ((e = allow_smem(wkv6_bwd_chunk<T, HD>, smem)) != cudaSuccess)
      return (int)e;
    wkv6_bwd_chunk<T, HD><<<(unsigned)blocks, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.r), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.logw, a.u, a.states, ds_end, a.dout,
        static_cast<T*>(a.dr), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.dlogw, du_chunk, a.S, a.H, vec);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (a.passes & kPassDu) {
    const long long threads = (long long)a.B * a.H * HD * kDuParts;
    wkv6_bwd_du<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                  a.stream>>>(du_chunk, a.du_part, a.B, n_chunks, a.H, HD);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

template <template <typename, int> class F, typename... X>
int dispatch(int dtype, int hd, X... x) {
  if (dtype == kBFloat16 && hd == 64) return F<__nv_bfloat16, 64>::call(x...);
  if (dtype == kBFloat16 && hd == 16) return F<__nv_bfloat16, 16>::call(x...);
  if (dtype == kFloat32 && hd == 64) return F<float, 64>::call(x...);
  if (dtype == kFloat32 && hd == 16) return F<float, 16>::call(x...);
  return (int)cudaErrorInvalidValue;
}
template <typename T, int HD>
struct Run {
  static int call(const Args& a) { return run<T, HD>(a); }
};
template <typename T, int HD>
struct Smem {
  static int call(int pass) { return smem_of<T, HD>(pass); }
};
template <typename T, int HD>
struct Occupancy {
  static int call(int pass) {
    switch (pass) {
      case kPassLocal:
        return occupancy(wkv6_bwd_local<T, HD>, kThreads, smem_of<T, HD>(pass));
      case kPassScan:
        return occupancy(wkv6_bwd_scan<HD>, kScanThreads, 0);
      case kPassChunk:
        return occupancy(wkv6_bwd_chunk<T, HD>, kThreads, smem_of<T, HD>(pass));
      case kPassDu:
        return occupancy(wkv6_bwd_du, kThreads, 0);
    }
    return -1;
  }
};

}  // namespace

// r/k/v [B, S, H, hd] of dtype (code as in common.cuh), logw [B, S, H, hd]
// fp32, u [H, hd] fp32, states [B, ceil(S/32), H, hd, hd] fp32 (the
// forward's chunk-start states), dout [B, S, H, hd] fp32, dstate [B, H,
// hd, hd] fp32 or null (zero) -> dr/dk/dv [B, S, H, hd] of dtype, dlogw
// [B, S, H, hd] fp32, du_part [B, H, hd] fp32 (to be summed over B),
// dstate0 [B, H, hd, hd] fp32; scratch: B * ceil(S/32) * H * hd * (hd + 2)
// fp32, whose first B * ceil(S/32) * H * hd * hd floats hold dS at each
// chunk's end [B, ceil(S/32), H, hd, hd] after the scan pass; all
// contiguous; hd 16 or 64. passes: the bits of the passes to launch, in
// their order (1 local, 2 scan, 4 chunk, 8 du; 15 is the whole backward);
// a pass reads only what the passes before it wrote, and the pointers a
// pass does not read may be null. Returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const float* logw, const float* u,
                        const float* states, const float* dout,
                        const float* dstate, void* dr, void* dk, void* dv,
                        float* dlogw, float* du_part, float* dstate0,
                        float* scratch, int passes, int dtype, int hd, int B,
                        int S, int H, void* stream) {
  return dispatch<Run>(dtype, hd,
                       Args{r, k, v, logw, u, states, dout, dstate, dr, dk, dv,
                            dlogw, du_part, dstate0, scratch, passes, B, S, H,
                            static_cast<cudaStream_t>(stream)});
}

// The dynamic shared memory in bytes of pass `pass` (a bit as above) of
// the backward for (dtype, hd): 0 for the scan and du passes.
extern "C" int wkv6_bwd_smem_bytes(int dtype, int hd, int pass) {
  return dispatch<Smem>(dtype, hd, pass);
}

// The blocks of pass `pass` that one SM of the current device holds at
// once (-1 on error).
extern "C" int wkv6_bwd_blocks_per_sm(int dtype, int hd, int pass) {
  return dispatch<Occupancy>(dtype, hd, pass);
}
