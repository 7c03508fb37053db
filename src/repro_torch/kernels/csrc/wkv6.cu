// Chunked RWKV6 (WKV6) recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/wkv6.py:wkv6 (body _wkv6_kernel).
// Per (batch b, head h), with state S [hd, hd] (keys x values):
//     S_t   = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
//     out_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
// r/k/v [B, S, H, hd] (bf16 or fp32), logw [B, S, H, hd] fp32, u [H, hd]
// fp32, state0 [B, H, hd, hd] fp32 -> out [B, S, H, hd] fp32 and the final
// state [B, H, hd, hd] fp32; for training, optionally the state at each
// chunk's start [B, ceil(S/32), H, hd, hd] fp32, what the backward
// (csrc/wkv6_bwd.cu) reads. Serving passes a null pointer for it, and
// every other output is computed the same way either way: each block
// writes its value columns of the state it holds in registers at the top
// of each chunk's step.
//
// The form: chunks of kChunk = 32 tokens, the model's CHUNK
// (repro/models/rwkv6.py). With c the inclusive cumsum of logw inside the
// chunk, each chunk computes the TPU kernel's four terms:
//   scores  P[t, j] = (r_t e^{c_{t-1}}) . (k_j e^{-c_j}) for j < t,
//   bonus   P[t, t] = r_t . (u * k_t),
//   inter   out_t  += (r_t e^{c_{t-1}}) S,
//   carry   S       = e^{c_last} S + sum_j (k_j e^{c_last - c_j}) v_j^T.
// Why 32 and not the TPU kernel's default of 64: the factored scores need
// e^{-c} over the chunk, and at the model's clamp (logw >= -1.5) 32 tokens
// keep it within e^48, inside fp32; 64 tokens reach e^96 and overflow (the
// TPU kernel at chunk 64 gives NaN there). The other factors have
// exponents <= 0. A ragged last chunk is padded with k = v = r = 0 and
// logw = 0, which leaves the state as it is; its outputs are not written.
//
// What bounds it on the H100: bytes (r/k/v, logw, out, the states once),
// about 126 MB at B = 8, S = 512, H = 32, hd = 64, 0.038 ms; the chunk's
// products are ~1.6 GMAC there (~0.05 ms of fp32 FMAs), and the chunk loop
// is serial through the state. This design:
//  * splits the value columns across blocks: a block is (b, h, slice of
//    CW = hd / s columns), slice fastest, so the s blocks of a head read
//    r/k/logw from L2 together. out and the state's columns depend only on
//    their own columns of v; the decayed operands and the score tile depend
//    on r/k/logw only and each slice recomputes them. s is the fewest that
//    gives every SM a block (B * H and the SM count, host values), and every
//    value is computed by the same operations in the same order for any s,
//    so an output's bits do not depend on B;
//  * two groups of four warps, pipelined over chunks with two barriers a
//    chunk: while the first computes chunk i's outputs, the second makes
//    chunk i + 1's decayed operands; while the first carries the state over
//    chunk i, the second scores chunk i + 1 and copies chunk i + 2's inputs
//    by 16-byte cp.async (A, Kd, P double-buffered, v triple-buffered);
//  * the products (scores, P v + A S for the outputs, Kd^T v for the carry)
//    run on the tensor cores as 3xTF32 MMAs (mma.sync m16n8k8, tf32.cuh):
//    each fp32 operand is split into a TF32 high part and a TF32
//    remainder, and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, the small
//    terms in an accumulator of their own; a bf16 v is exact in TF32 and
//    takes two MMAs. Plain TF32
//    (10 mantissa bits) or bf16 operands would not hold the 2e-5 the checks
//    ask of this kernel's fp32 outputs; the split does, and the MMA
//    fragments need a fraction of the shared-memory operand traffic that
//    bounds register-tiled fp32 FMAs here. The state stays in the first
//    group's registers as MMA accumulators across the loop;
//  * the cumsum runs on every thread of the second group: thread (d,
//    segment) sums logw down column d in token order, then transforms its
//    segment (hd 64: 16 tokens), two expf per element; the bonus r.(u*k) is
//    reduced over d by warp shuffles;
//  * rows are padded so that every fragment load is free of bank conflicts.

#include "common.cuh"
#include "tf32.cuh"

using namespace rt;

namespace {

constexpr int kChunk = 32;
// two groups of four warps: the first computes the outputs and carries the
// state, the second makes the operands and scores and copies the inputs
constexpr int kThreads = 256;
constexpr int kGroup = kThreads / 2;

// shared memory, in bytes: r, k, logw of one chunk (input layout); v of
// three chunks (rows padded by 32 bytes); the fp32 operands: A, Kd, P and
// e^{c_last} of two chunks, Bm and the bonus partials of one; the state
// snapshot. Row pads keep every fragment load free of bank conflicts.
template <typename T, int HD, int CW>
struct Layout {
  static constexpr int kAStr = HD + 4;    // A, Bm rows (tokens)
  static constexpr int kKStr = HD + 8;    // Kd rows, read transposed
  static constexpr int kPStr = kChunk + 4;
  static constexpr int kSStr = CW + 8;    // state snapshot rows
  static constexpr int kVStr = CW + 32 / (int)sizeof(T);  // v rows
  static constexpr int kRK = HD < 32 ? 1 : HD / 32;  // bonus partials
  static constexpr int kA = kChunk * kAStr * 4;
  static constexpr int kKd = kChunk * kKStr * 4;
  static constexpr int kP = kChunk * kPStr * 4;
  static constexpr int kV = kChunk * kVStr * (int)sizeof(T);
  static constexpr int r = 0;
  static constexpr int k = r + kChunk * HD * (int)sizeof(T);
  static constexpr int w = k + kChunk * HD * (int)sizeof(T);
  static constexpr int v = w + kChunk * HD * 4;
  static constexpr int a = v + 3 * kV;
  static constexpr int kd = a + 2 * kA;
  static constexpr int bm = kd + 2 * kKd;
  static constexpr int p = bm + kA;
  static constexpr int st = p + 2 * kP;
  static constexpr int ecl = st + HD * kSStr * 4;
  static constexpr int rk = ecl + 2 * HD * 4;
  static constexpr int bytes = rk + kRK * kChunk * 4;
  static_assert(kV % 16 == 0 && (HD * (int)sizeof(T)) % 16 == 0 &&
                (CW * (int)sizeof(T)) % 16 == 0,
                "rows copy in 16-byte parts");
};

// 16 bytes global -> shared, any element type: cp.async when the tensors'
// rows are 16-byte aligned, else two-byte loads (copy_chunk); an invalid
// part is zeros
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid, bool vec) {
  copy_chunk(static_cast<__nv_bfloat16*>(dst),
             static_cast<const __nv_bfloat16*>(src), valid ? 8 : 0, vec);
}

// two blocks an SM (at most 128 registers a thread): at B * H = 256 heads
// every block is then resident at once
template <typename T, int HD, int CW>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_chunked(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ logw,
             const float* __restrict__ u, const float* __restrict__ state0,
             float* __restrict__ out, float* __restrict__ state_out,
             float* __restrict__ chunk_states, int S, int H, int vec) {
  using L = Layout<T, HD, CW>;
  constexpr bool kExactV = sizeof(T) == 2;  // bf16 v is exact in TF32
  constexpr int kSplit = HD / CW;
  constexpr int kLanes = HD < 32 ? HD : 32;  // lanes of one segment
  constexpr int kNT = CW / 8;              // n8 column tiles of the slice
  constexpr int kOutN = kNT >= 2 ? kNT / 2 : 1;  // out n-tiles a warp
  constexpr int kKM = HD / 16;             // m16 tiles of the state's rows
  static_assert(kKM <= 4, "one state m-tile a warp of the first group");

  extern __shared__ float4 smem_raw[];
  char* sm = reinterpret_cast<char*>(smem_raw);
  const T* Rs = reinterpret_cast<const T*>(sm + L::r);
  const T* Ks = reinterpret_cast<const T*>(sm + L::k);
  const float* Ws = reinterpret_cast<const float*>(sm + L::w);
  float* Bs = reinterpret_cast<float*>(sm + L::bm);
  float* Sts = reinterpret_cast<float*>(sm + L::st);
  float* RKp = reinterpret_cast<float*>(sm + L::rk);
  auto As = [&](int i) { return reinterpret_cast<float*>(sm + L::a + (i & 1) * L::kA); };
  auto Kds = [&](int i) { return reinterpret_cast<float*>(sm + L::kd + (i & 1) * L::kKd); };
  auto Ps = [&](int i) { return reinterpret_cast<float*>(sm + L::p + (i & 1) * L::kP); };
  auto Ecl = [&](int i) { return reinterpret_cast<float*>(sm + L::ecl + (i & 1) * HD * 4); };
  auto Vs = [&](int i) { return reinterpret_cast<const T*>(sm + L::v + (i % 3) * L::kV); };

  const int slice = blockIdx.x % kSplit;
  const int bh = blockIdx.x / kSplit;
  const int b = bh / H, h = bh % H;
  const int cb = slice * CW;  // the slice's first value column
  const int tid = threadIdx.x;
  const bool g1 = tid < kGroup;  // outputs and state, else operands
  const int g2 = tid - kGroup;   // index in the second group
  const int wid = (tid % kGroup) / 32, lane = tid % 32;
  const int fg = lane / 4, ft = lane % 4;  // fragment row and column
  const long long tok = (long long)H * HD;  // one token, all heads
  const long long base = ((long long)b * S * H + h) * HD;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  // r/k/logw and this slice's v columns of chunk i, one commit group
  auto load = [&](int i) {
    const int t0 = i * kChunk;
    constexpr int kPartsR = HD * (int)sizeof(T) / 16;
    constexpr int kPartsW = HD * 4 / 16;
    constexpr int kPartsV = CW * (int)sizeof(T) / 16;
    for (int e = g2; e < kChunk * kPartsR; e += kGroup) {
      const int t = e / kPartsR, part = e % kPartsR;
      const bool ok = t0 + t < S;
      const long long off =
          base + (t0 + t) * tok + part * (16 / (int)sizeof(T));
      copy16(sm + L::r + e * 16, ok ? r + off : r, ok, vec);
      copy16(sm + L::k + e * 16, ok ? k + off : k, ok, vec);
    }
    for (int e = g2; e < kChunk * kPartsW; e += kGroup) {
      const int t = e / kPartsW, part = e % kPartsW;
      const bool ok = t0 + t < S;
      const long long off = base + (t0 + t) * tok + part * 4;
      copy16(sm + L::w + e * 16, ok ? logw + off : logw, ok, vec);
    }
    char* vd = sm + L::v + (i % 3) * L::kV;
    for (int e = g2; e < kChunk * kPartsV; e += kGroup) {
      const int t = e / kPartsV, part = e % kPartsV;
      const bool ok = t0 + t < S;
      const long long off =
          base + (t0 + t) * tok + cb + part * (16 / (int)sizeof(T));
      copy16(vd + t * L::kVStr * (int)sizeof(T) + part * 16,
             ok ? v + off : v, ok, vec);
    }
    cp_async_commit();
  };

  // decayed operands of chunk i from its raw r/k/logw, by the second group:
  // thread (d, segment) sums column d's logw in token order, then
  // transforms its segment of tokens; the bonus r.(u*k) is reduced over d
  // by shuffles
  constexpr int kSegs = kGroup / HD;  // token segments per column
  constexpr int kSegLen = kChunk / kSegs;
  static_assert(kSegs >= 1 && kChunk % kSegs == 0, "segments");
  const int d = (tid % kGroup) % HD, seg = (tid % kGroup) / HD;
  const float ud = u[h * HD + d];
  auto transforms = [&](int i) {
    float* A = As(i);
    float* Kd = Kds(i);
    float cs[kSegLen], c = 0.f;
    const float* wd = Ws + d;
    int tk = 0;
    for (; tk < seg * kSegLen; ++tk) c += wd[tk * HD];  // segments before
    const float before = c;
#pragma unroll
    for (int e = 0; e < kSegLen; ++e, ++tk) cs[e] = c += wd[tk * HD];
    for (; tk < kChunk; ++tk) c += wd[tk * HD];  // segments after
    const float ecl = expf(c);
    if (seg == 0) Ecl(i)[d] = ecl;
#pragma unroll
    for (int e = 0; e < kSegLen; ++e) {
      const int t = seg * kSegLen + e;
      const float rx = to_float(Rs[t * HD + d]);
      const float kx = to_float(Ks[t * HD + d]);
      const float bx = kx * expf(-cs[e]);
      A[t * L::kAStr + d] = rx * expf(e == 0 ? before : cs[e - 1]);
      Bs[t * L::kAStr + d] = bx;
      Kd[t * L::kKStr + d] = bx * ecl;
      float y = rx * ud * kx;
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        y += __shfl_xor_sync(0xffffffffu, y, off);
      if (g2 % kLanes == 0) RKp[(d / kLanes) * kChunk + t] = y;
    }
  };

  // score tile of chunk i: P[t, j] = A[t] . Bm[j] below the diagonal, the
  // bonus on it, zero above (never written). The m16 x n8 tiles that reach
  // the diagonal or lie below it: warp 0 (tokens 0-15, keys 0-15), warp 1
  // (tokens 16-31, keys 0-15), warps 2 and 3 (tokens 16-31, keys 16-23
  // and 24-31).
  auto score = [&](int i) {
    const float* A = As(i);
    float* P = Ps(i);
    const int mt = wid == 0 ? 0 : 1;
    const int n0 = wid < 2 ? 0 : wid;        // first n-tile
    const int nn = wid < 2 ? 2 : 1;          // n-tiles of this warp
    float acc[2][4] = {}, lo[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
      const FragA fa = frag_a(
          [&](int row, int col) {
            return A[(16 * mt + row) * L::kAStr + 8 * ks + col];
          },
          fg, ft);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= nn) break;
        const float* bj = Bs + (8 * (n0 + q) + fg) * L::kAStr + 8 * ks + ft;
        mma3<false>(acc[q], lo[q], fa, frag_b(bj[0], bj[4]));
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= nn) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = 16 * mt + fg + 8 * hf;
        float x[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int j = 8 * (n0 + q) + 2 * ft + cc;
          x[cc] = j < t ? acc[q][2 * hf + cc] + lo[q][2 * hf + cc] : 0.f;
          if (j == t) {
            x[cc] = RKp[t];
#pragma unroll
            for (int gg = 1; gg < L::kRK; ++gg) x[cc] += RKp[gg * kChunk + t];
          }
        }
        *reinterpret_cast<float2*>(P + t * L::kPStr + 8 * (n0 + q) + 2 * ft) =
            make_float2(x[0], x[1]);
      }
    }
  };

  // out of chunk i: out[t, c] = sum_j P[t, j] v[j, c] + sum_k A[t, k]
  // S[k, c], one MMA chain over j then k per m16 x n8 tile (the j-steps
  // past a tile's last token, where P is zero, are skipped). Warp w takes
  // m-tile w % 2 and the n-tiles w / 2, w / 2 + 2, ...
  const int out_mt = wid % 2;
  auto outputs = [&](int i) {
    if (wid / 2 >= kNT) return;
    const float* P = Ps(i);
    const float* A = As(i);
    const T* V = Vs(i);
    float acc[kOutN][4] = {}, lo[kOutN][4] = {};
    const int j_steps = out_mt == 0 ? 2 : 4;
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      if (ks >= j_steps) break;
      const FragA fa = frag_a(
          [&](int row, int col) {
            return P[(16 * out_mt + row) * L::kPStr + 8 * ks + col];
          },
          fg, ft);
#pragma unroll
      for (int q = 0; q < kOutN; ++q) {
        const T* vj = V + (8 * ks + ft) * L::kVStr + 8 * (wid / 2 + 2 * q) + fg;
        mma3<kExactV>(acc[q], lo[q], fa, frag_b(vj[0], vj[4 * L::kVStr]));
      }
    }
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
      const FragA fa = frag_a(
          [&](int row, int col) {
            return A[(16 * out_mt + row) * L::kAStr + 8 * ks + col];
          },
          fg, ft);
#pragma unroll
      for (int q = 0; q < kOutN; ++q) {
        const float* sk = Sts + (8 * ks + ft) * L::kSStr + 8 * (wid / 2 + 2 * q) + fg;
        mma3<false>(acc[q], lo[q], fa, frag_b(sk[0], sk[4 * L::kSStr]));
      }
    }
    const int n = min(kChunk, S - i * kChunk);
#pragma unroll
    for (int q = 0; q < kOutN; ++q)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = 16 * out_mt + fg + 8 * hf;
        if (t < n)
          *reinterpret_cast<float2*>(
              out + base + (long long)(i * kChunk + t) * tok + cb +
              8 * (wid / 2 + 2 * q) + 2 * ft) =
              make_float2(acc[q][2 * hf] + lo[q][2 * hf],
                          acc[q][2 * hf + 1] + lo[q][2 * hf + 1]);
      }
  };

  // the state slice in registers as MMA accumulators: warp w of the first
  // group holds rows 16 w .. 16 w + 16 (a thread rows fg, fg + 8), every
  // n-tile of the slice's columns (a thread columns 2 ft, 2 ft + 1)
  const bool st_warp = g1 && wid < kKM;
  const int m0 = 16 * wid;
  float st[kNT][4];
  {
    const float* s0 = state0 + (long long)bh * HD * HD + cb;
#pragma unroll
    for (int q = 0; q < kNT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[q][e] = st_warp ? s0[(m0 + fg + 8 * (e / 2)) * HD + 8 * q +
                                2 * ft + e % 2]
                           : 0.f;
  }

  // carry of chunk i: S = e^{c_last} S + Kd^T v, its rows scaled first,
  // then an MMA chain over the chunk's tokens; then the snapshot the next
  // chunk's inter term reads
  auto carry = [&](int i) {
    if (!st_warp) return;
    const float* Kd = Kds(i);
    const float* E = Ecl(i);
    const T* V = Vs(i);
    const float e0 = E[m0 + fg], e1 = E[m0 + fg + 8];
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
      st[q][0] *= e0, st[q][1] *= e0;
      st[q][2] *= e1, st[q][3] *= e1;
    }
    float lo[kNT][4] = {};
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      const FragA fa = frag_a(
          [&](int row, int col) {
            return Kd[(8 * ks + col) * L::kKStr + m0 + row];
          },
          fg, ft);
#pragma unroll
      for (int q = 0; q < kNT; ++q) {
        const T* vj = V + (8 * ks + ft) * L::kVStr + 8 * q + fg;
        mma3<kExactV>(st[q], lo[q], fa, frag_b(vj[0], vj[4 * L::kVStr]));
      }
    }
#pragma unroll
    for (int q = 0; q < kNT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[q][e] += lo[q][e];
  };
  // the state at chunk i's start, this slice's columns (training only)
  auto save_state = [&](int i) {
    if (!st_warp || chunk_states == nullptr) return;
    float* so = chunk_states +
                (((long long)b * n_chunks + i) * H + h) * HD * HD + cb;
#pragma unroll
    for (int q = 0; q < kNT; ++q)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(so + (m0 + fg + 8 * hf) * HD + 8 * q +
                                   2 * ft) =
            make_float2(st[q][2 * hf], st[q][2 * hf + 1]);
  };
  auto snapshot = [&]() {
    if (!st_warp) return;
#pragma unroll
    for (int q = 0; q < kNT; ++q)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(Sts + (m0 + fg + 8 * hf) * L::kSStr +
                                   8 * q + 2 * ft) =
            make_float2(st[q][2 * hf], st[q][2 * hf + 1]);
  };

  // Pipelined over chunks, two barriers a chunk. Phase X: the first group
  // computes chunk i's outputs while the second makes chunk i + 1's
  // operands; phase Y: the first carries the state over chunk i while the
  // second scores chunk i + 1 and starts the copy of chunk i + 2. A, Kd, P
  // and e^{c_last} alternate between two buffers, v between three.
  for (int e = tid; e < 2 * L::kP / 4; e += kThreads)
    reinterpret_cast<float*>(sm + L::p)[e] = 0.f;
  if (n_chunks > 0) {
    if (!g1) load(0);
    cp_async_wait<0>();
    __syncthreads();
    if (g1) snapshot();
    else transforms(0);
    __syncthreads();
    if (!g1) {
      if (n_chunks > 1) load(1);
      score(0);
    }
  }
  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // X: chunk i + 1's inputs landed; chunk i's operands,
                      // scores and the state snapshot ready
    if (g1) {
      save_state(i);
      outputs(i);
    } else if (i + 1 < n_chunks) {
      transforms(i + 1);
    }
    __syncthreads();  // Y: raw inputs consumed; chunk i's outputs done
    if (g1) {
      carry(i);
      snapshot();
    } else {
      if (i + 1 < n_chunks) score(i + 1);
      if (i + 2 < n_chunks) load(i + 2);
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit

  if (st_warp) {
    float* so = state_out + (long long)bh * HD * HD + cb;
#pragma unroll
    for (int q = 0; q < kNT; ++q)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(so + (m0 + fg + 8 * hf) * HD + 8 * q +
                                   2 * ft) =
            make_float2(st[q][2 * hf], st[q][2 * hf + 1]);
  }
}

// Value-column slices per head: the fewest (each slice recomputes the
// scores) that give every SM a block, at most hd / 8 (8 columns a block).
// From B * H and the SM count only, never from data on the device.
int slices_for(int hd, int B, int H) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int s = 1;
  while (s < hd / 8 && (long long)B * H * s < sms) s *= 2;
  return s;
}

struct Args {
  const void *r, *k, *v;
  const float *logw, *u, *state0;
  float *out, *state_out, *chunk_states;
  int B, S, H;
  cudaStream_t stream;
  bool query;  // return the launch's dynamic shared memory, launch nothing
};

template <typename T, int HD, int CW>
int launch(const Args& a) {
  constexpr int smem = Layout<T, HD, CW>::bytes;
  if (a.query) return smem;
  auto kern = wkv6_chunked<T, HD, CW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = (reinterpret_cast<uintptr_t>(a.r) |
                   reinterpret_cast<uintptr_t>(a.k) |
                   reinterpret_cast<uintptr_t>(a.v) |
                   reinterpret_cast<uintptr_t>(a.logw)) % 16 == 0;
  kern<<<a.B * a.H * (HD / CW), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.logw, a.u, a.state0, a.out, a.state_out,
      a.chunk_states, a.S, a.H, vec);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_slices(int s, const Args& a) {
  switch (s) {
    case 1: return launch<T, HD, HD>(a);
    case 2: return launch<T, HD, HD / 2>(a);
    case 4: if constexpr (HD / 4 >= 8) return launch<T, HD, HD / 4>(a); break;
    case 8: if constexpr (HD / 8 >= 8) return launch<T, HD, HD / 8>(a); break;
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(int dtype, int hd, const Args& a) {
  const int s = slices_for(hd, a.B, a.H);
  if (dtype == kBFloat16 && hd == 64) return launch_slices<__nv_bfloat16, 64>(s, a);
  if (dtype == kBFloat16 && hd == 16) return launch_slices<__nv_bfloat16, 16>(s, a);
  if (dtype == kFloat32 && hd == 64) return launch_slices<float, 64>(s, a);
  if (dtype == kFloat32 && hd == 16) return launch_slices<float, 16>(s, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// r/k/v [B, S, H, hd] of dtype (code as in common.cuh), logw [B, S, H, hd]
// fp32, u [H, hd] fp32, state0 and state_out [B, H, hd, hd] fp32, out
// [B, S, H, hd] fp32, chunk_states [B, ceil(S/32), H, hd, hd] fp32 or null
// (not written); all contiguous; hd 16 or 64. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const float* logw, const float* u,
                        const float* state0, float* out, float* state_out,
                        float* chunk_states, int dtype, int hd, int B, int S,
                        int H, void* stream) {
  return dispatch(dtype, hd,
                  {r, k, v, logw, u, state0, out, state_out, chunk_states, B,
                   S, H, static_cast<cudaStream_t>(stream), false});
}

// The value-column slices per head, and the dynamic shared memory in bytes
// of the launch, that wkv6_fwd takes for (dtype, hd, B, H).
extern "C" int wkv6_split(int hd, int B, int H) {
  return slices_for(hd, B, H);
}

extern "C" int wkv6_smem_bytes(int dtype, int hd, int B, int H) {
  return dispatch(dtype, hd,
                  {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr, B, 0, H, nullptr, true});
}
