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
// ref.wkv6_chunked_bwd_ref is the plain version, the same formulas.
//
// The design (a first one, right before fast): one block of 256 threads
// per (b, h) walks the chunks in reverse, dS carried in shared memory
// (hd x hd fp32, 16 KB at hd 64). Each chunk: its inputs and its start
// state from the forward into shared memory as fp32 (every load of a
// thread issued before the first store: one memory latency a chunk, not
// one a row); the decayed operands
// (thread (d, segment) sums column d's logw in token order); the pair
// tiles P, dP (and their transposes) of 4 entries a thread; the per-token
// gradients, thread (d, token group) holding its tokens' dv, dA, dBm, dKd
// in registers, the broadcast operand read as float4; dS's update, thread
// (column, 16 rows); dlogw's reverse scan by column. Every product is an
// fp32 FMA, every sum in a fixed order: no atomics, so a row's bits do not
// depend on B and two runs are equal. du leaves as per-(b, h) partials
// [B, H, hd], summed by the caller. A ragged last chunk is padded with r =
// k = v = dout = 0 and logw = 0 (which leaves c_L as it is); its padded
// rows are not written.
//
// What bounds it on the H100: per chunk and (b, h) ~0.7 M fp32 FMAs at hd
// 64 against ~48 KB of inputs, so operations, not bytes; at B * H = 32 or
// 64 heads one block an SM leaves most of the 132 SMs idle (splitting the
// value columns over blocks, with a deterministic second pass for dr, dk
// and dlogw, is later work).

#include "common.cuh"

using namespace rt;

namespace {

constexpr int kChunk = 32;
constexpr int kThreads = 256;

template <int HD>
struct Layout {
  static constexpr int kStr = HD + 4;      // [token][channel] rows, float4
  static constexpr int kPStr = kChunk + 4; // pair tiles
  static constexpr int kTok = kChunk * kStr;
  static constexpr int kSq = HD * kStr;
  static constexpr int kPair = kChunk * kPStr;
  static constexpr int kNG = kThreads / HD;  // token groups / row groups
  // offsets in floats: r, k, v, logw, dout; A, Bm, Kd, e^{c_prev},
  // e^{-c}, e^{c_L - c}; x, y; S0, dS; P, P^T, dP, dP^T; dd, u,
  // e^{c_L}, the carry's rowsum, the dc_L and du partials
  static constexpr int r = 0, k = r + kTok, v = k + kTok, w = v + kTok,
                       dout = w + kTok, a = dout + kTok, bm = a + kTok,
                       kd = bm + kTok, ecp = kd + kTok, emc = ecp + kTok,
                       ek = emc + kTok, x = ek + kTok, y = x + kTok,
                       s0 = y + kTok, ds = s0 + kSq, p = ds + kSq,
                       pt = p + kPair, dp = pt + kPair, dpt = dp + kPair,
                       dd = dpt + kPair, u = dd + kChunk, ecl = u + HD,
                       car = ecl + HD, dclp = car + HD, dup = dclp + kNG * HD,
                       floats = dup + kNG * HD;
  static constexpr int bytes = floats * 4;
  static_assert(kStr % 4 == 0 && kPStr % 4 == 0 && s0 % 4 == 0 &&
                p % 4 == 0, "float4 rows");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_bwd_chunked(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u,
                 const float* __restrict__ states,
                 const float* __restrict__ dout,
                 const float* __restrict__ dstate, T* __restrict__ dr,
                 T* __restrict__ dk, T* __restrict__ dv,
                 float* __restrict__ dlogw, float* __restrict__ du_part,
                 float* __restrict__ dstate0, int S, int H) {
  using L = Layout<HD>;
  constexpr int kStr = L::kStr, kPStr = L::kPStr, kNG = L::kNG;
  constexpr int kTpt = kChunk / kNG;   // tokens a thread (gradients)
  constexpr int kRpt = HD / kNG;       // dS rows a thread
  constexpr int kSegLen = kChunk / kNG;  // tokens a segment (transforms)
  static_assert(kChunk % kNG == 0 && HD % kNG == 0 &&
                    (kRpt % 4 == 0 || kRpt == 1) &&
                    HD * HD % kThreads == 0 && kChunk * HD % kThreads == 0,
                "thread mappings");

  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float *R = sm + L::r, *K = sm + L::k, *V = sm + L::v, *W = sm + L::w,
        *DO = sm + L::dout, *A = sm + L::a, *Bm = sm + L::bm,
        *Kd = sm + L::kd, *ECP = sm + L::ecp, *EMC = sm + L::emc,
        *EK = sm + L::ek, *X = sm + L::x, *Y = sm + L::y, *S0 = sm + L::s0,
        *DS = sm + L::ds, *P = sm + L::p, *PT = sm + L::pt,
        *DP = sm + L::dp, *DPT = sm + L::dpt, *DD = sm + L::dd,
        *U = sm + L::u, *ECL = sm + L::ecl, *CAR = sm + L::car,
        *DCLP = sm + L::dclp, *DUP = sm + L::dup;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int d = tid % HD, g = tid / HD;  // channel (or column), group
  const long long tok = (long long)H * HD;
  const long long base = ((long long)b * S * H + h) * HD;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  if (tid < HD) U[tid] = u[h * HD + tid];
  for (int e = tid; e < HD * HD; e += kThreads)
    DS[(e / HD) * kStr + e % HD] =
        dstate ? dstate[(long long)bh * HD * HD + e] : 0.f;
  float du_acc = 0.f;

  for (int i = n_chunks - 1; i >= 0; --i) {
    const int t0 = i * kChunk;
    const int n = min(kChunk, S - t0);
    // ---- inputs and the chunk's start state; the loops are unrolled so
    // that every load of a thread is in flight at once
    {
      const float* st = states + (((long long)b * n_chunks + i) * H + h) *
                                     HD * HD;
      float s0[HD * HD / kThreads];
#pragma unroll
      for (int it = 0; it < HD * HD / kThreads; ++it)
        s0[it] = st[tid + it * kThreads];
      constexpr int kIt = kChunk * HD / kThreads;
      float x[5][kIt];
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int e = tid + it * kThreads;
        const int t = e / HD, c = e % HD;
        const bool ok = t < n;
        const long long off = base + (long long)(t0 + t) * tok + c;
        x[0][it] = ok ? to_float(r[off]) : 0.f;
        x[1][it] = ok ? to_float(k[off]) : 0.f;
        x[2][it] = ok ? to_float(v[off]) : 0.f;
        x[3][it] = ok ? logw[off] : 0.f;
        x[4][it] = ok ? dout[off] : 0.f;
      }
#pragma unroll
      for (int it = 0; it < HD * HD / kThreads; ++it) {
        const int e = tid + it * kThreads;
        S0[(e / HD) * kStr + e % HD] = s0[it];
      }
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int e = tid + it * kThreads;
        const int s = (e / HD) * kStr + e % HD;
        R[s] = x[0][it];
        K[s] = x[1][it];
        V[s] = x[2][it];
        W[s] = x[3][it];
        DO[s] = x[4][it];
      }
    }
    __syncthreads();

    // ---- decayed operands: thread (d, segment g) sums column d's logw
    // in token order through its segment, then to the chunk's end
    {
      float c = 0.f, cs[kSegLen];
      int t = 0;
      for (; t < g * kSegLen; ++t) c += W[t * kStr + d];
#pragma unroll
      for (int e = 0; e < kSegLen; ++e, ++t) {
        const float cp = c;
        c += W[t * kStr + d];
        cs[e] = c;
        const float ecp = expf(cp), emc = expf(-c);
        ECP[t * kStr + d] = ecp;
        EMC[t * kStr + d] = emc;
        A[t * kStr + d] = R[t * kStr + d] * ecp;
        Bm[t * kStr + d] = K[t * kStr + d] * emc;
      }
      for (; t < kChunk; ++t) c += W[t * kStr + d];
      if (g == 0) ECL[d] = expf(c);
#pragma unroll
      for (int e = 0; e < kSegLen; ++e) {
        const int tt = g * kSegLen + e;
        const float ek = expf(c - cs[e]);
        EK[tt * kStr + d] = ek;
        Kd[tt * kStr + d] = K[tt * kStr + d] * ek;
      }
    }
    __syncthreads();

    // ---- pair tiles: thread (t, j = tid % 8 + 8 m), each a dot over
    // the channels; P's diagonal is the bonus, dP's is dd (kept apart)
    {
      const int t = tid / 8;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = tid % 8 + 8 * m;
        float p = 0.f, dp = 0.f;
        if (j < t) {
          for (int c = 0; c < HD; c += 4) {
            p = dot4(ld4(A + t * kStr + c), ld4(Bm + j * kStr + c), p);
            dp = dot4(ld4(DO + t * kStr + c), ld4(V + j * kStr + c), dp);
          }
        } else if (j == t) {
          for (int c = 0; c < HD; ++c) {
            p = fmaf(R[t * kStr + c] * U[c], K[t * kStr + c], p);
            dp = fmaf(DO[t * kStr + c], V[t * kStr + c], dp);
          }
          DD[t] = dp;
          dp = 0.f;
        }
        P[t * kPStr + j] = p;
        PT[j * kPStr + t] = p;
        DP[t * kPStr + j] = dp;
        DPT[j * kPStr + t] = dp;
      }
    }
    __syncthreads();

    // ---- per-token gradients: thread (d, token group g) takes tokens
    // g + kNG m
    {
      float gv[kTpt], ga[kTpt], gb[kTpt], gk[kTpt];
#pragma unroll
      for (int m = 0; m < kTpt; ++m) gv[m] = ga[m] = gb[m] = gk[m] = 0.f;
      // within the chunk: over the tokens s, four at a time
      for (int s = 0; s < kChunk; s += 4) {
        float o[4], a[4], bm[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          o[q] = DO[(s + q) * kStr + d];
          a[q] = A[(s + q) * kStr + d];
          bm[q] = Bm[(s + q) * kStr + d];
        }
#pragma unroll
        for (int m = 0; m < kTpt; ++m) {
          const int t = g + kNG * m;
          const float4 pt = ld4(PT + t * kPStr + s);
          const float4 dpt = ld4(DPT + t * kPStr + s);
          const float4 dp = ld4(DP + t * kPStr + s);
          gv[m] = dot4(pt, make_float4(o[0], o[1], o[2], o[3]), gv[m]);
          gb[m] = dot4(dpt, make_float4(a[0], a[1], a[2], a[3]), gb[m]);
          ga[m] = dot4(dp, make_float4(bm[0], bm[1], bm[2], bm[3]), ga[m]);
        }
      }
      // the state's terms: over the channels c, four at a time
      float car = 0.f;
      for (int c = 0; c < HD; c += 4) {
        const float4 s0 = ld4(S0 + d * kStr + c);
        const float4 gs = ld4(DS + d * kStr + c);
        const float4 gcol = make_float4(DS[c * kStr + d],
                                        DS[(c + 1) * kStr + d],
                                        DS[(c + 2) * kStr + d],
                                        DS[(c + 3) * kStr + d]);
        car = dot4(gs, s0, car);
#pragma unroll
        for (int m = 0; m < kTpt; ++m) {
          const int t = g + kNG * m;
          ga[m] = dot4(s0, ld4(DO + t * kStr + c), ga[m]);
          gk[m] = dot4(gs, ld4(V + t * kStr + c), gk[m]);
          gv[m] = dot4(ld4(Kd + t * kStr + c), gcol, gv[m]);
        }
      }
      if (g == 0) CAR[d] = car;
      float dcl = 0.f;
      const float ud = U[d];
#pragma unroll
      for (int m = 0; m < kTpt; ++m) {
        const int t = g + kNG * m;
        const int s = t * kStr + d;
        const float dd = DD[t];
        dcl = fmaf(gk[m], Kd[s], dcl);
        X[s] = -(gb[m] * Bm[s] + gk[m] * Kd[s]);
        Y[s] = ga[m] * A[s];
        du_acc = fmaf(dd, R[s] * K[s], du_acc);
        if (t < n) {
          const long long off = base + (long long)(t0 + t) * tok + d;
          dr[off] = from_float<T>(fmaf(ga[m], ECP[s], dd * ud * K[s]));
          dk[off] = from_float<T>(gb[m] * EMC[s] + gk[m] * EK[s] +
                                  dd * ud * R[s]);
          dv[off] = from_float<T>(gv[m]);
        }
      }
      DCLP[g * HD + d] = dcl;
    }
    __syncthreads();

    // ---- dS <- e^{c_L} dS + A^T dout: thread (column d, rows g kRpt ..)
    {
      float ns[kRpt];
#pragma unroll
      for (int m = 0; m < kRpt; ++m) {
        const int row = g * kRpt + m;
        ns[m] = ECL[row] * DS[row * kStr + d];
      }
      for (int t = 0; t < kChunk; ++t) {
        const float o = DO[t * kStr + d];
        if constexpr (kRpt == 1) {
          ns[0] = fmaf(A[t * kStr + g], o, ns[0]);
        } else {
#pragma unroll
          for (int m = 0; m < kRpt; m += 4) {
            const float4 a = ld4(A + t * kStr + g * kRpt + m);
            ns[m] = fmaf(a.x, o, ns[m]);
            ns[m + 1] = fmaf(a.y, o, ns[m + 1]);
            ns[m + 2] = fmaf(a.z, o, ns[m + 2]);
            ns[m + 3] = fmaf(a.w, o, ns[m + 3]);
          }
        }
      }
      __syncthreads();  // every read of the old dS is done
#pragma unroll
      for (int m = 0; m < kRpt; ++m) DS[(g * kRpt + m) * kStr + d] = ns[m];
    }
    // ---- dlogw: column d's reverse scan (x and y of this chunk)
    if (tid < HD) {
      float dcl = ECL[d] * CAR[d];
      for (int gg = 0; gg < kNG; ++gg) dcl += DCLP[gg * HD + d];
      float ax = 0.f, ay = 0.f;
      for (int t = kChunk - 1; t >= 0; --t) {
        ax += X[t * kStr + d];
        if (t < n)
          dlogw[base + (long long)(t0 + t) * tok + d] = ax + ay + dcl;
        ay += Y[t * kStr + d];
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < HD * HD; e += kThreads)
    dstate0[(long long)bh * HD * HD + e] = DS[(e / HD) * kStr + e % HD];
  DUP[g * HD + d] = du_acc;
  __syncthreads();
  if (tid < HD) {
    float s = 0.f;
    for (int gg = 0; gg < kNG; ++gg) s += DUP[gg * HD + tid];
    du_part[(long long)bh * HD + tid] = s;
  }
}

struct Args {
  const void *r, *k, *v;
  const float *logw, *u, *states, *dout, *dstate;
  void *dr, *dk, *dv;
  float *dlogw, *du_part, *dstate0;
  int B, S, H;
  cudaStream_t stream;
  bool query;  // return the launch's dynamic shared memory, launch nothing
};

template <typename T, int HD>
int launch(const Args& a) {
  constexpr int smem = Layout<HD>::bytes;
  if (a.query) return smem;
  auto kern = wkv6_bwd_chunked<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<a.B * a.H, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.logw, a.u, a.states, a.dout, a.dstate,
      static_cast<T*>(a.dr), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.dlogw, a.du_part, a.dstate0, a.S, a.H);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, int hd, const Args& a) {
  if (dtype == kBFloat16 && hd == 64) return launch<__nv_bfloat16, 64>(a);
  if (dtype == kBFloat16 && hd == 16) return launch<__nv_bfloat16, 16>(a);
  if (dtype == kFloat32 && hd == 64) return launch<float, 64>(a);
  if (dtype == kFloat32 && hd == 16) return launch<float, 16>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// r/k/v [B, S, H, hd] of dtype (code as in common.cuh), logw [B, S, H, hd]
// fp32, u [H, hd] fp32, states [B, ceil(S/32), H, hd, hd] fp32 (the
// forward's chunk-start states), dout [B, S, H, hd] fp32, dstate [B, H,
// hd, hd] fp32 or null (zero) -> dr/dk/dv [B, S, H, hd] of dtype, dlogw
// [B, S, H, hd] fp32, du_part [B, H, hd] fp32 (to be summed over B),
// dstate0 [B, H, hd, hd] fp32; all contiguous; hd 16 or 64. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const float* logw, const float* u,
                        const float* states, const float* dout,
                        const float* dstate, void* dr, void* dk, void* dv,
                        float* dlogw, float* du_part, float* dstate0,
                        int dtype, int hd, int B, int S, int H,
                        void* stream) {
  return dispatch(dtype, hd,
                  {r, k, v, logw, u, states, dout, dstate, dr, dk, dv, dlogw,
                   du_part, dstate0, B, S, H,
                   static_cast<cudaStream_t>(stream), false});
}

// The dynamic shared memory in bytes of the launch wkv6_bwd takes for
// (dtype, hd).
extern "C" int wkv6_bwd_smem_bytes(int dtype, int hd) {
  return dispatch(dtype, hd,
                  {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, 0, 0, 0, nullptr, true});
}
