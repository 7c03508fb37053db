// Chunked RWKV6 (WKV6) recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/wkv6.py:wkv6 (body _wkv6_kernel).
// Per (batch b, head h), with state S [hd, hd] (keys x values):
//     S_t   = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
//     out_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
// r/k/v [B, S, H, hd] (bf16 or fp32), logw [B, S, H, hd] fp32, u [H, hd]
// fp32, state0 [B, H, hd, hd] fp32 -> out [B, S, H, hd] fp32 and the final
// state [B, H, hd, hd] fp32.
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
// about 126 MB at B = 8, S = 512, H = 32, hd = 64; its 3.3 GFLOP do not
// matter. What the design does:
//  * one block per (b, h), with a loop over chunks in the block in place of
//    the TPU's sequential grid axis; the state never leaves the block:
//    4 * hd threads hold it in registers, thread (q, v) keeping column v at
//    rows k = 4i + q, so the inter term's sum over k is a two-step shuffle
//    among four neighbouring lanes;
//  * each chunk's r, k, v, logw are staged once in shared memory as fp32
//    (rows padded by one float against bank conflicts), turned in place
//    into the decayed operands by hd threads walking the cumsum, and the
//    32 x 32 score tile is built once and shared by all output columns;
//  * fp32 FMAs on the CUDA cores throughout; tensor-core tiles are later
//    work.

#include "common.cuh"

using namespace rt;

namespace {

constexpr int kChunk = 32;

template <int HD>
struct Smem {
  static constexpr int kStride = HD + 1;
  static constexpr int kTile = kChunk * kStride;
  static constexpr int a = 0;             // r, then r e^{c_prev}
  static constexpr int b = a + kTile;     // k, then k e^{-c}
  static constexpr int kd = b + kTile;    // logw, then k e^{c_last - c}
  static constexpr int v = kd + kTile;
  static constexpr int ruk = v + kTile;   // r * u * k, for the bonus
  static constexpr int p = ruk + kTile;   // scores [kChunk][kChunk + 1]
  static constexpr int ecl = p + kChunk * (kChunk + 1);  // e^{c_last} [HD]
  static constexpr int floats = ecl + HD;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(4 * HD)
wkv6_chunked(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ logw,
             const float* __restrict__ u, const float* __restrict__ state0,
             float* __restrict__ out, float* __restrict__ state_out, int S,
             int H) {
  using L = Smem<HD>;
  constexpr int kThreads = 4 * HD;
  constexpr int kRows = HD / 4;  // state rows per thread
  constexpr int kSt = L::kStride;
  extern __shared__ float smem[];
  float* As = smem + L::a;
  float* Bs = smem + L::b;
  float* Ks = smem + L::kd;
  float* Vs = smem + L::v;
  float* Us = smem + L::ruk;
  float* Ps = smem + L::p;
  float* Ecl = smem + L::ecl;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int q = tid & 3, col = tid >> 2;  // state rows 4i + q, column col

  float st[kRows];
  const float* s0 = state0 + (long long)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) st[i] = s0[(4 * i + q) * HD + col];

  const float ud = tid < HD ? u[h * HD + tid] : 0.f;
  const long long tok_stride = (long long)H * HD;  // one token, all heads
  const long long base = ((long long)b * S * H + h) * HD;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk's tiles fully consumed
    for (int i = tid; i < kChunk * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      float rx = 0.f, kx = 0.f, vx = 0.f, wx = 0.f;
      if (t < n) {
        const long long off = base + (t0 + t) * tok_stride + d;
        rx = to_float(r[off]);
        kx = to_float(k[off]);
        vx = to_float(v[off]);
        wx = logw[off];
      }
      As[t * kSt + d] = rx;
      Bs[t * kSt + d] = kx;
      Ks[t * kSt + d] = wx;
      Vs[t * kSt + d] = vx;
    }
    __syncthreads();

    // decayed operands, one column d per thread: the cumsum first (for
    // c_last), then the in-place transforms
    if (tid < HD) {
      const int d = tid;
      float c_last = 0.f;
      for (int t = 0; t < kChunk; ++t) c_last += Ks[t * kSt + d];
      float c = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        const float c_prev = c;
        c += Ks[t * kSt + d];
        const float rx = As[t * kSt + d], kx = Bs[t * kSt + d];
        As[t * kSt + d] = rx * expf(c_prev);
        Bs[t * kSt + d] = kx * expf(-c);
        Ks[t * kSt + d] = kx * expf(c_last - c);
        Us[t * kSt + d] = rx * ud * kx;
      }
      Ecl[d] = expf(c_last);
    }
    __syncthreads();

    // score tile: a warp takes one query row t, lane j one key
    for (int e = tid; e < kChunk * kChunk; e += kThreads) {
      const int t = e / kChunk, j = e % kChunk;
      float p = 0.f;
      if (j < t) {
#pragma unroll 8
        for (int d = 0; d < HD; ++d) p += As[t * kSt + d] * Bs[j * kSt + d];
      } else if (j == t) {
#pragma unroll 8
        for (int d = 0; d < HD; ++d) p += Us[t * kSt + d];
      }
      Ps[t * (kChunk + 1) + j] = p;
    }
    __syncthreads();

    // out_t[col] = sum_j P[t, j] v_j[col] + sum_k A[t, k] S[k, col]: each
    // of the four lanes of a column takes keys j = 4m + q and rows k =
    // 4i + q, then the four partial sums meet by shuffles
    float vq[kChunk / 4];
#pragma unroll
    for (int m = 0; m < kChunk / 4; ++m) vq[m] = Vs[(4 * m + q) * kSt + col];
    float* orow = out + base + (long long)t0 * tok_stride + col;
    for (int t = 0; t < n; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < kChunk / 4; ++m)
        acc += Ps[t * (kChunk + 1) + 4 * m + q] * vq[m];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc += As[t * kSt + 4 * i + q] * st[i];
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0) orow[t * tok_stride] = acc;
    }

    // carry: S = e^{c_last} S + sum_j kd_j v_j^T
#pragma unroll
    for (int i = 0; i < kRows; ++i) st[i] *= Ecl[4 * i + q];
    for (int j = 0; j < kChunk; ++j) {
      const float vx = Vs[j * kSt + col];
#pragma unroll
      for (int i = 0; i < kRows; ++i) st[i] += Ks[j * kSt + 4 * i + q] * vx;
    }
  }

  float* so = state_out + (long long)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) so[(4 * i + q) * HD + col] = st[i];
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* state0, float* out, float* state_out,
           int B, int S, int H, cudaStream_t stream) {
  auto kern = wkv6_chunked<T, HD>;
  const size_t smem = Smem<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B * H, 4 * HD, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, state0, out, state_out, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* r, const void* k, const void* v,
             const float* logw, const float* u, const float* state0,
             float* out, float* state_out, int B, int S, int H,
             cudaStream_t s) {
  switch (hd) {
    case 16:  // the reduced smoke configs
      return launch<T, 16>(r, k, v, logw, u, state0, out, state_out, B, S, H,
                           s);
    case 64:  // rwkv6-1.6b
      return launch<T, 64>(r, k, v, logw, u, state0, out, state_out, B, S, H,
                           s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r/k/v [B, S, H, hd] of dtype (code as in common.cuh), logw [B, S, H, hd]
// fp32, u [H, hd] fp32, state0 and state_out [B, H, hd, hd] fp32, out
// [B, S, H, hd] fp32; all contiguous. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const float* logw, const float* u,
                        const float* state0, float* out, float* state_out,
                        int dtype, int hd, int B, int S, int H,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(hd, r, k, v, logw, u, state0, out,
                                   state_out, B, S, H, s);
  if (dtype == kFloat32)
    return dispatch<float>(hd, r, k, v, logw, u, state0, out, state_out, B,
                           S, H, s);
  return (int)cudaErrorInvalidValue;
}
