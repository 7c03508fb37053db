// One-token GQA attention over a ragged dense KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:decode_attention
// (body _dec_kernel): out[b, h] = softmax(q[b, h] . k[b, j, h // G] /
// sqrt(hd) over j < lengths[b]) @ v[b, :, h // G], fp32 accumulation,
// output in the input dtype. ``lengths`` counts the token the caller has
// just inserted, and is clamped to [0, S]; a row of length 0 gives 0.
//
// What bounds it on the H100: the bytes of K/V it streams, 2 * len * hd
// elements per (b, kvh); the products are 2 FLOP per byte read, far below
// the ~295 FLOP/byte where the tensor cores would become the limit. What
// the design does about the bound:
//  * one block per (b, kvh) and group of up to 4 query heads, so the G
//    heads that share a KV head read its cache once;
//  * 8 warps split the keys; within a warp, 8 lanes share one key and each
//    lane reads 16 contiguous bytes of its row (one vector load per row
//    slice), so a warp keeps 4 keys in flight;
//  * every lane group keeps its own online-softmax state in registers; the
//    states are merged once, at the end (shuffles across the warp, then
//    shared memory across the warps), so nothing goes back to device
//    memory until the output;
//  * only min(len, S) keys are read: a short row costs what it holds.
// Inputs are strided views (last dim contiguous, rows 16-byte aligned);
// the output is a contiguous [B, H, hd] tensor the wrapper allocated.

#include "common.cuh"

using namespace rt;

namespace {

constexpr int kWarps = 8;
constexpr int kGroup = 8;              // lanes that share one key
constexpr int kKeysPerWarp = 32 / kGroup;
constexpr int kHeads = 4;              // query heads per block

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ lengths,
           T* __restrict__ o, int S, int H, int KVH, long long q_sb,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, float scale) {
  constexpr int kPer = HD / kGroup;  // elements of a row per lane
  __shared__ float sm_m[kWarps][kHeads];
  __shared__ float sm_l[kWarps][kHeads];
  __shared__ float sm_acc[kWarps][kHeads][HD];

  const int G = H / KVH;
  const int b = blockIdx.x / KVH;
  const int kvh = blockIdx.x % KVH;
  const int g0 = blockIdx.y * kHeads;
  const int ng = min(kHeads, G - g0);
  const int len = min(max(lengths[b], 0), S);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / kGroup;   // which of the warp's keys
  const int sl = lane % kGroup;    // which slice of the row
  const int h0 = kvh * G + g0;

  float qr[kHeads][kPer];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    if (g < ng) {
      load_vec<kPer>(q + b * q_sb + (h0 + g) * q_sh + sl * kPer, qr[g]);
#pragma unroll
      for (int e = 0; e < kPer; ++e) qr[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) qr[g][e] = 0.f;
    }
  }

  float m[kHeads], l[kHeads], acc[kHeads][kPer];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[g][e] = 0.f;
  }

  const T* kb = k + b * k_sb + kvh * k_sh + sl * kPer;
  const T* vb = v + b * v_sb + kvh * v_sh + sl * kPer;
  // base is uniform across the warp, so every lane reaches the shuffles
  for (int base = warp * kKeysPerWarp; base < len;
       base += kWarps * kKeysPerWarp) {
    const int key = base + sub;
    const bool valid = key < len;
    float kv[kPer], vv[kPer];
    if (valid) {
      load_vec<kPer>(kb + key * k_ss, kv);
      load_vec<kPer>(vb + key * v_ss, vv);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) kv[e] = vv[e] = 0.f;
    }
    float s[kHeads];
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) x += qr[g][e] * kv[e];
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      s[g] = x;
    }
    if (valid) {
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        const float m_new = fmaxf(m[g], s[g]);
        const float corr = expf(m[g] - m_new);
        const float p = expf(s[g] - m_new);
        l[g] = l[g] * corr + p;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[g][e] = acc[g][e] * corr + p * vv[e];
      }
    }
  }

  // Merge the warp's key groups (lanes sl, sl+8, sl+16, sl+24).
#pragma unroll
  for (int off = kGroup; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], m_o);
      const float a = expf(m[g] - mx), c = expf(m_o - mx);
      l[g] = l[g] * a + l_o * c;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + acc_o * c;
      }
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      if (sl == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) sm_acc[warp][g][sl * kPer + e] = acc[g][e];
    }
  }
  __syncthreads();

  // Merge the warps; one thread per (head, dim).
  for (int i = threadIdx.x; i < ng * HD; i += kWarps * 32) {
    const int g = i / HD, d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    o[((long long)b * H + h0 + g) * HD + d] = from_float<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, int B, int S, int H, int KVH, const long long* st,
           float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const dim3 grid(B * KVH, (G + kHeads - 1) / kHeads);
  decode_fwd<T, HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), S, H, KVH,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: element strides of q over (batch, head) and of the k and v
// caches over (batch, seq, head), 8 values. lengths: [B] int32 on device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int dtype, int hd, int B, int S,
                                    int H, int KVH, const long long* strides,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == kBFloat16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, len, o, B, S, H, KVH, strides,
                                     scale, s);
  if (dtype == kBFloat16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, len, o, B, S, H, KVH, strides,
                                      scale, s);
  if (dtype == kFloat32 && hd == 64)
    return launch<float, 64>(q, k, v, len, o, B, S, H, KVH, strides, scale, s);
  if (dtype == kFloat32 && hd == 128)
    return launch<float, 128>(q, k, v, len, o, B, S, H, KVH, strides, scale,
                              s);
  return (int)cudaErrorInvalidValue;
}
