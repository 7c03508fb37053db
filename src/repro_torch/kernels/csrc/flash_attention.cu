// Causal GQA prefill attention for Hopper (sm_90a), online softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (body _fa_kernel): out[b, i, h] = softmax(q[b, i, h] . k[b, j, h // G] /
// sqrt(hd), masked to j <= i or j < prefix_len) @ v[b, :, h // G], fp32
// softmax state, output in the input dtype; a row with nothing visible
// gives 0.
//
// What bounds it on the H100: at long prompts the Sq*Sk*hd dot products
// (compute); at short prompts the bytes of q, k, v and out (memory). This
// first version does the products as fp32 FMAs on the CUDA cores, not on
// the tensor cores, so at long prompts it sits far below the 989 TFLOP/s
// bf16 bound; wgmma tiles are later work. What the design does about the
// bound:
//  * one block per (64 rows of (query, grouped head), b * KVH + kvh): the
//    G query heads of a KV head share every K/V tile, so K/V are read from
//    device memory once per 64/G queries, not once per query head;
//  * K/V tiles of 32 keys are staged in shared memory as fp32; each lane
//    of a warp owns one key for QK^T (float4 reads of a padded K row, no
//    bank conflicts) and one slice of hd for PV;
//  * the key loop stops at the causal diagonal of the block's last query
//    (or at the prefix), so a causal prompt does about half the work;
//  * any Sq, Sk and G: rows and keys past the ragged edge are masked here.
// Inputs are strided [B, S, heads, hd] views (last dim contiguous); the
// output is a contiguous [B, Sq, H, hd] tensor the wrapper allocated.

#include "common.cuh"

using namespace rt;

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows per block
constexpr int kKeys = 32;                     // keys per tile, one per lane

template <int HD>
struct Smem {
  static constexpr int kStride = HD + 4;  // padded K row
  static constexpr int q = 0;
  static constexpr int k = q + kRows * HD;
  static constexpr int v = k + kKeys * kStride;
  static constexpr int p = v + kKeys * HD;
  static constexpr int floats = p + kRows * kKeys;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int KVH, long long q_sb, long long q_ss, long long q_sh,
          long long k_sb, long long k_ss, long long k_sh, long long v_sb,
          long long v_ss, long long v_sh, int causal, int prefix_len,
          float scale) {
  using L = Smem<HD>;
  constexpr int kPer = HD / 32;  // output dims per lane
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* Qs = smem + L::q;
  float* Ks = smem + L::k;
  float* Vs = smem + L::v;
  float* Ps = smem + L::p;

  const int G = H / KVH;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y % KVH;
  const int rows_total = Sq * G;
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Q tile: row r is (query r / G, head kvh * G + r % G), scaled in fp32.
  for (int i = tid; i < kRows * HD; i += kWarps * 32) {
    const int fr = r0 + i / HD, d = i % HD;
    float x = 0.f;
    if (fr < rows_total) {
      const int qp = fr / G, h = kvh * G + fr % G;
      x = to_float(q[b * q_sb + qp * q_ss + h * q_sh + d]) * scale;
    }
    Qs[i] = x;
  }

  // Keys this block needs: up to the diagonal of its last query, or the
  // prefix, whichever is longer.
  const int last_q = (min(r0 + kRows, rows_total) - 1) / G;
  const int n_keys = causal ? min(Sk, max(last_q + 1, prefix_len)) : Sk;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPer];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int fr = r0 + warp * kRowsPerWarp + rr;
    qpos[rr] = fr < rows_total ? fr / G : -1;
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[rr][i] = 0.f;
  }

  const T* kbase = k + b * k_sb + kvh * k_sh;
  const T* vbase = v + b * v_sb + kvh * v_sh;
  const float* Qw = Qs + warp * kRowsPerWarp * HD;
  float* Pw = Ps + warp * kRowsPerWarp * kKeys;

  for (int t0 = 0; t0 < n_keys; t0 += kKeys) {
    __syncthreads();  // Q stored; the previous tile fully consumed
    for (int i = tid; i < kKeys * HD; i += kWarps * 32) {
      const int j = i / HD, d = i % HD, key = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < n_keys) {
        kx = to_float(kbase[key * k_ss + d]);
        vx = to_float(vbase[key * v_ss + d]);
      }
      Ks[j * L::kStride + d] = kx;
      Vs[j * HD + d] = vx;
    }
    __syncthreads();

    // QK^T: lane j scores key t0 + j against the warp's rows.
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
    const float* krow = Ks + lane * L::kStride;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 q4 = *reinterpret_cast<const float4*>(Qw + rr * HD + d);
        s[rr] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
      }
    }

    // Online softmax over the tile; masked keys get p = 0 exactly.
    const int key = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const bool valid = qpos[rr] >= 0 && key < n_keys &&
                         (!causal || key <= qpos[rr] || key < prefix_len);
      const float sv = valid ? s[rr] : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(sv));
      const float corr = expf(m[rr] - m_new);
      const float p = valid ? expf(sv - m_new) : 0.f;
      l[rr] = l[rr] * corr + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[rr][i] *= corr;
      Pw[rr * kKeys + lane] = p;
    }
    __syncwarp();

    // PV: lane owns output dims lane + 32 * i.
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float vv[4][kPer];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          vv[jj][i] = Vs[(j + jj) * HD + lane + 32 * i];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 p4 = *reinterpret_cast<const float4*>(Pw + rr * kKeys + j);
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          acc[rr][i] += p4.x * vv[0][i] + p4.y * vv[1][i] + p4.z * vv[2][i] +
                        p4.w * vv[3][i];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int fr = r0 + warp * kRowsPerWarp + rr;
    if (fr >= rows_total) continue;
    const int qp = fr / G, h = kvh * G + fr % G;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* orow = o + ((long long)(b * Sq + qp) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      orow[lane + 32 * i] = from_float<T>(acc[rr][i] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KVH, const long long* st, int causal,
           int prefix_len, float scale, cudaStream_t stream) {
  auto kern = flash_fwd<T, HD>;
  const size_t smem = Smem<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int G = H / KVH;
  const dim3 grid((Sq * G + kRows - 1) / kRows, B * KVH);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KVH, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      prefix_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: element strides of q, k, v over (batch, seq, head), 9 values.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int hd,
                                   int B, int Sq, int Sk, int H, int KVH,
                                   const long long* strides, int causal,
                                   int prefix_len, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, KVH, strides,
                                     causal, prefix_len, scale, s);
  if (dtype == kBFloat16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, H, KVH, strides,
                                      causal, prefix_len, scale, s);
  if (dtype == kFloat32 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, Sq, Sk, H, KVH, strides, causal,
                             prefix_len, scale, s);
  if (dtype == kFloat32 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, Sq, Sk, H, KVH, strides, causal,
                              prefix_len, scale, s);
  return (int)cudaErrorInvalidValue;
}
