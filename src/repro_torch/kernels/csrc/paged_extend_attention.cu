// Chunk attention continued from a paged KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// paged_extend_attention (body _paged_ext_kernel): the chunk's queries
// q[b, i] (i < C, at logical positions pos[b] + i) attend to the row's
// cached keys j < pos[b], read through the block table from the page
// pools, and then to the chunk's own keys k_new[b, j] for j <= i (the
// causal triangle), fp32 online softmax, output in the input dtype.
// pos[b] is clamped to [0, W * page]; table entries are clamped to
// [0, num_pages - 1], so a masked row (all-sentinel table) reads the
// pool's last page and never faults; its output is the caller's to drop.
//
// What bounds it on the H100: for the short tails the serving path runs
// (C of 1 to 512 over up to 1024 cached tokens), the bytes of the cached
// pages and of q, k_new, v_new and out; at long chunks the C * (pos + C)
// * hd products. This first version does the products as fp32 FMAs on the
// CUDA cores, as the prefill kernel does (flash_attention.cu); wgmma tiles
// are later work. What the design does about the bound:
//  * one block per (64 rows of (query, grouped head), b * KVH + kvh): the
//    G query heads of a KV head share every K/V tile, read once per 64/G
//    queries;
//  * the page loop lives inside the block (the TPU kernel's sequential
//    page grid axis) and stops at pos[b]: pages past the cached length,
//    and the rest of the full-width table, cost nothing;
//  * the cached keys and the chunk's keys run as one key sequence
//    (pos[b] cached, then C new), staged 32 at a time in shared memory as
//    fp32, so one online-softmax pass covers both; the chunk part stops at
//    the diagonal of the block's last query.
// Inputs are strided views (last dim contiguous); the output is a
// contiguous [B, C, H, hd] tensor the wrapper allocated.

#include "common.cuh"

using namespace rt;

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows per block
constexpr int kKeys = 32;                     // keys per tile, one per lane

struct Strides {
  long long q_b, q_s, q_h;      // q [B, C, H, hd]
  long long k_p, k_t, k_h;      // pools [P, page, KVH, hd]
  long long v_p, v_t, v_h;
  long long kn_b, kn_s, kn_h;   // k_new / v_new [B, C, KVH, hd]
  long long vn_b, vn_s, vn_h;
  long long tab_b;              // table [B, W]
};

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
paged_extend_fwd(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ k_new,
                 const T* __restrict__ v_new, const int* __restrict__ table,
                 const int* __restrict__ pos, T* __restrict__ o, int C,
                 int H, int KVH, int W, int page, int num_pages, Strides st,
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
  const int rows_total = C * G;
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Q tile: row r is (query r / G, head kvh * G + r % G), scaled in fp32.
  for (int i = tid; i < kRows * HD; i += kWarps * 32) {
    const int fr = r0 + i / HD, d = i % HD;
    float x = 0.f;
    if (fr < rows_total) {
      const int qi = fr / G, h = kvh * G + fr % G;
      x = to_float(q[b * st.q_b + qi * st.q_s + h * st.q_h + d]) * scale;
    }
    Qs[i] = x;
  }

  // Keys: n_cached from the pages, then the chunk's own up to the
  // diagonal of the block's last query.
  const int n_cached = min(max(pos[b], 0), W * page);
  const int last_q = (min(r0 + kRows, rows_total) - 1) / G;
  const int n_keys = n_cached + min(C, last_q + 1);
  const int* trow = table + b * st.tab_b;

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

  const T* knb = k_new + b * st.kn_b + kvh * st.kn_h;
  const T* vnb = v_new + b * st.vn_b + kvh * st.vn_h;
  const float* Qw = Qs + warp * kRowsPerWarp * HD;
  float* Pw = Ps + warp * kRowsPerWarp * kKeys;

  for (int t0 = 0; t0 < n_keys; t0 += kKeys) {
    __syncthreads();  // Q stored; the previous tile fully consumed
    for (int i = tid; i < kKeys * HD; i += kWarps * 32) {
      const int j = i / HD, d = i % HD, key = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < n_cached) {
        const int pj = key / page, t = key - pj * page;
        const long long phys = min(max(trow[pj], 0), num_pages - 1);
        kx = to_float(k[phys * st.k_p + t * st.k_t + kvh * st.k_h + d]);
        vx = to_float(v[phys * st.v_p + t * st.v_t + kvh * st.v_h + d]);
      } else if (key < n_keys) {
        const int c = key - n_cached;
        kx = to_float(knb[c * st.kn_s + d]);
        vx = to_float(vnb[c * st.vn_s + d]);
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

    // Online softmax over the tile; masked keys get p = 0 exactly. A
    // cached key is seen by every query, the chunk's key c by queries >= c.
    const int key = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const bool valid = qpos[rr] >= 0 && key < n_keys &&
                         (key < n_cached || key - n_cached <= qpos[rr]);
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
    const int qi = fr / G, h = kvh * G + fr % G;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* orow = o + ((long long)(b * C + qi) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      orow[lane + 32 * i] = from_float<T>(acc[rr][i] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* k_new,
           const void* v_new, const void* table, const void* pos, void* o,
           int B, int C, int H, int KVH, int W, int page, int num_pages,
           const long long* s, float scale, cudaStream_t stream) {
  auto kern = paged_extend_fwd<T, HD>;
  const size_t smem = Smem<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int G = H / KVH;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                   s[8], s[9], s[10], s[11], s[12], s[13], s[14], s[15]};
  const dim3 grid((C * G + kRows - 1) / kRows, B * KVH);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<T*>(o), C, H, KVH, W, page,
      num_pages, st, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, C, H, hd]; pools [P, page, KVH, hd]; k_new/v_new [B, C, KVH, hd],
// all of one dtype (bf16 or fp32); table [B, W] int32; pos [B] int32;
// strides: 16 element strides (q, k, v, k_new, v_new over their first
// three dims, then the table's row stride). Returns the cudaError_t of
// the launch (0 on success).
extern "C" int paged_extend_attention_fwd(
    const void* q, const void* k, const void* v, const void* k_new,
    const void* v_new, const void* table, const void* pos, void* o,
    int dtype, int hd, int B, int C, int H, int KVH, int W, int page,
    int num_pages, const long long* strides, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_CASE(T, CODE, HDV)                                                 \
  if (dtype == CODE && hd == HDV)                                             \
    return launch<T, HDV>(q, k, v, k_new, v_new, table, pos, o, B, C, H, KVH, \
                          W, page, num_pages, strides, scale, s);
  RT_CASE(__nv_bfloat16, kBFloat16, 64)
  RT_CASE(__nv_bfloat16, kBFloat16, 128)
  RT_CASE(float, kFloat32, 64)
  RT_CASE(float, kFloat32, 128)
#undef RT_CASE
  return (int)cudaErrorInvalidValue;
}
