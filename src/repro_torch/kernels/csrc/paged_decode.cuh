// One-token GQA attention over a KV cache read through a block table, with
// optional int8 rows and an optional fresh token; shared by
// paged_decode_attention.cu (paged pools, fp or int8) and
// decode_attention_int8.cu (dense int8 caches: one "page" per row).
//
// out[b, h] = softmax over the cached keys j < len(b) of
//   q[b, h] . K(b, j, h // G) / sqrt(hd)   [and, if given, the fresh key]
// applied to the matching values, fp32 accumulation, output in q's dtype.
// K(b, j, kvh) is row j % page of physical page table[b, j / page]
// (dense: row j of batch row b), times its fp32 scale when the cache is
// int8. len(b) = lengths[b] clamped to [0, W * page]: a free slot's length
// grows past the table's width, and its table row is all sentinel.
// Table entries are clamped to [0, num_pages - 1], so the sentinel (one
// past the last real page) reads the pool's last page and never faults;
// what it reads lies past every live row's length. A row with nothing to
// attend to gives 0.
//
// What bounds it on the H100: the bytes of K/V (and scales) it streams,
// len * hd * 2 elements per (b, kvh); the products are 2 FLOP per element
// read, far below the ~295 FLOP/byte where the tensor cores would become
// the limit. What the design does about the bound:
//  * one block per (b, kvh) and group of up to 4 query heads, so the G
//    heads that share a KV head read its pages once;
//  * every lane reads 16 contiguous bytes of a key row (8 bf16, 4 fp32 or
//    16 int8 elements), kGroup lanes share one key, so a warp keeps
//    32 / kGroup keys in flight; int8 rows move half the bytes of bf16;
//  * the page loop lives inside the block (the TPU kernel's sequential
//    page grid axis) and stops at len: pages past a row's length, and
//    table columns past its reservation, are never read;
//  * online-softmax state stays in registers per lane group, merged once
//    at the end; the fresh token enters that merge as one more partial
//    state, so an int8 path attends to it at full precision.
#pragma once

#include "common.cuh"

namespace rt {
namespace paged {

constexpr int kWarps = 8;
constexpr int kHeads = 4;  // query heads per block

// Element strides, in elements of each tensor.
struct Strides {
  long long q_b, q_h;           // q [B, H, hd]
  long long k_p, k_t, k_h;      // k pool [P, page, KVH, hd] / cache [B, S, ..]
  long long v_p, v_t, v_h;
  long long ks_p, ks_t, ks_h;   // scales [P, page, KVH] (int8 only)
  long long vs_p, vs_t, vs_h;
  long long kn_b, kn_h;         // fresh k [B, KVH, hd] (optional)
  long long vn_b, vn_h;
  long long tab_b;              // table [B, W]
};
constexpr int kNumStrides = 19;

inline Strides strides_from(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
                 s[10], s[11], s[12], s[13], s[14], s[15], s[16], s[17],
                 s[18]};
}

template <typename Q, typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_fwd(const Q* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ table,
                 const int* __restrict__ lengths, const Q* __restrict__ k_new,
                 const Q* __restrict__ v_new, Q* __restrict__ o, int H,
                 int KVH, int W, int page, int num_pages, Strides st,
                 float scale) {
  constexpr int kPer = 16 / sizeof(T);      // elements of a row per lane
  constexpr int kGroup = HD / kPer;         // lanes that share one key
  static_assert(kGroup >= 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
                "a key row spans a power-of-2 number of lanes");
  constexpr int kKeysPerWarp = 32 / kGroup;
  constexpr int kParts = kWarps + 1;        // the warps' states + fresh
  __shared__ float sm_m[kParts][kHeads];
  __shared__ float sm_l[kParts][kHeads];
  __shared__ float sm_acc[kParts][kHeads][HD];

  const int G = H / KVH;
  const int b = blockIdx.x / KVH;
  const int kvh = blockIdx.x % KVH;
  const int g0 = blockIdx.y * kHeads;
  const int ng = min(kHeads, G - g0);
  const int len = min(max(lengths[b], 0), W * page);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / kGroup;   // which of the warp's keys
  const int sl = lane % kGroup;    // which slice of the row
  const int h0 = kvh * G + g0;

  float qr[kHeads][kPer];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    if (g < ng) {
      load_vec<kPer>(q + b * st.q_b + (h0 + g) * st.q_h + sl * kPer, qr[g]);
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

  const int* trow = table ? table + b * st.tab_b : nullptr;
  // base is uniform across the warp, so every lane reaches the shuffles
  for (int base = warp * kKeysPerWarp; base < len;
       base += kWarps * kKeysPerWarp) {
    const int key = base + sub;
    const bool valid = key < len;
    float kv[kPer], vv[kPer];
    float k_sc = 1.f, v_sc = 1.f;
    if (valid) {
      const int j = key / page;
      const int t = key - j * page;
      const long long phys =
          trow ? (long long)min(max(trow[j], 0), num_pages - 1) : b;
      load_vec<kPer>(k + phys * st.k_p + t * st.k_t + kvh * st.k_h + sl * kPer,
                     kv);
      load_vec<kPer>(v + phys * st.v_p + t * st.v_t + kvh * st.v_h + sl * kPer,
                     vv);
      if (ks != nullptr) {
        k_sc = ks[phys * st.ks_p + t * st.ks_t + kvh * st.ks_h];
        v_sc = vs[phys * st.vs_p + t * st.vs_t + kvh * st.vs_h];
      }
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
      s[g] = x * k_sc;
    }
    if (valid) {
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        const float m_new = fmaxf(m[g], s[g]);
        const float corr = expf(m[g] - m_new);
        const float p = expf(s[g] - m_new);
        const float pv = p * v_sc;
        l[g] = l[g] * corr + p;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[g][e] = acc[g][e] * corr + pv * vv[e];
      }
    }
  }

  // Merge the warp's key groups (lanes sl, sl + kGroup, ...).
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
  // The fresh token as one more partial state: m = its score, l = 1,
  // acc = its value (or an empty state when there is none).
  if (warp == 0) {
    const Q* kn = k_new ? k_new + b * st.kn_b + kvh * st.kn_h : nullptr;
    const Q* vn = v_new ? v_new + b * st.vn_b + kvh * st.vn_h : nullptr;
    for (int g = 0; g < kHeads; ++g) {
      float x = 0.f;
      if (kn != nullptr && g < ng)
        for (int d = lane; d < HD; d += 32)
          x += to_float(q[b * st.q_b + (h0 + g) * st.q_h + d]) * to_float(kn[d]);
      x = warp_sum(x) * scale;
      if (lane == 0) {
        sm_m[kWarps][g] = kn != nullptr ? x : kNegInf;
        sm_l[kWarps][g] = kn != nullptr ? 1.f : 0.f;
      }
      for (int d = lane; d < HD; d += 32)
        sm_acc[kWarps][g][d] = vn != nullptr ? to_float(vn[d]) : 0.f;
    }
  }
  __syncthreads();

  // Merge the parts; one thread per (head, dim).
  for (int i = threadIdx.x; i < ng * HD; i += kWarps * 32) {
    const int g = i / HD, d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kParts; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kParts; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    o[((long long)b * H + h0 + g) * HD + d] =
        from_float<Q>(a / fmaxf(lsum, 1e-30f));
  }
}

// table == nullptr: a dense cache, batch row b is "page" b of W = 1 page
// of ``page`` = S tokens. Returns the cudaError_t of the launch.
template <typename Q, typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* lengths,
           const void* k_new, const void* v_new, void* o, int B, int H,
           int KVH, int W, int page, int num_pages, const long long* st,
           float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const dim3 grid(B * KVH, (G + kHeads - 1) / kHeads);
  paged_decode_fwd<Q, T, HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const Q*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<const Q*>(k_new),
      static_cast<const Q*>(v_new), static_cast<Q*>(o), H, KVH, W, page,
      num_pages, strides_from(st), scale);
  return (int)cudaGetLastError();
}

// The int8-cache instantiations, by the dtype code of q and hd.
inline int launch_int8(int qdtype, int hd, const void* q, const void* k,
                       const void* v, const void* ks, const void* vs,
                       const void* table, const void* lengths,
                       const void* k_new, const void* v_new, void* o, int B,
                       int H, int KVH, int W, int page, int num_pages,
                       const long long* st, float scale, cudaStream_t s) {
#define RT_INT8_CASE(QT, QCODE, HDV)                                         \
  if (qdtype == QCODE && hd == HDV)                                          \
    return launch<QT, int8_t, HDV>(q, k, v, ks, vs, table, lengths, k_new,   \
                                   v_new, o, B, H, KVH, W, page, num_pages,  \
                                   st, scale, s);
  RT_INT8_CASE(__nv_bfloat16, kBFloat16, 64)
  RT_INT8_CASE(__nv_bfloat16, kBFloat16, 128)
  RT_INT8_CASE(float, kFloat32, 64)
  RT_INT8_CASE(float, kFloat32, 128)
#undef RT_INT8_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace paged
}  // namespace rt
