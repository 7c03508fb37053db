// One-token GQA attention over a KV cache, for Hopper (sm_90a): the one
// body behind four entry points,
//   decode_attention.cu        kernel 2, a dense bf16/fp32 cache;
//   decode_attention_int8.cu   kernel 3, a dense int8 cache + fresh token;
//   paged_decode_attention.cu  kernel 4, paged pools, fp or int8 (4-int8).
// A dense cache is read as W = 1 page of S tokens per batch row, with no
// table; the kPaged template flag tells the two apart (and keeps their
// names apart in a profile).
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
// What bounds it on the H100: the bytes of the live keys' K/V rows (and
// scales), len * hd * 2 elements per (b, kvh), ~2.5 us at the serving
// shape (8 rows of up to 1024 keys). The products are 2 FLOP per byte
// read, far below the ~295 FLOP/byte where the tensor cores would become
// the limit, so they stay on the CUDA cores: mma would buy nothing against
// the bytes. What held the first version (one block per row and KV head,
// 64 blocks at the serving shape, each walking its keys 32 at a time, a
// device-memory latency a round) was latency. The design:
//  * flash-decoding: a row's keys are cut into fixed-length splits,
//    kSplitKeys (128, 8 pages of 16), or, above kMaxSplits x 128 keys of
//    capacity, capacity / kMaxSplits rounded up to 32 keys. The cut comes
//    from the capacity (W * page) alone: never from the lengths (on the
//    device) or from B. The splits of a (row, KV head, group of up to
//    kHeads query heads) form one thread-block cluster, so the G heads of
//    a KV head still share one read of its rows. One launch, no scratch
//    memory, no atomics, no host read. At most 96 registers a thread, so
//    kMinBlocks blocks fit an SM and the 64 clusters of 8 rows x 8 KV heads
//    run in one wave (hd 256: 168 registers, three blocks an SM);
//  * one memory latency a split: a block stages the table entries its
//    split can touch into shared memory (clamped), while its length and q
//    load, and then issues the split's K rows, then its V rows (and the
//    int8 scales) by 16- and 4-byte cp.async into one chunk of shared
//    memory of at most kRingBudget bytes (a whole 128-key split at bf16 or
//    int8 and hd 64, and int8 hd 128; longer splits stream chunk by chunk),
//    so no copy waits on a table load. A split past its row's length copies
//    nothing and leaves an empty partial (m = -1e30, l = 0);
//  * the chunk in two passes, fp32 throughout: QK by lane groups (kGroup
//    lanes share a key, each holding 8 elements of its row, 4 at fp32 hd
//    64 and 128, and of the kHeads query rows), their partial dot
//    products reduced and scattered over the group's lanes by a butterfly
//    (log2(kGroup) + 1 shuffles for all kHeads heads) into a score table;
//    then a softmax of each head by one warp, continuing a running (m, l),
//    with the scale folded into one FFMA before ex2; then PV with each
//    warp summing a
//    quarter of the keys into every lane's hd / 32 columns of all heads.
//    QK and the softmax run while the V rows still arrive. The warps' sums
//    add up in warp order into the block's partial;
//  * the partials meet in the cluster's leader (split 0): the other blocks
//    write theirs into its shared memory through distributed shared memory
//    once every block of the cluster has started (phase 1 of a split-phase
//    cluster barrier), arrive at phase 2 and leave; the leader waits for
//    phase 2 and combines the partials in split order, the fresh token of
//    the int8 forms (computed by the leader while its copies fly) as one
//    more partial after the splits. With one split there is no cluster:
//    the same combine reads the block's own partial.
// hd 112 (zamba2's shared attention; dense caches only, kernels 2 and 3):
// the lanes and shared memory are laid out as at hd 128 (kHDP), each row
// padded to 128 columns in shared memory. The copies of a row's last 16
// columns (2 of 16 chunks at bf16, 4 of 32 at fp32, 1 of 8 at int8) are
// predicated off and zero-fill, so they add nothing to QK or PV; q's last
// lanes load zeros; the combine and the store cover the 112 real columns.
// So a row's bits depend on its own length, data, capacity and page, never
// on B or on other rows; and, for capacities up to kMaxSplits x 128 keys
// (the whole serving range), not on W either: a wider table only adds
// empty partials, which add exact zeros.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace rt {
namespace paged {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kHeads = 4;                 // query heads per block
constexpr int kSplitKeys = 128;           // the shortest split
constexpr int kMaxSplits = 8;             // the portable cluster size
constexpr int kRingBudget = 32 * 1024;    // K/V bytes a chunk may take
constexpr int kMinBlocks = 5;             // blocks an SM holds (hd <= 128)

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

// The lane width of a head dim: hd itself, or 128 for hd 112
constexpr int padded_width(int hd) { return hd == 112 ? 128 : hd; }

// The lane layout and the shared-memory layout of one (cache type, hd).
template <typename T, int HD>
struct Cfg {
  static constexpr bool kScaled = sizeof(T) == 1;    // int8 rows + scales
  // the lanes' and shared memory's row width, HD or past it (zero columns)
  static constexpr int kHDP = padded_width(HD);
  // QK: kGroup lanes share a key, each holding kPer elements of its row
  // and of the kHeads query rows: 8 (one 16-byte load at bf16, 8 bytes at
  // int8), 4 at fp32 (one float4), 8 at fp32 hd 256 (two float4)
  static constexpr int kPer =
      sizeof(T) == 4 ? (kHDP / 32 > 4 ? kHDP / 32 : 4) : 8;
  static constexpr int kGroup = kHDP / kPer;
  static_assert(kGroup >= 8 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
                "a key row spans 8, 16 or 32 lanes");
  static constexpr int kKeysPerWarp = 32 / kGroup;
  static constexpr int kKeysPerRound = kWarps * kKeysPerWarp;
  // PV: a lane owns kDL columns of every head, a warp a quarter of the keys
  static constexpr int kDL = kHDP / 32;
  // bytes of a K or V row in shared memory, and its 16-byte copies; of
  // those, the first kChunksHD hold the row's HD columns
  static constexpr int kRow = kHDP * (int)sizeof(T);
  static constexpr int kChunks = kRow / 16;
  static constexpr int kChunksHD = HD * (int)sizeof(T) / 16;
  static_assert(HD * (int)sizeof(T) % 16 == 0, "rows of whole 16 bytes");
  // keys a chunk holds: a whole shortest split where kRingBudget allows
  static constexpr int kChunk =
      kRingBudget / (2 * kRow) < kSplitKeys ? kRingBudget / (2 * kRow)
                                            : kSplitKeys;
  // QK takes kSteps rounds at a time, PV kBatch keys at a time
  static constexpr int kSteps =
      kChunk / kKeysPerRound < 4 ? kChunk / kKeysPerRound : 4;
  static constexpr int kBatch = kDL == 2 ? 8 : 4;
  static_assert(kChunk % (kSteps * kKeysPerRound) == 0 &&
                    (kChunk / kWarps) % kBatch == 0,
                "QK steps and PV batches cover a chunk");
  static constexpr int kKV = kChunk * kRow;          // bytes of a K or V chunk
  static constexpr int kv = 0;                       // K chunk, then V chunk
  static constexpr int scales = 2 * kKV;             // int8: K, V scales
  static constexpr int p = scales + (kScaled ? 2 * kChunk * 4 : 0);
  // a partial state: O [kHeads][kHDP], then m [kHeads], l [kHeads]
  static constexpr int kPart = kHeads * (kHDP + 2);
  static_assert(kWarps == kHeads, "softmax: one warp a head");
  static_assert(kWarps * kHeads * kHDP * 4 <= kKV,
                "the warps' PV sums fit the K chunk");
  static constexpr int corr = p + kChunk * kHeads * 4;  // per-head factors
  // partials: one per split (the leader's receive every split's; another
  // block uses its own split's slot), then the fresh token's
  static constexpr int slots = corr + 16;
  static constexpr int tab = slots + (kMaxSplits + 1) * kPart * 4;  // ints
  // at hd 256 q (kHeads x kPer), a QK step's rows and the PV sums (kHeads x
  // kDL) take 32 registers each: three blocks an SM (168 registers a
  // thread; their ~70 KB of shared memory allows no more)
  static constexpr int kMinBlocks = kHDP == 256 ? 3 : paged::kMinBlocks;
};

// How a call is cut: key splits (the cluster size) and their length, the
// table entries a split can touch, the dynamic shared memory.
struct Plan {
  int splits, split_len, n_tab, smem;
};

template <typename T, int HD>
Plan plan_for(int W, int page) {
  constexpr int kTile = 32;  // a longer split rounds up to whole 32 keys
  Plan p;
  const long long cap = (long long)W * page;  // a row's keys at most
  long long len = kSplitKeys;
  if (cap > (long long)kMaxSplits * kSplitKeys) {
    const long long per = (cap + kMaxSplits - 1) / kMaxSplits;
    len = (per + kTile - 1) / kTile * kTile;
  }
  p.split_len = (int)len;
  p.splits = (int)((cap + len - 1) / len);
  const long long tab = (len + page - 1) / page + 1;  // pages a split touches
  p.n_tab = (int)(tab < W ? tab : W);
  p.smem = Cfg<T, HD>::tab + (p.n_tab * 4 + 15) / 16 * 16;
  return p;
}

// kPer elements of a K row in shared memory, widened to fp32 (the int8
// slice is 8 bytes)
template <int N>
__device__ __forceinline__ void row_slice(const int8_t* p, float* out) {
  static_assert(N == 8, "int8 rows: 8 elements a lane");
  const int2 t = *reinterpret_cast<const int2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&t);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = static_cast<float>(c[j]);
}
template <int N, typename T>
__device__ __forceinline__ void row_slice(const T* p, float* out) {
  load_vec<N>(p, out);
}

// N = 2, 4 or 8 consecutive elements of a V row in shared memory, as fp32
template <int N>
__device__ __forceinline__ void col_slice(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = t.x, out[4 * i + 1] = t.y, out[4 * i + 2] = t.z,
              out[4 * i + 3] = t.w;
    }
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x, out[1] = t.y;
  }
}
template <int N>
__device__ __forceinline__ void col_slice(const __nv_bfloat16* p,
                                          float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}
template <int N>
__device__ __forceinline__ void col_slice(const int8_t* p, float* out) {
  if constexpr (N == 8) {
    const int2 t = *reinterpret_cast<const int2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&t);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
  } else if constexpr (N == 4) {
    const int t = *reinterpret_cast<const int*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = static_cast<float>(c[i]);
  } else {
    const short t = *reinterpret_cast<const short*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&t);
    out[0] = static_cast<float>(c[0]), out[1] = static_cast<float>(c[1]);
  }
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

// the two halves of the cluster barrier (sm_90): arrive (relaxed: no
// memory ordering; release: this thread's earlier writes, distributed
// shared memory included, are visible to the threads that wait) and wait
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the scaled maximum subtracted before ex2; an all-empty state (mx =
// -1e30) subtracts 0, so every weight it gives is 0
__device__ __forceinline__ float base_of(float mx, float c) {
  return mx == kNegInf ? 0.f : mx * c;
}

template <typename Q, typename T, int HD, bool kPaged>
__global__ void __launch_bounds__(kThreads, Cfg<T, HD>::kMinBlocks)
decode_split_fwd(const Q* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ table,
                 const int* __restrict__ lengths, const Q* __restrict__ k_new,
                 const Q* __restrict__ v_new, Q* __restrict__ o, int H,
                 int KVH, int W, int page, int num_pages, Strides st,
                 int n_split, int split_len, float scale_log2) {
  using C = Cfg<T, HD>;
  constexpr int kPer = C::kPer, kGroup = C::kGroup, kDL = C::kDL;
  constexpr int kHDP = C::kHDP;
  constexpr int kChunk = C::kChunk;
  extern __shared__ float4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const T* Kc = reinterpret_cast<const T*>(smem + C::kv);
  const T* Vc = reinterpret_cast<const T*>(smem + C::kv + C::kKV);
  const float* KSc = reinterpret_cast<const float*>(smem + C::scales);
  const float* VSc = KSc + kChunk;
  float* Pr = reinterpret_cast<float*>(smem + C::p);   // [kChunk][kHeads]
  float* Corr = reinterpret_cast<float*>(smem + C::corr);
  float* Slots = reinterpret_cast<float*>(smem + C::slots);
  int* tab = reinterpret_cast<int*>(smem + C::tab);

  namespace cg = cooperative_groups;
  const int split =
      n_split > 1 ? (int)cg::this_cluster().block_rank() : 0;
  // phase 1 of the cluster barrier: this block has started (its shared
  // memory may be written by the others once phase 1 completes)
  if (n_split > 1) cluster_arrive_relaxed();
  float* Part = Slots + split * C::kPart;                 // this split's
  float* Fresh = Slots + kMaxSplits * C::kPart;           // the fresh token's
  const int row = blockIdx.x / n_split;  // b * KVH + kvh
  const int b = row / KVH, kvh = row % KVH;
  const int G = H / KVH;
  const int g0 = blockIdx.y * kHeads;
  const int ng = min(kHeads, G - g0);
  const int h0 = kvh * G + g0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane / kGroup;   // which of the warp's keys (QK)
  const int sl = lane % kGroup;    // which slice of the row (QK)
  const float c = scale_log2;

  // The split's keys [k_begin, k_begin + split_len) of a capacity of
  // W * page. Its length, its table entries and q load together.
  const long long cap = (long long)W * page;
  const int k_begin = split * split_len;
  const int raw_len = lengths[b];
  const int pg0 = k_begin / page;
  if (kPaged && k_begin < cap) {
    const long long last = min((long long)k_begin + split_len, cap) - 1;
    const int n_pg = (int)(last / page) - pg0 + 1;
    const int* trow = table + b * st.tab_b + pg0;
    for (int i = tid; i < n_pg; i += kThreads)
      tab[i] = min(max(trow[i], 0), num_pages - 1);
  }
  float qr[kHeads][kPer];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    if (g < ng && sl * kPer < HD) {
      load_vec<kPer>(q + b * st.q_b + (h0 + g) * st.q_h + sl * kPer, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) qr[g][e] = 0.f;
    }
  }
  const int len = (int)min((long long)max(raw_len, 0), cap);
  const int k_end = min(k_begin + split_len, len);
  const int n_keys = max(k_end - k_begin, 0);
  const int n_chunks = (n_keys + kChunk - 1) / kChunk;
  __syncthreads();  // the table slice is in shared memory

  // chunk ch of the split: 16-byte copies of its K rows, then of its V
  // rows (zero-filled past k_end), each with the int8 scales, as two
  // commit groups: QK and the softmax need only the first
  const T* kb = k + kvh * st.k_h;
  const T* vb = v + kvh * st.v_h;
  auto locate = [&](int key, long long& phys, int& tok) {
    phys = b;
    tok = key;
    if constexpr (kPaged) {
      const int pg = key / page;
      phys = tab[pg - pg0];
      tok = key - pg * page;
    }
  };
  auto load_chunk = [&](int ch) {
    const int key0 = k_begin + ch * kChunk;
    constexpr int kRowStep = kThreads / C::kChunks;  // rows a pass covers
    static_assert(kRowStep * C::kChunks == kThreads && kChunk % kRowStep == 0,
                  "every thread copies the same number of chunks");
    const int c16 = tid % C::kChunks;
    constexpr int kElems = 16 / (int)sizeof(T);  // elements a 16-byte copy
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // K, then V
      const T* base = half ? vb : kb;
      const long long sp = half ? st.v_p : st.k_p, stt = half ? st.v_t : st.k_t;
      char* dst = smem + C::kv + half * C::kKV;
#pragma unroll 4
      for (int j = tid / C::kChunks; j < kChunk; j += kRowStep) {
        const int key = key0 + j;
        const bool ok = key < k_end && c16 < C::kChunksHD;
        const T* src = base;
        if (ok) {
          long long phys;
          int tok;
          locate(key, phys, tok);
          src = base + phys * sp + tok * stt + c16 * kElems;
        }
        cp_async16(dst + j * C::kRow + c16 * 16, src, ok);
      }
      if constexpr (C::kScaled) {
        const float* sbase = half ? vs : ks;
        const long long ssp = half ? st.vs_p : st.ks_p;
        const long long sst = half ? st.vs_t : st.ks_t;
        const long long ssh = half ? st.vs_h : st.ks_h;
        for (int j = tid; j < kChunk; j += kThreads) {
          const int key = key0 + j;
          const bool ok = key < k_end;
          const float* src = sbase;
          if (ok) {
            long long phys;
            int tok;
            locate(key, phys, tok);
            src = sbase + phys * ssp + tok * sst + kvh * ssh;
          }
          cp_async4(smem + C::scales + (half * kChunk + j) * 4, src, ok);
        }
      }
      cp_async_commit();
    }
  };
  if (n_chunks > 0) load_chunk(0);

  // The fresh token as one more partial, in the leader (split 0), while
  // the copies are in flight: m = its score, l = 1 (implied), O = its value.
  const bool has_fresh = k_new != nullptr;
  if (has_fresh && split == 0 && warp == 0) {
    const Q* kn = k_new + b * st.kn_b + kvh * st.kn_h;
    const Q* vn = v_new + b * st.vn_b + kvh * st.vn_h;
    for (int g = 0; g < ng; ++g) {
      const Q* qh = q + b * st.q_b + (h0 + g) * st.q_h;
      float x = 0.f;
      for (int d = lane; d < HD; d += 32)
        x = fmaf(to_float(qh[d]), to_float(kn[d]), x);
      x = warp_sum(x);
      if (lane == 0) Fresh[kHeads * kHDP + g] = x;
      for (int d = lane; d < HD; d += 32)
        Fresh[g * kHDP + d] = to_float(vn[d]);
    }
  }

  // QK head (the butterfly below leaves head 2 * bit_a + bit_b with lane
  // sl), the softmax state of head `warp` (in that warp's registers) and
  // this lane's PV sums over its quarter of each chunk
  const bool bit_a = sl & (kGroup / 2), bit_b = sl & (kGroup / 4);
  const int qk_head = 2 * bit_a + bit_b;
  float m_run = kNegInf, l_run = 0.f;
  float acc[kHeads][kDL];
#pragma unroll
  for (int g = 0; g < kHeads; ++g)
#pragma unroll
    for (int d = 0; d < kDL; ++d) acc[g][d] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int n_valid = min(kChunk, n_keys - ch * kChunk);
    cp_async_wait<1>();
    __syncthreads();  // the chunk's K rows are in shared memory

    // scores of every valid key for the kHeads heads: each lane group's
    // partial dot products, reduced and scattered over its lanes so that
    // each lane ends with one head's score (log2(kGroup) + 1 shuffles);
    // kSteps rounds at a time, as independent chains (rows past n_valid
    // are zero-filled and their scores never read)
    for (int j0 = 0; j0 < n_valid; j0 += C::kSteps * C::kKeysPerRound) {
      float kv[C::kSteps][kPer];
#pragma unroll
      for (int r = 0; r < C::kSteps; ++r)
        row_slice<kPer>(Kc + (j0 + r * C::kKeysPerRound +
                              warp * C::kKeysPerWarp + sub) * kHDP +
                            sl * kPer,
                        kv[r]);
#pragma unroll
      for (int r = 0; r < C::kSteps; ++r) {
        const int j = j0 + r * C::kKeysPerRound + warp * C::kKeysPerWarp + sub;
        float x[kHeads];
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          x[g] = 0.f;
#pragma unroll
          for (int e = 0; e < kPer; ++e) x[g] = fmaf(qr[g][e], kv[r][e], x[g]);
        }
        const float ya = (bit_a ? x[2] : x[0]) +
            __shfl_xor_sync(0xffffffffu, bit_a ? x[0] : x[2], kGroup / 2);
        const float yb = (bit_a ? x[3] : x[1]) +
            __shfl_xor_sync(0xffffffffu, bit_a ? x[1] : x[3], kGroup / 2);
        float z = (bit_b ? yb : ya) +
            __shfl_xor_sync(0xffffffffu, bit_b ? ya : yb, kGroup / 4);
#pragma unroll
        for (int off = kGroup / 8; off > 0; off >>= 1)
          z += __shfl_xor_sync(0xffffffffu, z, off);
        if ((sl & (kGroup / 4 - 1)) == 0 && j < n_valid)
          Pr[j * kHeads + qk_head] = C::kScaled ? z * KSc[j] : z;
      }
    }
    __syncthreads();

    // softmax of head `warp` over the chunk, continuing its running state;
    // Pr becomes the probabilities, Corr the factor on the earlier sums (a
    // 16-key chunk, fp32 at hd 256, leaves half the lanes idle)
    {
      constexpr int kPerLane = (kChunk + 31) / 32;
      float sv[kPerLane], mx = m_run;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int j = lane + 32 * i;
        sv[i] = j < n_valid ? Pr[j * kHeads + warp] : kNegInf;
        mx = fmaxf(mx, sv[i]);
      }
      mx = warp_max(mx);
      const float base = base_of(mx, c);
      float lsum = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const float p = ex2(fmaf(sv[i], c, -base));  // 0 past n_valid
        lsum += p;
        const int j = lane + 32 * i;
        if (j < n_valid) Pr[j * kHeads + warp] = p;
      }
      const float corr = ex2(fmaf(m_run, c, -base));
      l_run = fmaf(l_run, corr, warp_sum(lsum));
      m_run = mx;
      if (lane == 0) Corr[warp] = corr;
    }
    cp_async_wait<0>();
    __syncthreads();  // the V rows too

    // PV: warp `warp` sums its quarter of the chunk's keys into this lane's
    // kDL columns of every head
    {
      float cr[kHeads];
#pragma unroll
      for (int g = 0; g < kHeads; ++g) cr[g] = Corr[g];
#pragma unroll
      for (int g = 0; g < kHeads; ++g)
#pragma unroll
        for (int d = 0; d < kDL; ++d) acc[g][d] *= cr[g];
      // kBatch keys at a time, their loads first; a key past n_valid (its
      // row zero-filled, its probability stale) weighs exactly 0
      constexpr int kQuarter = kChunk / kWarps;
      const int j_end = min(warp * kQuarter + kQuarter, n_valid);
      for (int j0 = warp * kQuarter; j0 < j_end; j0 += C::kBatch) {
        float vv[C::kBatch][kDL];
        float4 p4[C::kBatch];
        float vsc[C::kBatch];
#pragma unroll
        for (int u = 0; u < C::kBatch; ++u) {
          col_slice<kDL>(Vc + (j0 + u) * kHDP + lane * kDL, vv[u]);
          p4[u] = *reinterpret_cast<const float4*>(Pr + (j0 + u) * kHeads);
          vsc[u] = C::kScaled ? VSc[j0 + u] : 1.f;
        }
#pragma unroll
        for (int u = 0; u < C::kBatch; ++u) {
          const bool in = j0 + u < j_end;
          const float pg[kHeads] = {in ? p4[u].x * vsc[u] : 0.f,
                                    in ? p4[u].y * vsc[u] : 0.f,
                                    in ? p4[u].z * vsc[u] : 0.f,
                                    in ? p4[u].w * vsc[u] : 0.f};
#pragma unroll
          for (int g = 0; g < kHeads; ++g)
#pragma unroll
            for (int d = 0; d < kDL; ++d)
              acc[g][d] = fmaf(pg[g], vv[u][d], acc[g][d]);
        }
      }
    }
    if (ch + 1 < n_chunks) {
      __syncthreads();  // every warp is done with this chunk
      load_chunk(ch + 1);
    }
  }

  // The block's partial: the warps' PV sums added in warp order (through
  // the K chunk's memory), m and l from the softmax warps.
  // [kWarps][kHeads][kHDP]; the K chunk is free since the last QK's
  // barrier
  float* Red = reinterpret_cast<float*>(smem + C::kv);
#pragma unroll
  for (int g = 0; g < kHeads; ++g)
#pragma unroll
    for (int d = 0; d < kDL; ++d)
      Red[(warp * kHeads + g) * kHDP + lane * kDL + d] = acc[g][d];
  if (lane == 0) {
    Part[kHeads * kHDP + warp] = m_run;
    Part[kHeads * kHDP + kHeads + warp] = l_run;
  }
  __syncthreads();
  for (int i = tid; i < ng * kHDP; i += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += Red[w * kHeads * kHDP + i];
    Part[i] = a;
  }

  // Every split's partial into the leader's slots: the others write
  // theirs through distributed shared memory once every block has started,
  // then arrive at phase 2 and leave; the leader waits for phase 2.
  if (n_split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    __syncthreads();    // this block's partial is complete
    cluster_wait();     // phase 1: every block of the cluster has started
    if (split > 0) {
      float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(Part, 0));
      const float4* src = reinterpret_cast<const float4*>(Part);
      for (int i = tid; i < C::kPart / 4; i += kThreads) dst[i] = src[i];
    }
    cluster_arrive();   // phase 2 (release): this split's partial is there
    if (split > 0) return;
    cluster_wait();     // the leader: every split's partial is here
  } else {
    __syncthreads();
  }

  // The leader combines the splits' partials (and the fresh token's) in
  // split order, one thread per (head, column quad) of the HD real
  // columns, every partial's m, l and columns loaded first.
  constexpr int kQuads = HD / 4;
  const int n_part = n_split + (has_fresh ? 1 : 0);
  for (int it = tid; it < ng * kQuads; it += kThreads) {
    const int g = it / kQuads, c4 = (it % kQuads) * 4;
    float ms[kMaxSplits + 1], ls[kMaxSplits + 1];
    float4 xs[kMaxSplits + 1];
#pragma unroll
    for (int sp = 0; sp <= kMaxSplits; ++sp) {
      ms[sp] = kNegInf, ls[sp] = 0.f, xs[sp] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (sp < n_part) {  // split sp's partial, the fresh token's last
        const float* P = Slots + (sp < n_split ? sp : kMaxSplits) * C::kPart;
        ms[sp] = P[kHeads * kHDP + g];
        ls[sp] = sp < n_split ? P[kHeads * kHDP + kHeads + g] : 1.f;
        xs[sp] = *reinterpret_cast<const float4*>(P + g * kHDP + c4);
      }
    }
    float mt = kNegInf;
#pragma unroll
    for (int sp = 0; sp <= kMaxSplits; ++sp) mt = fmaxf(mt, ms[sp]);
    const float base = base_of(mt, c);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float lsum = 0.f;
#pragma unroll
    for (int sp = 0; sp <= kMaxSplits; ++sp) {
      if (sp >= n_part) break;
      const float f = ex2(fmaf(ms[sp], c, -base));
      lsum = fmaf(f, ls[sp], lsum);
      a.x = fmaf(f, xs[sp].x, a.x);
      a.y = fmaf(f, xs[sp].y, a.y);
      a.z = fmaf(f, xs[sp].z, a.z);
      a.w = fmaf(f, xs[sp].w, a.w);
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    store4(o + ((long long)b * H + h0 + g) * HD + c4,
           make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  }
}

// table == nullptr (kPaged false): a dense cache, batch row b is "page" b
// of W = 1 page of ``page`` = S tokens. Returns the cudaError_t of the
// launch: a cut whose cluster or shared memory cannot launch is an error.
template <typename Q, typename T, int HD, bool kPaged>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* lengths,
           const void* k_new, const void* v_new, void* o, int B, int H,
           int KVH, int W, int page, int num_pages, const long long* st,
           float scale, cudaStream_t stream) {
  const Plan p = plan_for<T, HD>(W, page);
  auto kern = decode_split_fwd<Q, T, HD, kPaged>;
  // past 48 KB of dynamic shared memory the kernel needs the attribute,
  // set once per instantiation and device for the largest cut so far (two
  // callers racing set it twice)
  static int granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (p.smem > 48 * 1024 && (dev >= 64 || granted[dev] < p.smem)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) granted[dev] = p.smem;
  }
  const int G = H / KVH;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits * B * KVH, (G + kHeads - 1) / kHeads);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;  // the splits of a row
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const Q*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<const Q*>(k_new),
      static_cast<const Q*>(v_new), static_cast<Q*>(o), H, KVH, W, page,
      num_pages, strides_from(st), p.splits, p.split_len,
      scale * 1.4426950408889634f);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The int8-cache instantiations, by the dtype code of q and hd (hd 112 for
// the dense cache only).
template <bool kPaged>
int launch_int8(int qdtype, int hd, const void* q, const void* k,
                const void* v, const void* ks, const void* vs,
                const void* table, const void* lengths, const void* k_new,
                const void* v_new, void* o, int B, int H, int KVH, int W,
                int page, int num_pages, const long long* st, float scale,
                cudaStream_t s) {
#define RT_INT8_CASE(QT, QCODE, HDV)                                         \
  if (qdtype == QCODE && hd == HDV)                                          \
    return launch<QT, int8_t, HDV, kPaged>(q, k, v, ks, vs, table, lengths,  \
                                           k_new, v_new, o, B, H, KVH, W,    \
                                           page, num_pages, st, scale, s);
  RT_INT8_CASE(__nv_bfloat16, kBFloat16, 64)
  RT_INT8_CASE(__nv_bfloat16, kBFloat16, 128)
  RT_INT8_CASE(__nv_bfloat16, kBFloat16, 256)
  RT_INT8_CASE(float, kFloat32, 64)
  RT_INT8_CASE(float, kFloat32, 128)
  RT_INT8_CASE(float, kFloat32, 256)
  if constexpr (!kPaged) {
    RT_INT8_CASE(__nv_bfloat16, kBFloat16, 112)
    RT_INT8_CASE(float, kFloat32, 112)
  }
#undef RT_INT8_CASE
  return (int)cudaErrorInvalidValue;
}

// The cut of a call, by the cache's dtype code and hd (0, or
// cudaErrorInvalidValue for one no entry point takes; hd 112 only the
// dense ones).
inline int plan(int cdtype, int hd, int W, int page, Plan* out) {
#define RT_PLAN_CASE(T, CODE, HDV)                                           \
  if (cdtype == CODE && hd == HDV) {                                         \
    *out = plan_for<T, HDV>(W, page);                                        \
    return 0;                                                                \
  }
  RT_PLAN_CASE(__nv_bfloat16, kBFloat16, 64)
  RT_PLAN_CASE(__nv_bfloat16, kBFloat16, 112)
  RT_PLAN_CASE(__nv_bfloat16, kBFloat16, 128)
  RT_PLAN_CASE(__nv_bfloat16, kBFloat16, 256)
  RT_PLAN_CASE(float, kFloat32, 64)
  RT_PLAN_CASE(float, kFloat32, 112)
  RT_PLAN_CASE(float, kFloat32, 128)
  RT_PLAN_CASE(float, kFloat32, 256)
  RT_PLAN_CASE(int8_t, kInt8, 64)
  RT_PLAN_CASE(int8_t, kInt8, 112)
  RT_PLAN_CASE(int8_t, kInt8, 128)
  RT_PLAN_CASE(int8_t, kInt8, 256)
#undef RT_PLAN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace paged
}  // namespace rt
