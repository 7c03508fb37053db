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
// * hd products; and, at short chunks, the serial chain of tiles along the
// longest row. A row's keys are one sequence: its pos[b] cached keys, then
// the chunk's own.
// bf16 (paged_extend_fwd_mma, the serving path), built from the prefill
// kernel's pieces (flash_attention.cu):
//  * rows are (query, grouped head), 16 per warp and four warps a block,
//    so the G heads of a KV head share every K/V tile (a decode-sized tail
//    pads its few rows: one-warp blocks were slower in every shape tried);
//  * S = Q K^T and O += P V by mma.sync m16n8k16 from ldmatrix fragments,
//    the online softmax on the accumulator layout with the scale folded
//    into one FFMA before ex2, P rounded to bf16 in registers, the row
//    sums as a ones column of the PV product;
//  * K/V tiles of 64 keys (4 pages of 16; 32 keys at hd 256, where Q stays
//    in shared memory, see MmaCfg) arrive in a ring of shared-memory
//    stages (three at hd 64, two at hd 128 and 256) by 16-byte cp.async, a
//    key row of one KV head being hd * 2 contiguous bytes of its page. A
//    block reads the table entries its keys touch into shared memory once,
//    before its first copy, so no copy waits on a table load;
//  * the key range is split across blocks (flash-decoding) when the chunk
//    has fewer than kSplitRowBlocks row blocks: fixed-length splits of
//    split_len keys (kSplitKeys, or (W * page + C) / 8 rounded up to a
//    tile, whichever is longer), from C, G, W and page only, never from pos
//    (on the device) or from B. The splits
//    of a row block form one thread-block cluster; each block leaves its
//    partial (m, l, O) in its shared memory, and after a cluster barrier
//    the cluster's blocks combine the partials of their share of the rows
//    through distributed shared memory in split order. No scratch memory,
//    no atomics, one launch. A split past its rows' keys runs no tile and
//    leaves an empty partial. A row's output thus depends on its own pos,
//    its data, C, W and page, not on B or on other rows;
//  * tiles below every row's limit take a path without the mask;
//  * row starts that are not 16-byte aligned (odd strides or offsets of a
//    view) take an instantiation with scalar loads into the same ring,
//    chosen in the C launcher.
// fp32 keeps the first version's FMA body below (the serving path is
// bf16): plain TF32 operands cannot meet the fp32 checks (2e-5), and a
// 3xTF32 form like wkv6.cu's is later work.
// Inputs are strided views (last dim contiguous); the output is a
// contiguous [B, C, H, hd] tensor the wrapper allocated.

#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"

using namespace rt;

namespace {

constexpr int kWarps = 4;
constexpr int kRows = kWarps * 16;  // (query, head) rows per block (bf16)
constexpr int kKeys = 32;           // keys per tile, one per lane (fp32)

struct Strides {
  long long q_b, q_s, q_h;      // q [B, C, H, hd]
  long long k_p, k_t, k_h;      // pools [P, page, KVH, hd]
  long long v_p, v_t, v_h;
  long long kn_b, kn_s, kn_h;   // k_new / v_new [B, C, KVH, hd]
  long long vn_b, vn_s, vn_h;
  long long tab_b;              // table [B, W]
};

// the fp32 body's layout: kRowsPerWarp (query, head) rows a warp, 16,
// or 8 at hd 256, where a lane's 8 output columns of 16 rows would not
// fit the registers beside the softmax state
template <int HD>
struct Smem {
  static constexpr int kRowsPerWarp = HD == 256 ? 8 : 16;
  static constexpr int kRows = kWarps * kRowsPerWarp;
  static constexpr int kStride = HD + 4;  // padded K row
  static constexpr int q = 0;
  static constexpr int k = q + kRows * HD;
  static constexpr int v = k + kKeys * kStride;
  static constexpr int p = v + kKeys * HD;
  static constexpr int floats = p + kRows * kKeys;
  static constexpr size_t bytes = floats * sizeof(float);
};

// fp32: the first version's FMA body, one block per (64 rows, b * KVH)
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
  const int r0 = blockIdx.x * L::kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Q tile: row r is (query r / G, head kvh * G + r % G), scaled in fp32.
  for (int i = tid; i < L::kRows * HD; i += kWarps * 32) {
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
  const int last_q = (min(r0 + L::kRows, rows_total) - 1) / G;
  const int n_keys = n_cached + min(C, last_q + 1);
  const int* trow = table + b * st.tab_b;

  float m[L::kRowsPerWarp], l[L::kRowsPerWarp], acc[L::kRowsPerWarp][kPer];
  int qpos[L::kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < L::kRowsPerWarp; ++rr) {
    const int fr = r0 + warp * L::kRowsPerWarp + rr;
    qpos[rr] = fr < rows_total ? fr / G : -1;
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[rr][i] = 0.f;
  }

  const T* knb = k_new + b * st.kn_b + kvh * st.kn_h;
  const T* vnb = v_new + b * st.vn_b + kvh * st.vn_h;
  const float* Qw = Qs + warp * L::kRowsPerWarp * HD;
  float* Pw = Ps + warp * L::kRowsPerWarp * kKeys;

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
    float s[L::kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < L::kRowsPerWarp; ++rr) s[rr] = 0.f;
    const float* krow = Ks + lane * L::kStride;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int rr = 0; rr < L::kRowsPerWarp; ++rr) {
        const float4 q4 = *reinterpret_cast<const float4*>(Qw + rr * HD + d);
        s[rr] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
      }
    }

    // Online softmax over the tile; masked keys get p = 0 exactly. A
    // cached key is seen by every query, the chunk's key c by queries >= c.
    const int key = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < L::kRowsPerWarp; ++rr) {
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
      for (int rr = 0; rr < L::kRowsPerWarp; ++rr) {
        const float4 p4 = *reinterpret_cast<const float4*>(Pw + rr * kKeys + j);
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          acc[rr][i] += p4.x * vv[0][i] + p4.y * vv[1][i] + p4.z * vv[2][i] +
                        p4.w * vv[3][i];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < L::kRowsPerWarp; ++rr) {
    const int fr = r0 + warp * L::kRowsPerWarp + rr;
    if (fr >= rows_total) continue;
    const int qi = fr / G, h = kvh * G + fr % G;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* orow = o + ((long long)(b * C + qi) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      orow[lane + 32 * i] = from_float<T>(acc[rr][i] / denom);
  }
}


// ------------------------------------------------------------ bf16: mma
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kSplitKeys = 128;     // the shortest split
constexpr int kSplitRowBlocks = 4;  // chunks of fewer row blocks split

// kStages K/V tiles of kTileKeys keys in the ring; stage s holds K then V;
// Q passes through the last stage, in registers before that stage is first
// filled; after the loop the ring holds the block's partial. The table
// slice follows. hd 256 takes flash_attention.cu's hd-256 tiling: Q stays
// in shared memory (its own region past the ring, which the partial may
// then reuse) and gives its A fragments by ldmatrix at each k-step, tiles
// of 32 keys, and V's B fragments kVFrags at a time, so that the 128 fp32
// output accumulators a lane holds fit the registers.
template <int HD>
struct MmaCfg {
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr int kTileKeys = HD == 256 ? 32 : 64;  // keys per tile
  static constexpr bool kQSmem = HD == 256;     // Q fragments from smem
  static constexpr int kVFrags = HD == 256 ? 4 : HD / 16;
  static constexpr int kStride = HD + 8;  // bf16 per row, padded 16 bytes
  static constexpr int kTile = kTileKeys * kStride;
  static constexpr int kStage = 2 * kTile;
  static constexpr int q = (kStages - (kQSmem ? 0 : 1)) * kStage;
  static constexpr int ring_bytes =
      (kStages * kStage + (kQSmem ? kRows * kStride : 0)) * 2;
  static constexpr int kPStr = HD + 4;  // fp32 row of a partial O
  static_assert(kRows * kPStr * 4 + 2 * kRows * 4 <= ring_bytes,
                "a partial fits the ring");
  static_assert((HD / 16) % kVFrags == 0, "V fragments in whole groups");
};

// How a call is cut: row blocks, key splits and their length, table
// entries a split can touch, dynamic shared memory.
struct Plan {
  int row_blocks, splits, split_len, n_tab, smem;
};

template <int HD>
Plan plan_for(int C, int G, int W, int page) {
  Plan p;
  p.row_blocks = (C * G + kRows - 1) / kRows;
  const long long span = (long long)W * page + C;  // a row's keys at most
  long long len = span;
  if (p.row_blocks < kSplitRowBlocks) {
    constexpr int kTileKeys = MmaCfg<HD>::kTileKeys;
    const long long per =
        (span + kMaxSplits - 1) / kMaxSplits;  // at most kMaxSplits
    len = (per + kTileKeys - 1) / kTileKeys * kTileKeys;
    if (len < kSplitKeys) len = kSplitKeys;
    if (len > span) len = span;
  }
  p.split_len = (int)len;
  p.splits = (int)((span + len - 1) / len);
  const long long tab = (len + page - 1) / page + 1;  // pages a split touches
  p.n_tab = (int)(tab < W ? tab : W);
  p.smem = MmaCfg<HD>::ring_bytes + (p.n_tab * 4 + 15) / 16 * 16;
  return p;
}

template <int HD, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
paged_extend_fwd_mma(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ k_new,
                     const __nv_bfloat16* __restrict__ v_new,
                     const int* __restrict__ table,
                     const int* __restrict__ pos,
                     __nv_bfloat16* __restrict__ o, int C, int H, int KVH,
                     int W, int page, int num_pages, Strides st,
                     int split_len, float scale_log2) {
  using bf16 = __nv_bfloat16;
  using L = MmaCfg<HD>;
  constexpr int kThreads = kWarps * 32;
  constexpr int kStages = L::kStages;
  constexpr int kTileKeys = L::kTileKeys;
  constexpr int kVF = L::kVFrags;
  constexpr int kChunks = HD / 8;               // 16-byte chunks per row
  constexpr int kRowStep = kThreads / kChunks;  // rows one copy pass covers
  constexpr int kNT = kTileKeys / 8;            // n8 score tiles per K tile
  constexpr int kDT = HD / 8;                   // n8 output tiles
  extern __shared__ float4 smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* Qs = sm + L::q;
  int* tab = reinterpret_cast<int*>(reinterpret_cast<char*>(smem_raw) +
                                    L::ring_bytes);

  const int G = H / KVH;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int b = blockIdx.z / KVH;
  const int kvh = blockIdx.z % KVH;
  const int rows_total = C * G;
  const int r0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int last_q = (min(r0 + kRows, rows_total) - 1) / G;
  const int n_cached = min(max(pos[b], 0), W * page);
  // this block's keys [k_begin, k_end) of the row's sequence: n_cached
  // cached keys, then the chunk's own up to the block's last query
  const int k_begin = split * split_len;
  const int k_end = min(k_begin + split_len, n_cached + last_q + 1);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kTileKeys - 1) / kTileKeys : 0;
  const int cached_end = min(k_end, n_cached);
  const int pg0 = k_begin / page;

  // every copy pass moves chunk c8 / 8 of rows j0, j0 + kRowStep, ...
  const int c8 = (tid % kChunks) * 8;
  const int j0 = tid / kChunks;

  // Q rows (query fr / G, head kvh * G + fr % G) in flight while the table
  // entries of the cached keys come into shared memory, clamped
  if (n_tiles > 0) {
#pragma unroll
    for (int j = j0; j < kRows; j += kRowStep) {
      const int fr = r0 + j;
      const bool ok = fr < rows_total;
      const bf16* src = ok ? q + b * st.q_b + (fr / G) * st.q_s +
                                 (kvh * G + fr % G) * st.q_h + c8
                           : q;
      copy_chunk(Qs + j * L::kStride + c8, src, ok ? 8 : 0, kVec);
    }
  }
  if (cached_end > k_begin) {
    const int n_pg = (cached_end - 1) / page - pg0 + 1;
    const int* trow = table + b * st.tab_b + pg0;
    for (int i = tid; i < n_pg; i += kThreads)
      tab[i] = min(max(trow[i], 0), num_pages - 1);
  }
  __syncthreads();

  const bf16* kb = k + kvh * st.k_h + c8;
  const bf16* vb = v + kvh * st.v_h + c8;
  const bf16* knb = k_new + b * st.kn_b + kvh * st.kn_h + c8;
  const bf16* vnb = v_new + b * st.vn_b + kvh * st.vn_h + c8;
  auto load_kv = [&](int tile, int stage) {
    bf16* kd = sm + stage * L::kStage + j0 * L::kStride + c8;
    bf16* vd = kd + L::kTile;
    const int key0 = k_begin + tile * kTileKeys + j0;
#pragma unroll
    for (int it = 0; it < kTileKeys / kRowStep; ++it) {
      const int key = key0 + it * kRowStep;
      const bf16* ks = k;
      const bf16* vs = v;
      int n = 0;
      if (key < cached_end) {  // a cached key, through the table
        const int pg = key / page;
        const long long phys = tab[pg - pg0];
        const int off = key - pg * page;
        ks = kb + phys * st.k_p + off * st.k_t;
        vs = vb + phys * st.v_p + off * st.v_t;
        n = 8;
      } else if (key < k_end) {  // one of the chunk's own
        const int c = key - n_cached;
        ks = knb + c * st.kn_s;
        vs = vnb + c * st.vn_s;
        n = 8;
      }
      copy_chunk(kd + it * kRowStep * L::kStride, ks, n, kVec);
      copy_chunk(vd + it * kRowStep * L::kStride, vs, n, kVec);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // this lane's rows are accumulator rows lane / 4 and lane / 4 + 8 of the
  // warp's m16 fragment; row (query qp) sees the keys below its limit,
  // min(k_end, n_cached + qp + 1); a row past the chunk sees none. Tiles
  // below the first row's limit (the smallest) need no mask.
  const int wrow = warp * 16;
  auto row_lim = [&](int fr) {
    return fr < rows_total ? min(k_end, n_cached + fr / G + 1) : k_begin;
  };
  int lim[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) lim[h2] = row_lim(r0 + wrow + lane / 4 + 8 * h2);
  const int n_whole =
      min(n_tiles, max(0, (row_lim(r0) - k_begin) / kTileKeys));

  // Q into registers, then its buffer (the last stage) joins the ring
  // (hd 256: Q stays where it is)
  uint32_t qf[L::kQSmem ? 1 : HD / 16][4];
  auto q_frag = [&](uint32_t(&r)[4], int kk) {
    ldmatrix_x4(r, Qs + (wrow + (lane & 15)) * L::kStride + kk * 16 +
                       (lane >> 4) * 8);
  };
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (!L::kQSmem) {
    if (n_tiles > 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) q_frag(qf[kk], kk);
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < n_tiles) load_kv(s, s);
    cp_async_commit();
  }

  float oacc[kDT][4], lacc[4], m[2];
  constexpr uint32_t kOnes = 0x3f803f80u;  // bf16 pair (1, 1)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int d = 0; d < kDT; ++d) oacc[d][i] = 0.f;
    lacc[i] = 0.f;
  }
  m[0] = m[1] = kNegInf;

  // one K/V tile; one barrier a tile: past it, tile t is visible to all
  // and every warp is done with tile t - 1, whose stage then takes the
  // copy of tile t + kStages - 1
  auto tile = [&](int t, auto kMask) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = t + kStages - 1;
    if (next < n_tiles) load_kv(next, next % kStages);
    cp_async_commit();
    const bf16* Kt = sm + (t % kStages) * L::kStage;
    const bf16* Vt = Kt + L::kTile;
    const int t0 = k_begin + t * kTileKeys;

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t kf[kNT / 2][4];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np)
        ldmatrix_x4(kf[np], Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                     L::kStride +
                                kk * 16 + ((lane >> 3) & 1) * 8);
      uint32_t qa[4];
      if constexpr (L::kQSmem) {
        q_frag(qa, kk);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i];
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        mma_bf16(s[2 * np], qa, kf[np][0], kf[np][1]);
        mma_bf16(s[2 * np + 1], qa, kf[np][2], kf[np][3]);
      }
    }
    if constexpr (decltype(kMask)::value) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = t0 + j * 8 + (lane & 3) * 2 + (i & 1);
          s[j][i] = key < lim[i >> 1] ? s[j][i] : kNegInf;
        }
    }

#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = m[h2];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h2], s[j][2 * h2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with no visible key yet keeps mx = -1e30: subtract 0 so its
      // masked scores give exp2(-1e30 * scale) = 0, not exp2(0) = 1
      const float base = mx == kNegInf ? 0.f : mx * scale_log2;
      const float corr = ex2(m[h2] * scale_log2 - base);
      m[h2] = mx;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float* p = s[j] + 2 * h2;
        p[0] = ex2(fmaf(p[0], scale_log2, -base));
        p[1] = ex2(fmaf(p[1], scale_log2, -base));
      }
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
        oacc[d][2 * h2] *= corr;
        oacc[d][2 * h2 + 1] *= corr;
      }
      lacc[2 * h2] *= corr;
    }

#pragma unroll
    for (int kk = 0; kk < kTileKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d0 = 0; d0 < HD / 16; d0 += kVF) {
        uint32_t vf[kVF][4];
#pragma unroll
        for (int dp = 0; dp < kVF; ++dp)
          ldmatrix_x4_trans(vf[dp], Vt + (kk * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) * L::kStride +
                                        (d0 + dp) * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int dp = 0; dp < kVF; ++dp) {
          mma_bf16(oacc[2 * (d0 + dp)], pa, vf[dp][0], vf[dp][1]);
          mma_bf16(oacc[2 * (d0 + dp) + 1], pa, vf[dp][2], vf[dp][3]);
        }
      }
      mma_bf16(lacc, pa, kOnes, kOnes);
    }
  };
  for (int t = 0; t < n_whole; ++t) tile(t, std::false_type{});
  for (int t = n_whole; t < n_tiles; ++t) tile(t, std::true_type{});
  cp_async_wait<0>();  // nothing in flight past here

  if (n_split == 1) {  // the whole row: normalise and write
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int fr = r0 + wrow + lane / 4 + 8 * h2;
      if (fr >= rows_total) continue;
      const int qi = fr / G, h = kvh * G + fr % G;
      const float inv = 1.f / fmaxf(lacc[2 * h2], 1e-30f);
      bf16* orow = o + ((long long)(b * C + qi) * H + h) * HD + (lane & 3) * 2;
#pragma unroll
      for (int d = 0; d < kDT; ++d)
        *reinterpret_cast<uint32_t*>(orow + d * 8) =
            pack_bf16(oacc[d][2 * h2] * inv, oacc[d][2 * h2 + 1] * inv);
    }
    return;
  }

  // the partial (O, m, l) of each row into this block's shared memory
  __syncthreads();  // every warp is done with the ring
  float* Po = reinterpret_cast<float*>(smem_raw);  // [kRows][kPStr]
  float* Pm = Po + kRows * L::kPStr;
  float* Pl = Pm + kRows;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = wrow + lane / 4 + 8 * h2;
#pragma unroll
    for (int d = 0; d < kDT; ++d)
      *reinterpret_cast<float2*>(Po + row * L::kPStr + d * 8 + (lane & 3) * 2) =
          make_float2(oacc[d][2 * h2], oacc[d][2 * h2 + 1]);
    if ((lane & 3) == 0) {
      Pm[row] = m[h2];
      Pl[row] = lacc[2 * h2];
    }
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is visible to the cluster

  // combine in split order: this block takes every n_split-th (row,
  // column quad) of the row block, reading the partials of all splits
  constexpr int kQuads = HD / 4;
  for (int it = split * kThreads + tid; it < kRows * kQuads;
       it += n_split * kThreads) {
    const int row = it / kQuads, c4 = (it % kQuads) * 4;
    const int fr = r0 + row;
    if (fr >= rows_total) continue;
    float ms[kMaxSplits], mt = kNegInf;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      ms[sp] = sp < n_split ? *cluster.map_shared_rank(Pm + row, sp) : kNegInf;
      mt = fmaxf(mt, ms[sp]);
    }
    const float base = mt == kNegInf ? 0.f : mt * scale_log2;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp >= n_split) break;
      const float f = ex2(ms[sp] * scale_log2 - base);
      const float4 x = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(Po + row * L::kPStr + c4, sp));
      l = fmaf(f, *cluster.map_shared_rank(Pl + row, sp), l);
      acc.x = fmaf(f, x.x, acc.x);
      acc.y = fmaf(f, x.y, acc.y);
      acc.z = fmaf(f, x.z, acc.z);
      acc.w = fmaf(f, x.w, acc.w);
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int qi = fr / G, h = kvh * G + fr % G;
    bf16* orow = o + ((long long)(b * C + qi) * H + h) * HD + c4;
    *reinterpret_cast<uint2*>(orow) = make_uint2(
        pack_bf16(acc.x * inv, acc.y * inv), pack_bf16(acc.z * inv, acc.w * inv));
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int HD, bool kVec>
int launch_mma(const void* q, const void* k, const void* v,
               const void* k_new, const void* v_new, const void* table,
               const void* pos, void* o, int B, int C, int H, int KVH, int W,
               int page, int num_pages, const Strides& st, const Plan& p,
               float scale_log2, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kern = paged_extend_fwd_mma<HD, kVec>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.row_blocks, B * KVH);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;  // the splits of a row block
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<bf16*>(o), C, H, KVH, W,
      page, num_pages, st, p.split_len, scale_log2);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* k_new, const void* v_new, const void* table,
                const void* pos, void* o, int B, int C, int H, int KVH,
                int W, int page, int num_pages, const long long* s,
                float scale, cudaStream_t stream) {
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                   s[8], s[9], s[10], s[11], s[12], s[13], s[14], s[15]};
  const Plan p = plan_for<HD>(C, H / KVH, W, page);
  // cp.async needs every row start 16-byte aligned: bases and strides
  bool vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v) |
              reinterpret_cast<uintptr_t>(k_new) |
              reinterpret_cast<uintptr_t>(v_new)) % 16 == 0;
  for (int i = 0; i < 15; ++i) vec = vec && s[i] % 8 == 0;
  auto go = vec ? launch_mma<HD, true> : launch_mma<HD, false>;
  return go(q, k, v, k_new, v_new, table, pos, o, B, C, H, KVH, W, page,
            num_pages, st, p, scale * 1.4426950408889634f, stream);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* k_new,
           const void* v_new, const void* table, const void* pos, void* o,
           int B, int C, int H, int KVH, int W, int page, int num_pages,
           const long long* s, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_bf16<HD>(q, k, v, k_new, v_new, table, pos, o, B, C, H,
                           KVH, W, page, num_pages, s, scale, stream);
  } else {
    auto kern = paged_extend_fwd<T, HD>;
    const size_t smem = Smem<HD>::bytes;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int G = H / KVH;
    const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                     s[8], s[9], s[10], s[11], s[12], s[13], s[14], s[15]};
    constexpr int rows = Smem<HD>::kRows;
    const dim3 grid((C * G + rows - 1) / rows, B * KVH);
    kern<<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<const int*>(table),
        static_cast<const int*>(pos), static_cast<T*>(o), C, H, KVH, W, page,
        num_pages, st, scale);
    return (int)cudaGetLastError();
  }
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
  RT_CASE(__nv_bfloat16, kBFloat16, 256)
  RT_CASE(float, kFloat32, 64)
  RT_CASE(float, kFloat32, 128)
  RT_CASE(float, kFloat32, 256)
#undef RT_CASE
  return (int)cudaErrorInvalidValue;
}

// How paged_extend_attention_fwd cuts a call of this shape: out[0..3] =
// row blocks, key splits (the cluster size), keys per split, dynamic
// shared memory in bytes. Returns 0, or
// cudaErrorInvalidValue for a (dtype, hd) it does not take.
extern "C" int paged_extend_attention_plan(int dtype, int hd, int C, int H,
                                           int KVH, int W, int page,
                                           int* out) {
  Plan p;
  if (dtype == kBFloat16 && hd == 64) {
    p = plan_for<64>(C, H / KVH, W, page);
  } else if (dtype == kBFloat16 && hd == 128) {
    p = plan_for<128>(C, H / KVH, W, page);
  } else if (dtype == kBFloat16 && hd == 256) {
    p = plan_for<256>(C, H / KVH, W, page);
  } else if (dtype == kFloat32 && (hd == 64 || hd == 128 || hd == 256)) {
    auto fma = [&](int rows, size_t bytes) {
      return Plan{(C * (H / KVH) + rows - 1) / rows, 1, W * page + C, 0,
                  (int)bytes};
    };
    p = hd == 64    ? fma(Smem<64>::kRows, Smem<64>::bytes)
        : hd == 128 ? fma(Smem<128>::kRows, Smem<128>::bytes)
                    : fma(Smem<256>::kRows, Smem<256>::bytes);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  out[0] = p.row_blocks, out[1] = p.splits, out[2] = p.split_len;
  out[3] = p.smem;
  return 0;
}
