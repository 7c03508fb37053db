// Causal GQA prefill attention for Hopper (sm_90a), online softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (body _fa_kernel): out[b, i, h] = softmax(q[b, i, h] . k[b, j, h // G] /
// sqrt(hd), masked to j <= i or j < prefix_len) @ v[b, :, h // G], fp32
// softmax state, output in the input dtype; a row with nothing visible
// gives 0. q and k rows are QD wide, v and out rows VD: QD = VD = hd (64,
// 112, 128, 256), or QD 192 over VD 128, MLA's expanded prefill
// (deepseek-v2: 128 nope + 64 rope columns of q/k, 128 of v).
//
// What bounds it on the H100: the card's least time at the serving shapes
// (prompts of up to a few thousand tokens, hd 64, 128 and 256) is the
// bytes of q, k, v and out, read once; the Sq * Sk * hd products stay below
// that only on the tensor cores. Both kernels share the block layout:
//  * one block per (64 or 128 rows of (query, grouped head), b * KVH +
//    kvh): the G query heads of a KV head share every K/V tile, so K/V are
//    read once per block of rows, not once per query head;
//  * the key loop stops at the causal diagonal of the block's last query
//    (or at the prefix), so a causal prompt does about half the work;
//  * any Sq, Sk and G: rows and keys past the ragged edge are masked here,
//    and masked scores are -1e30 (never -inf).
// bf16 (flash_fwd_mma, the serving path), FlashAttention-2 shaped:
//  * four warps; at hd 64 each owns two m16 row fragments (128-row blocks,
//    as FlashAttention-2 tiles hd 64), so that each K/V fragment load and
//    each tile's copy, barrier and softmax bookkeeping serve 32 rows; at hd
//    128, 192 and 256 one (64-row blocks: two would not fit the
//    registers). Q is copied once and held in registers as mma fragments
//    (at hd 256 and q/k 192 it stays in shared memory: see MmaCfg);
//  * K/V tiles of 64 keys (32 at hd 256) come into a ring of shared-memory
//    stages (three at hd 64, two at hd 128 and 256) by 16-byte cp.async,
//    the next tiles' copies in flight during this tile's math, one barrier
//    a tile; rows are padded by 16 bytes, so ldmatrix is free of bank
//    conflicts;
//  * S = Q K^T by mma.sync m16n8k16 (K through ldmatrix); the online
//    softmax runs in registers on the accumulator layout, its row max
//    reduced over the four lanes of a quad by shuffles, the 1/sqrt(hd)
//    scale folded into one FFMA before ex2;
//  * P is rounded to bf16 in registers and fed straight into O += P V by
//    mma.sync (V through ldmatrix.trans); the row sums l are one more n8
//    tile of that product (P times ones), so O and l sum the same bf16 P;
//    O stays in fp32 registers and is written once, in bf16;
//  * the tiles every row of the block sees whole take a path without the
//    mask; the launch order walks (b, kvh) fastest and the longest causal
//    row blocks first;
//  * row starts that are not 16-byte aligned (odd strides or offsets of a
//    view) take an instantiation with scalar loads into the same ring:
//    same math, any shape the FMA kernel took.
// At the serving shapes the loop is bound by instruction throughput (the
// per-element softmax work beside mma.sync), not by bytes: see PERF.md.
// fp32 (flash_fwd, the first version's body): fp32 FMAs on the CUDA cores
// from K/V tiles of 32 keys widened in shared memory. The tensor cores'
// fp32 input type is TF32 (10 mantissa bits), which cannot meet the fp32
// checks (2e-5 against the plain version, 1e-4 on logits), so fp32 keeps
// this body; the serving paths run bf16.
// QD 192 over VD 128 (bf16): one m16 row fragment a warp, 64-key tiles,
// two stages, Q in shared memory (its 48 fragment registers a lane beside
// V's 64 fp32 accumulators would spill), two blocks an SM. K tiles are 192
// wide and V tiles 128; a K row's 24 16-byte chunks do not divide the 128
// threads, so its copies walk the flat (row, chunk) index.
// hd 112 (zamba2's shared attention): laid out as hd 128 (one m16 row
// fragment a warp, 64-key tiles, two stages, Q in registers: 7 k-steps),
// with V fragments all 7 at once; a 112-wide row is 14 16-byte chunks,
// which do not divide 128 threads either, so K/V copy passes take 9 rows
// on 126 threads (Q walks the flat (row, chunk) index). The fp32 body's
// lanes own 4 output columns, the fourth only on lanes 0-15.
// Inputs are strided [B, S, heads, QD or VD] views (last dim contiguous);
// the output is a contiguous [B, Sq, H, VD] tensor the wrapper allocated.
// lse (optional, the training forward): where non-null, both bodies also
// write each (row, head)'s log-sum-exp of its scaled scores, fp32 [B, H,
// Sq], in natural-log units (m * scale + ln l); the backward kernels
// (flash_attention_bwd.cu) rebuild P from it. A row with nothing visible
// (Sk = 0) gets kLseEmpty. Serving passes null and writes nothing more.

#include <type_traits>

#include "common.cuh"

using namespace rt;

namespace {

constexpr int kWarps = 4;
constexpr int kKeys = 32;  // keys per tile, one per lane (fp32 body)
constexpr float kLn2 = 0.6931471805599453f;

// the fp32 body's layout: kRowsPerWarp (query, head) rows a warp, 16,
// or 8 at hd 256, where a lane's 8 output columns of 16 rows would not
// fit the registers beside the softmax state
template <int QD, int VD>
struct Smem {
  static constexpr int kRowsPerWarp = QD == 256 ? 8 : 16;
  static constexpr int kRows = kWarps * kRowsPerWarp;
  static constexpr int kStride = QD + 4;  // padded K row
  static constexpr int q = 0;
  static constexpr int k = q + kRows * QD;
  static constexpr int v = k + kKeys * kStride;
  static constexpr int p = v + kKeys * VD;
  static constexpr int floats = p + kRows * kKeys;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int QD, int VD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
          long long q_sb, long long q_ss, long long q_sh, long long k_sb,
          long long k_ss, long long k_sh, long long v_sb, long long v_ss,
          long long v_sh, int causal, int prefix_len, float scale) {
  using L = Smem<QD, VD>;
  constexpr int kPer = (VD + 31) / 32;  // output dims per lane
  // the lane's output dim lane + 32 * i lies in the row (VD 112: the last
  // i only on lanes 0-15)
  auto in_row = [&](int lane, int i) {
    return VD % 32 == 0 || i < kPer - 1 || lane + 32 * i < VD;
  };
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
  const int r0 = blockIdx.x * L::kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Q tile: row r is (query r / G, head kvh * G + r % G), scaled in fp32.
  for (int i = tid; i < L::kRows * QD; i += kWarps * 32) {
    const int fr = r0 + i / QD, d = i % QD;
    float x = 0.f;
    if (fr < rows_total) {
      const int qp = fr / G, h = kvh * G + fr % G;
      x = to_float(q[b * q_sb + qp * q_ss + h * q_sh + d]) * scale;
    }
    Qs[i] = x;
  }

  // Keys this block needs: up to the diagonal of its last query, or the
  // prefix, whichever is longer.
  const int last_q = (min(r0 + L::kRows, rows_total) - 1) / G;
  const int n_keys = causal ? min(Sk, max(last_q + 1, prefix_len)) : Sk;

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

  const T* kbase = k + b * k_sb + kvh * k_sh;
  const T* vbase = v + b * v_sb + kvh * v_sh;
  const float* Qw = Qs + warp * L::kRowsPerWarp * QD;
  float* Pw = Ps + warp * L::kRowsPerWarp * kKeys;

  for (int t0 = 0; t0 < n_keys; t0 += kKeys) {
    __syncthreads();  // Q stored; the previous tile fully consumed
    if constexpr (QD == VD) {
      for (int i = tid; i < kKeys * QD; i += kWarps * 32) {
        const int j = i / QD, d = i % QD, key = t0 + j;
        float kx = 0.f, vx = 0.f;
        if (key < n_keys) {
          kx = to_float(kbase[key * k_ss + d]);
          vx = to_float(vbase[key * v_ss + d]);
        }
        Ks[j * L::kStride + d] = kx;
        Vs[j * VD + d] = vx;
      }
    } else {
      for (int i = tid; i < kKeys * QD; i += kWarps * 32) {
        const int j = i / QD, d = i % QD, key = t0 + j;
        Ks[j * L::kStride + d] =
            key < n_keys ? to_float(kbase[key * k_ss + d]) : 0.f;
      }
      for (int i = tid; i < kKeys * VD; i += kWarps * 32) {
        const int j = i / VD, d = i % VD, key = t0 + j;
        Vs[j * VD + d] = key < n_keys ? to_float(vbase[key * v_ss + d]) : 0.f;
      }
    }
    __syncthreads();

    // QK^T: lane j scores key t0 + j against the warp's rows.
    float s[L::kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < L::kRowsPerWarp; ++rr) s[rr] = 0.f;
    const float* krow = Ks + lane * L::kStride;
#pragma unroll 4
    for (int d = 0; d < QD; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int rr = 0; rr < L::kRowsPerWarp; ++rr) {
        const float4 q4 = *reinterpret_cast<const float4*>(Qw + rr * QD + d);
        s[rr] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
      }
    }

    // Online softmax over the tile; masked keys get p = 0 exactly.
    const int key = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < L::kRowsPerWarp; ++rr) {
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
          vv[jj][i] = in_row(lane, i) ? Vs[(j + jj) * VD + lane + 32 * i]
                                      : 0.f;
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
    const int qp = fr / G, h = kvh * G + fr % G;
    const float denom = fmaxf(l[rr], 1e-30f);
    if (lse && lane == 0)      // scores were scaled with Q: m is too
      lse[((long long)b * H + h) * Sq + qp] =
          l[rr] > 0.f ? m[rr] + logf(l[rr]) : kLseEmpty;
    T* orow = o + ((long long)(b * Sq + qp) * H + h) * VD;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (in_row(lane, i))
        orow[lane + 32 * i] = from_float<T>(acc[rr][i] / denom);
  }
}

// ------------------------------------------------------------ bf16: mma
// kMT m16 row fragments per warp: two at hd 64 (128-row blocks, as
// FlashAttention-2 tiles hd 64), so that each K/V fragment load and each
// tile's copy, barrier and softmax bookkeeping serve twice the rows; one at
// hd 128, where two would not fit the registers. kStages K/V tiles of
// kTileKeys keys in the ring: three at hd 64 (two in flight during a
// tile's math); two at hd 128, where three blocks of 168 registers then
// share an SM. Stage s holds K then V; Q passes through the last stage, in
// registers before that stage is first filled.
// hd 256: a lane's 128 fp32 output accumulators leave no room for Q's 64
// fragment registers, so Q stays in shared memory (its own region past
// the ring) and each 16-column k-step of Q K^T loads its A fragment by
// ldmatrix; tiles of 32 keys halve the score fragments, and V's B
// fragments come kVFrags at a time, not all 16 at once.
// QD 192 over VD 128: 64-key tiles and two stages as at hd 128, but Q's
// 12 k-steps of fragments (48 registers a lane) beside V's 64 fp32
// accumulators spill past 255 registers, so Q stays in shared memory as
// at hd 256 and V's B fragments come 4 at a time; a stage holds a K tile
// of 192-wide rows and a V tile of 128-wide ones, two blocks an SM.
// hd 112: as hd 128 (Q's 7 k-steps in registers, three blocks an SM),
// V's 7 B fragments at once.
template <int QD, int VD>
struct MmaCfg {
  static constexpr int kMT = QD == 64 ? 2 : 1;
  static constexpr int kStages = QD == 64 ? 3 : 2;
  static constexpr int kMinBlocks =
      QD == 112 || QD == 128 ? 3 : QD == 192 ? 2 : 1;
  static constexpr int kTileKeys = QD == 256 ? 32 : 64;  // keys per tile
  static constexpr bool kQSmem = QD >= 192;     // Q fragments from smem
  static constexpr int kVFrags = VD == 256 || QD == 192 ? 4 : VD / 16;
  static constexpr int kRows = kWarps * 16 * kMT;  // (query, head) rows
  // bf16 per Q/K row and per V row, each padded 16 bytes
  static constexpr int kStride = QD + 8;
  static constexpr int kVStride = VD + 8;
  static constexpr int kTile = kTileKeys * kStride;  // a K tile
  static constexpr int kStage = kTile + kTileKeys * kVStride;
  static constexpr int q = (kStages - (kQSmem ? 0 : 1)) * kStage;
  static constexpr int elems =
      kStages * kStage + (kQSmem ? kRows * kStride : 0);
  static constexpr size_t bytes = elems * sizeof(__nv_bfloat16);
  static_assert(kQSmem || kRows * kStride <= kStage, "Q fits one stage");
  static_assert((VD / 16) % kVFrags == 0, "V fragments in whole groups");
};

// the unaligned instantiation (scalar copies, a cold path) takes the
// registers it needs rather than spill under the aligned one's limit
template <int QD, int VD, bool kVec>
__global__ void
__launch_bounds__(kWarps * 32, kVec ? MmaCfg<QD, VD>::kMinBlocks : 1)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
              int Sq, int Sk, int H, int KVH, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
              long long k_ss, long long k_sh, long long v_sb, long long v_ss,
              long long v_sh, int causal, int prefix_len, float scale_log2) {
  using bf16 = __nv_bfloat16;
  using L = MmaCfg<QD, VD>;
  constexpr int kMT = L::kMT;
  constexpr int kStages = L::kStages;
  constexpr int kTileKeys = L::kTileKeys;
  constexpr int kVF = L::kVFrags;
  constexpr int kThreads = kWarps * 32;
  // 16-byte chunks per Q/K row and per V row. A K/V copy pass: a thread
  // keeps one chunk column and walks rows kRowStep apart; where the
  // threads do not divide a row's chunks, the last kThreads % kChunks
  // threads idle (hd 112: 9 rows of 14 chunks a pass, 126 threads) and
  // the passes end past the tile (8 passes of 9 rows for 64). Q, once, and
  // K at QD 192 (24 chunks a row) walk the flat (row, chunk) index
  // kThreads apart instead
  constexpr int kChunks = QD / 8;
  constexpr int kVChunks = VD / 8;
  constexpr bool kEven = kThreads % kChunks == 0;
  constexpr int kRowStep = kThreads / kChunks;
  constexpr int kVRowStep = kThreads / kVChunks;
  constexpr int kPasses = (kTileKeys + kRowStep - 1) / kRowStep;
  static_assert(kThreads % kVChunks == 0 || QD == VD,
                "V rows walk apart from K's only where the threads divide "
                "them");
  constexpr int kNT = kTileKeys / 8;            // n8 score tiles per K tile
  constexpr int kDT = VD / 8;                   // n8 output tiles
  extern __shared__ float4 smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* Qs = sm + L::q;

  const int G = H / KVH;
  // the blocks of one (b, kvh) share every K/V tile: the launch order walks
  // (b, kvh) fastest, so that the blocks in flight together spread over
  // heads instead of all reading one head's tiles at once, and it takes
  // the longest causal row blocks first, for a shorter tail
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int bh = lin % gridDim.y;
  const int b = bh / KVH;
  const int kvh = bh % KVH;
  const int rows_total = Sq * G;
  const int r0 = (gridDim.x - 1 - lin / gridDim.y) * L::kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int last_q = (min(r0 + L::kRows, rows_total) - 1) / G;
  const int n_keys = causal ? min(Sk, max(last_q + 1, prefix_len)) : Sk;
  const int n_tiles = (n_keys + kTileKeys - 1) / kTileKeys;

  // every copy pass moves chunk c8 / 8 of rows j0, j0 + kRowStep, ...
  // (V: cv8 / 8 of rows jv0, jv0 + kVRowStep, ...)
  const int c8 = (tid % kChunks) * 8;
  const int j0 = tid / kChunks;
  const int cv8 = (tid % kVChunks) * 8;
  const int jv0 = tid / kVChunks;

  // Q rows (query fr / G, head kvh * G + fr % G) and tile 0: copy group 0
  auto copy_q = [&](int j, int c) {
    const int fr = r0 + j;
    const bool ok = fr < rows_total;
    const bf16* src = ok ? q + b * q_sb + (fr / G) * q_ss +
                               (kvh * G + fr % G) * q_sh + c
                         : q;
    copy_chunk(Qs + j * L::kStride + c, src, ok ? 8 : 0, kVec);
  };
  if constexpr (kEven) {
#pragma unroll
    for (int j = j0; j < L::kRows; j += kRowStep) copy_q(j, c8);
  } else {
    static_assert(L::kRows * kChunks % kThreads == 0, "whole Q passes");
#pragma unroll
    for (int it = 0; it < L::kRows * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      copy_q(i / kChunks, i % kChunks * 8);
    }
  }
  const bf16* kbase = k + b * k_sb + kvh * k_sh;
  const bf16* vbase = v + b * v_sb + kvh * v_sh;
  const bf16* krow = kbase + j0 * k_ss + c8;
  const bf16* vrow = vbase + jv0 * v_ss + cv8;
  const long long k_step = kRowStep * k_ss, v_step = kVRowStep * v_ss;
  auto load_kv = [&](int tile, int stage) {
    const bf16* kp = krow + (long long)(tile * kTileKeys) * k_ss;
    const bf16* vp = vrow + (long long)(tile * kTileKeys) * v_ss;
    bf16* ks = sm + stage * L::kStage;
    bf16* kd = ks + j0 * L::kStride + c8;
    bf16* vd = ks + L::kTile + jv0 * L::kVStride + cv8;
    if constexpr (QD == VD) {          // K and V rows in one walk
      const int key0 = tile * kTileKeys + j0;
#pragma unroll
      for (int it = 0; it < kPasses; ++it) {
        // every thread copies, and no pass passes the tile, unless hd 112
        if (kEven || (j0 + it * kRowStep < kTileKeys &&
                      tid < kRowStep * kChunks)) {
          const bool ok = key0 + it * kRowStep < n_keys;
          copy_chunk(kd + it * kRowStep * L::kStride, ok ? kp : kbase,
                     ok ? 8 : 0, kVec);
          copy_chunk(vd + it * kRowStep * L::kStride, ok ? vp : vbase,
                     ok ? 8 : 0, kVec);
        }
        kp += k_step;
        vp += v_step;
      }
    } else {                           // QD 192: K by the flat index
      static_assert(!kEven && kTileKeys * kChunks % kThreads == 0,
                    "K walks its own index only at QD 192, in whole passes");
#pragma unroll
      for (int it = 0; it < kTileKeys * kChunks / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int j = i / kChunks, c = i % kChunks * 8;
        const int key = tile * kTileKeys + j;
        const bool ok = key < n_keys;
        copy_chunk(ks + j * L::kStride + c,
                   ok ? kbase + (long long)key * k_ss + c : kbase,
                   ok ? 8 : 0, kVec);
      }
      const int keyv0 = tile * kTileKeys + jv0;
#pragma unroll
      for (int it = 0; it < kTileKeys / kVRowStep; ++it) {
        const bool ok = keyv0 + it * kVRowStep < n_keys;
        copy_chunk(vd + it * kVRowStep * L::kVStride, ok ? vp : vbase,
                   ok ? 8 : 0, kVec);
        vp += v_step;
      }
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // this lane's rows are accumulator rows lane / 4 and lane / 4 + 8 of each
  // of the warp's m16 fragments; row (query qp) sees the keys below lim:
  // key <= qp or key < prefix_len (causal), any key (not), none past the
  // last row. Tiles below the block's smallest lim (its first row's) need
  // no mask.
  const int wrow = warp * 16 * kMT;
  auto row_lim = [&](int fr) {
    if (fr >= rows_total) return 0;
    return causal ? min(n_keys, max(fr / G + 1, prefix_len)) : n_keys;
  };
  int lim[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      lim[mt][h2] = row_lim(r0 + wrow + mt * 16 + lane / 4 + 8 * h2);
  const int n_whole = min(
      n_tiles, (r0 + L::kRows <= rows_total ? row_lim(r0) : 0) / kTileKeys);

  // Q into registers, then its buffer (the last stage) joins the ring
  // (hd 256: Q stays where it is)
  uint32_t qf[kMT][L::kQSmem ? 1 : QD / 16][4];
  auto q_frag = [&](uint32_t(&r)[4], int mt, int kk) {
    ldmatrix_x4(r, Qs + (wrow + mt * 16 + (lane & 15)) * L::kStride +
                       kk * 16 + (lane >> 4) * 8);
  };
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (!L::kQSmem) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int kk = 0; kk < QD / 16; ++kk) q_frag(qf[mt][kk], mt, kk);
    __syncthreads();
  }
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < n_tiles) load_kv(s, s);
    cp_async_commit();
  }

  // O and the softmax denominator: l = P . 1 is one more n8 tile of the PV
  // product (a ones B fragment), so it sums the same bf16 P as O does
  float oacc[kMT][kDT][4], lacc[kMT][4], m[kMT][2];
  constexpr uint32_t kOnes = 0x3f803f80u;  // bf16 pair (1, 1)
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int d = 0; d < kDT; ++d) oacc[mt][d][i] = 0.f;
      lacc[mt][i] = 0.f;
    }
    m[mt][0] = m[mt][1] = kNegInf;
  }

  // one K/V tile; kMask: the tile reaches the edge, the diagonal or the
  // prefix for some row of the block. One barrier a tile: past it, tile t
  // is visible to all and every warp is done with tile t - 1, whose stage
  // then takes the copy of tile t + kStages - 1.
  auto tile = [&](int t, auto kMask) {
    cp_async_wait<kStages - 2>();      // tile t landed
    __syncthreads();
    const int next = t + kStages - 1;
    if (next < n_tiles) load_kv(next, next % kStages);
    cp_async_commit();
    const bf16* Kt = sm + (t % kStages) * L::kStage;
    const bf16* Vt = Kt + L::kTile;
    const int t0 = t * kTileKeys;

    // S = Q K^T: K rows are the col-major B operand as they lie; each K
    // fragment serves the warp's kMT row fragments
    float s[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < QD / 16; ++kk) {
      uint32_t kb[kNT / 2][4];  // all fragments first: one load latency
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np)
        ldmatrix_x4(kb[np], Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                     L::kStride +
                                kk * 16 + ((lane >> 3) & 1) * 8);
      uint32_t qa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if constexpr (L::kQSmem) {
          q_frag(qa[mt], mt, kk);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[mt][i] = qf[mt][kk][i];
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          mma_bf16(s[mt][2 * np], qa[mt], kb[np][0], kb[np][1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt], kb[np][2], kb[np][3]);
        }
    }
    if constexpr (decltype(kMask)::value) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = t0 + j * 8 + (lane & 3) * 2 + (i & 1);
            s[mt][j][i] = key < lim[mt][i >> 1] ? s[mt][j][i] : kNegInf;
          }
    }

    // online softmax per row on raw scores; the scale folds into the
    // exponent, exp2(s * scale_log2 - max * scale_log2); the row's four
    // lanes share max and rescale
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float mx = m[mt][h2];
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * h2], s[mt][j][2 * h2 + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row with no visible key yet keeps mx = -1e30: subtract 0 so
        // its masked scores give exp2(-1e30 * scale) = 0, not exp2(0) = 1
        const float base = mx == kNegInf ? 0.f : mx * scale_log2;
        const float corr = ex2(m[mt][h2] * scale_log2 - base);
        m[mt][h2] = mx;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          float* p = s[mt][j] + 2 * h2;
          p[0] = ex2(fmaf(p[0], scale_log2, -base));
          p[1] = ex2(fmaf(p[1], scale_log2, -base));
        }
#pragma unroll
        for (int d = 0; d < kDT; ++d) {
          oacc[mt][d][2 * h2] *= corr;
          oacc[mt][d][2 * h2 + 1] *= corr;
        }
        lacc[mt][2 * h2] *= corr;
      }

    // O += P V: P's accumulator layout is the A fragment layout, so P goes
    // to bf16 in registers; V rows are K-major for B, hence .trans; kVF
    // column fragments at a time
#pragma unroll
    for (int kk = 0; kk < kTileKeys / 16; ++kk) {
#pragma unroll
      for (int d0 = 0; d0 < VD / 16; d0 += kVF) {
        uint32_t vb[kVF][4];
#pragma unroll
        for (int dp = 0; dp < kVF; ++dp)
          ldmatrix_x4_trans(vb[dp], Vt + (kk * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) * L::kVStride +
                                        (d0 + dp) * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const float(*p)[4] = s[mt];
          const uint32_t pa[4] = {
              pack_bf16(p[2 * kk][0], p[2 * kk][1]),
              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
          for (int dp = 0; dp < kVF; ++dp) {
            mma_bf16(oacc[mt][2 * (d0 + dp)], pa, vb[dp][0], vb[dp][1]);
            mma_bf16(oacc[mt][2 * (d0 + dp) + 1], pa, vb[dp][2], vb[dp][3]);
          }
          if (d0 + kVF == VD / 16) mma_bf16(lacc[mt], pa, kOnes, kOnes);
        }
      }
    }
  };
  for (int t = 0; t < n_whole; ++t) tile(t, std::false_type{});
  for (int t = n_whole; t < n_tiles; ++t) tile(t, std::true_type{});
  cp_async_wait<0>();  // nothing in flight at exit

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float ls = lacc[mt][2 * h2];  // every column holds the row sum
      const int fr = r0 + wrow + mt * 16 + lane / 4 + 8 * h2;
      if (fr >= rows_total) continue;
      const int qp = fr / G, h = kvh * G + fr % G;
      const float inv = 1.f / fmaxf(ls, 1e-30f);
      // m is the raw max: ln(sum) = (m * scale_log2 + log2 l) * ln 2
      if (lse && (lane & 3) == 0)
        lse[((long long)b * H + h) * Sq + qp] =
            ls > 0.f ? (m[mt][h2] * scale_log2 + log2f(ls)) * kLn2
                     : kLseEmpty;
      bf16* orow =
          o + ((long long)(b * Sq + qp) * H + h) * VD + (lane & 3) * 2;
#pragma unroll
      for (int d = 0; d < kDT; ++d)
        *reinterpret_cast<uint32_t*>(orow + d * 8) = pack_bf16(
            oacc[mt][d][2 * h2] * inv, oacc[mt][d][2 * h2 + 1] * inv);
    }
}

template <typename T, int QD, int VD>
size_t smem_bytes() {
  if constexpr (std::is_same<T, float>::value) return Smem<QD, VD>::bytes;
  else return MmaCfg<QD, VD>::bytes;
}

template <typename T, int QD, int VD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int KVH, const long long* st, int causal,
           int prefix_len, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, QD, VD>();
  const int G = H / KVH;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int rows = Smem<QD, VD>::kRows;
    const dim3 grid((Sq * G + rows - 1) / rows, B * KVH);
    auto kern = flash_fwd<T, QD, VD>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, KVH,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
        prefix_len, scale);
  } else {
    // cp.async needs every row start 16-byte aligned: base and strides
    bool vec = (reinterpret_cast<uintptr_t>(q) |
                reinterpret_cast<uintptr_t>(k) |
                reinterpret_cast<uintptr_t>(v)) % 16 == 0;
    for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
    auto kern = vec ? flash_fwd_mma<QD, VD, true>
                    : flash_fwd_mma<QD, VD, false>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    constexpr int rows = MmaCfg<QD, VD>::kRows;
    const dim3 grid((Sq * G + rows - 1) / rows, B * KVH);
    kern<<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, KVH,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
        prefix_len, scale * 1.4426950408889634f);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The (q/k width, v width) pairs the kernels are built for: hd 64, 112,
// 128 and 256 for both, and MLA's 192 over 128.
#define FLASH_WIDTHS(X) \
  X(64, 64) X(112, 112) X(128, 128) X(256, 256) X(192, 128)

// strides: element strides of q, k, v over (batch, seq, head), 9 values;
// hd is the q/k width, vd the v (and output) width; lse: null, or a
// [B, H, Sq] fp32 buffer for each row's log-sum-exp. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int dtype, int hd,
                                   int vd, int B, int Sq, int Sk, int H,
                                   int KVH, const long long* strides,
                                   int causal, int prefix_len, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FLASH_LAUNCH(QD, VD)                                                 \
  if (hd == QD && vd == VD) {                                               \
    if (dtype == kBFloat16)                                                 \
      return launch<__nv_bfloat16, QD, VD>(q, k, v, o, l, B, Sq, Sk, H,     \
                                           KVH, strides, causal,            \
                                           prefix_len, scale, s);           \
    if (dtype == kFloat32)                                                  \
      return launch<float, QD, VD>(q, k, v, o, l, B, Sq, Sk, H, KVH,        \
                                   strides, causal, prefix_len, scale, s);  \
  }
  FLASH_WIDTHS(FLASH_LAUNCH)
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the instantiation that flash_attention_fwd
// launches for (dtype, hd, vd), in bytes; 0 for one it does not take.
extern "C" int flash_attention_smem_bytes(int dtype, int hd, int vd) {
#define FLASH_SMEM(QD, VD)                                                   \
  if (hd == QD && vd == VD) {                                               \
    if (dtype == kBFloat16) return (int)smem_bytes<__nv_bfloat16, QD, VD>(); \
    if (dtype == kFloat32) return (int)smem_bytes<float, QD, VD>();         \
  }
  FLASH_WIDTHS(FLASH_SMEM)
#undef FLASH_SMEM
  return 0;
}
