// Hopper (sm_90a) building blocks in inline PTX: mbarriers, TMA tensor
// loads and stores, bulk stores, the async-proxy fence and named barriers,
// warpgroup MMA (wgmma m64n64k16 and m64n32k16 with A fragments in
// registers or A read through a shared-memory descriptor, and m64n256k16
// with both operands read through descriptors, either one K- or MN-major;
// bf16 in, fp32 accumulate), setmaxnreg; and, on the host, TMA tensor
// maps encoded through the driver's entry point (cudaGetDriverEntryPoint:
// no -lcuda, no new dependency).
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace rt {

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival, made once every cp.async this thread issued has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed. No wait of a
// working pipeline lasts a millisecond; one that lasts 4 s is a fault of
// the pipeline and traps, so it fails the launch instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t spin = 1;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 0) {
      const uint64_t t = global_ns();
      if (t0 == 0) t0 = t;
      else if (t - t0 > 4000000000ull) __trap();
    }
  }
}

// ------------------------------------------------------------ TMA

// the box of a 4-d tensor map at coordinates (c0 innermost .. c3) into
// shared memory; completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the box of a 3-d tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory; completion is counted on `bar` in bytes (a box that lies
// partly or wholly outside the tensor still counts all its bytes, the
// outside read as zeros)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// a shared-memory box to a 3-d tensor map's coordinates (elements outside
// the tensor are not written), in this thread's current bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) of shared memory to global memory, both
// 16-byte aligned, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups are still reading
// their shared-memory sources
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// orders this thread's shared-memory writes before later reads of the
// async proxy (wgmma operands, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1 .. 15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator (or A
// fragment) across the asynchronous wgmma that uses it. No memory clobber:
// shared-memory reads may move past it (the mbarrier waits and arrivals
// order them), so a step's loads can run while its products do.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]));
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The descriptor of a bf16 tile in shared memory laid out by a TMA load
// with 128-byte swizzle: rows of 64 elements (128 bytes), 8-row groups of
// 1024 bytes, the tile 1024-byte aligned. K-major (the reduction runs
// along the row): LBO unused (1), SBO the 8-row group, 1024 bytes; a
// k-step of 16 elements adds 32 bytes (2 in the address field).
// MN-major (the reduction runs down the rows, read through the transpose
// bit): SBO is the 8-row groups along K, 1024 bytes apart; LBO the
// stride from one 64-wide swizzle atom of M or N to the next (a tile of
// several 64-column TMA boxes: the box's bytes; unused where M or N is
// 64, one atom); a k-step of 16 rows adds 2048 bytes (128). A K-major A
// operand of 64 rows has the
// K-major B's form. A wider row (hd 128) lies in two such tiles (two TMA
// boxes of 64 columns, `rows` x 128 bytes apart): a k-step past column 64
// moves to the second, and adding a byte offset to the tile adds it / 16
// to the descriptor.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo) << 16 | static_cast<uint64_t>(sbo) << 32 |
         1ull << 62;
}
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) {
  return sw128_desc(tile, 1, 64);
}
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile,
                                                  uint32_t atom_bytes = 1024) {
  return sw128_desc(tile, atom_bytes >> 4, 64);
}

#define RT_ACC32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define RT_ACC16(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define RT_D16                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define RT_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (+)= A . B over k 16: A [64, 16] from registers (the mma.sync m16n8k16
// A fragment of each warp's 16 rows, as load_a_sw128 gives it, or as an
// accumulator packs into bf16 pairs: register i of d holds row 16 (warp %
// 4) + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i %
// 2), B [16, 64] in shared memory: K-major (kTransB 0: its 64 rows of n, k
// contiguous) or MN-major (kTransB 1: its 16 rows of k, n contiguous,
// read through the transpose bit). `accumulate` 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         uint32_t accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : RT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(kTransB));
}

// The same over a 32-wide N (m64n32k16): d holds 16 registers, register i
// at row 16 (warp % 4) + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2
// (lane % 4) + i % 2, as above.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b,
                                         uint32_t accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " RT_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : RT_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(kTransB));
}

// d (+)= A . B over k 16 and a 32-wide N, both operands in shared memory,
// K-major (descriptors `a` [64, 16] and `b` [32, 16]).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, uint32_t accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " RT_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : RT_ACC16(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#define RT_ACC128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
  "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
  "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
  "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), \
  "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), \
  "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), \
  "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), \
  "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
  "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), \
  "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), \
  "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), \
  "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), \
  "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), \
  "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), \
  "+f"(d[127])
#define RT_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
  "%122, %123, %124, %125, %126, %127} "

// d += A . B over k 16 and a 256-wide N, both operands in shared memory
// (descriptors `a` [64, 16] and `b` [256, 16]), each K-major (kTrans 0)
// or MN-major (kTrans 1: its 16 rows of k, M or N contiguous, read through
// the transpose bit); d always accumulates. d holds 128 registers:
// register i at row 16 (warp % 4) + lane / 4 + 8 ((i / 2) % 2), column 8
// (i / 4) + 2 (lane % 4) + i % 2.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " RT_D128
      ", %128, %129, p, 1, 1, %131, %132;\n}\n"
      : RT_ACC128(d)
      : "l"(a), "l"(b), "r"(1), "n"(kTransA), "n"(kTransB));
}

// The A fragments (k 0 .. 16 KS) of this warp's 16 rows of a 64-row slice
// of a 128-byte swizzled tile (the slice 1024-byte aligned), by ldmatrix:
// row r's 16-byte chunk c lies at chunk c ^ (r % 8); k-steps 4 .. 7 (hd
// 128) lie in the second box, `box` bytes on. Fragments that feed
// the wgmma of several loop iterations need fence_regs after each
// iteration's last wgmma_wait: without it ptxas (CUDA 12.9) takes the
// registers of a wgmma's A operand as free once the wgmma has run, and
// the SASS reuses them for the next values packed in the loop.
template <int KS>
__device__ __forceinline__ void load_a_sw128(uint32_t (&a)[KS][4],
                                             const uint8_t* slice, int warp,
                                             int lane, int box = 0) {
  const int r = warp * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = (kk % 4) * 2 + (lane >> 4);
    ldmatrix_x4(a[kk],
                slice + (kk / 4) * box + r * 128 + ((c ^ (r & 7)) << 4));
  }
}

#undef RT_D128
#undef RT_ACC128
#undef RT_D16
#undef RT_ACC16
#undef RT_D32
#undef RT_ACC32

// the 1024-byte aligned start of dynamic shared memory (the launch asks
// for 1024 bytes more than its layout)
__device__ __forceinline__ uint8_t* align1024(void* p) {
  return static_cast<uint8_t*>(p) + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ------------------------------------------------------------ host

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &got);
#endif
    return e == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A contiguous bf16 [B, S, heads, hd] tensor as a 4-d TMA map (hd
// innermost) read in boxes of `rows` consecutive positions of one head and
// 64 columns (one 128-byte swizzle row; hd 128 takes two boxes, at column
// 0 and 64), 128-byte swizzled; positions past S read as zeros. hd is a
// multiple of `hd_multiple`: 64 by default, so that the boxes tile a row;
// a caller that lays a narrower row out at the next multiple of 64 (hd
// 112 as 128) passes 8, the least that keeps a position's stride a
// multiple of 16 bytes, and its last box reads the columns past hd as
// zeros. False if the map cannot be encoded.
inline bool encode_rows(CUtensorMap* map, const void* base, int hd, int heads,
                        int S, int B, int rows, int hd_multiple = 64) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn || hd % hd_multiple || hd % 8) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A contiguous bf16 [depth, rows, cols] tensor as a 3-d TMA map (cols
// innermost) read or written in boxes of 64 columns (one 128-byte swizzle
// row) by `box_rows` rows of one depth index, 128-byte swizzled; elements
// past the tensor's bounds read as zeros and are not written. The rows'
// byte strides must be multiples of 16, so cols % 8 == 0, and the base
// 16-byte aligned. False if the map cannot be encoded.
inline bool encode_3d(CUtensorMap* map, const void* base, int cols, int rows,
                      int depth, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn || cols % 8 || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the device's SM count, asked once per device
inline int sm_count() {
  static int count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

}  // namespace rt
