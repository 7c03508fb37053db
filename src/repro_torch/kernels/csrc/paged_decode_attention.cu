// One-token GQA attention over a paged KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:
// paged_decode_attention (body _paged_dec_kernel), in both its forms:
//  * fp pools (bf16 or fp32, the dtype of q): the serving path inserts the
//    new token first, so ``lengths`` counts it;
//  * int8 pools with per-(page, token, KV head) fp32 scales, dequantized
//    as they stream, plus the fresh token's own K/V at full precision
//    (``lengths`` counts only the cached tokens).
// The kernel, its bound on the H100 and what its design does about the
// bound are in paged_decode.cuh.

#include "paged_decode.cuh"

using namespace rt;
using namespace rt::paged;

// q [B, H, hd]; pools [P, page, KVH, hd] of cdtype (kInt8: with scales
// [P, page, KVH] fp32, and q's dtype otherwise); table [B, W] int32;
// lengths [B] int32; k_new/v_new [B, KVH, hd] of q's dtype or null;
// strides: the 19 element strides of paged_decode.cuh's Strides.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* lengths,
    const void* k_new, const void* v_new, void* o, int qdtype, int cdtype,
    int hd, int B, int H, int KVH, int W, int page, int num_pages,
    const long long* strides, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cdtype == kInt8)
    return launch_int8<true>(qdtype, hd, q, k, v, ks, vs, table, lengths,
                             k_new, v_new, o, B, H, KVH, W, page, num_pages,
                             strides, scale, s);
  if (cdtype != qdtype) return (int)cudaErrorInvalidValue;
#define RT_FP_CASE(T, CODE, HDV)                                              \
  if (qdtype == CODE && hd == HDV)                                            \
    return launch<T, T, HDV, true>(q, k, v, nullptr, nullptr, table, lengths, \
                                   k_new, v_new, o, B, H, KVH, W, page,       \
                                   num_pages, strides, scale, s);
  RT_FP_CASE(__nv_bfloat16, kBFloat16, 64)
  RT_FP_CASE(__nv_bfloat16, kBFloat16, 128)
  RT_FP_CASE(__nv_bfloat16, kBFloat16, 256)
  RT_FP_CASE(float, kFloat32, 64)
  RT_FP_CASE(float, kFloat32, 128)
  RT_FP_CASE(float, kFloat32, 256)
#undef RT_FP_CASE
  return (int)cudaErrorInvalidValue;
}

// How the decode kernels (this one, decode_attention_fwd and
// decode_attention_int8_fwd; a dense cache of S tokens is W = 1, page = S)
// cut a call: out[0..2] = key splits (the cluster size), keys per split,
// dynamic shared memory in bytes. cdtype: the cache's dtype code. Returns
// 0, or cudaErrorInvalidValue for a (cdtype, hd, H, KVH, W, page) no entry
// point takes.
extern "C" int paged_decode_attention_plan(int cdtype, int hd, int H,
                                           int KVH, int W, int page,
                                           int* out) {
  Plan p;
  if (KVH < 1 || H % KVH || W < 1 || page < 1)
    return (int)cudaErrorInvalidValue;
  const int e = plan(cdtype, hd, W, page, &p);
  if (e) return e;
  out[0] = p.splits, out[1] = p.split_len, out[2] = p.smem;
  return 0;
}
