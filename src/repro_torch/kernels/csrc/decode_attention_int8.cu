// One-token GQA attention over a dense int8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:
// decode_attention_int8 (body _dec_kernel with scale refs): int8 caches
// [B, S, KVH, hd] with per-(token, KV head) fp32 scales [B, S, KVH],
// dequantized as they stream; attends over lengths[b] cached tokens
// (clamped to [0, S]) plus, when given, the fresh token's own K/V at full
// precision, as the reference's model path does. The same kernel as the
// paged decode (paged_decode.cuh, where its bound on the H100 and its
// design are described), with each batch row as one page of S tokens.

#include "paged_decode.cuh"

using namespace rt;
using namespace rt::paged;

// q [B, H, hd] (bf16 or fp32); caches [B, S, KVH, hd] int8; scales
// [B, S, KVH] fp32; lengths [B] int32; k_new/v_new [B, KVH, hd] of q's
// dtype or null; strides: the 19 element strides of paged_decode.cuh's
// Strides, the cache's (batch, seq, head) in the pool's (page, token,
// head) places. Returns the cudaError_t of the launch (0 on success).
extern "C" int decode_attention_int8_fwd(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* lengths, const void* k_new,
    const void* v_new, void* o, int qdtype, int hd, int B, int S, int H,
    int KVH, const long long* strides, float scale, void* stream) {
  return launch_int8<false>(qdtype, hd, q, k, v, ks, vs, nullptr, lengths,
                            k_new, v_new, o, B, H, KVH, 1, S, B, strides,
                            scale, static_cast<cudaStream_t>(stream));
}
