// One-token GQA attention over a ragged dense KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:decode_attention
// (body _dec_kernel): out[b, h] = softmax(q[b, h] . k[b, j, h // G] /
// sqrt(hd) over j < lengths[b]) @ v[b, :, h // G], fp32 accumulation,
// output in the input dtype. ``lengths`` counts the token the caller has
// just inserted, and is clamped to [0, S]; a row of length 0 gives 0.
// The same kernel as the paged decode (paged_decode.cuh, where its bound on
// the H100 and its design are described), with each batch row as one page
// of S tokens and no table.
// Inputs are strided views (last dim contiguous, rows 16-byte aligned);
// the output is a contiguous [B, H, hd] tensor the wrapper allocated.

#include "paged_decode.cuh"

using namespace rt;
using namespace rt::paged;

// strides: element strides of q over (batch, head) and of the k and v
// caches over (batch, seq, head), 8 values. lengths: [B] int32 on device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int dtype, int hd, int B, int S,
                                    int H, int KVH, const long long* strides,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the cache's (batch, seq, head) strides in the pool's (page, token, head)
  // places of the 19; no scales, no fresh token, no table
  long long st[kNumStrides] = {};
  for (int i = 0; i < 8; ++i) st[i] = strides[i];
#define RT_DENSE_CASE(T, CODE, HDV)                                           \
  if (dtype == CODE && hd == HDV)                                             \
    return launch<T, T, HDV, false>(q, k, v, nullptr, nullptr, nullptr,      \
                                    lengths, nullptr, nullptr, o, B, H, KVH,  \
                                    1, S, B, st, scale, s);
  RT_DENSE_CASE(__nv_bfloat16, kBFloat16, 64)
  RT_DENSE_CASE(__nv_bfloat16, kBFloat16, 112)
  RT_DENSE_CASE(__nv_bfloat16, kBFloat16, 128)
  RT_DENSE_CASE(__nv_bfloat16, kBFloat16, 256)
  RT_DENSE_CASE(float, kFloat32, 64)
  RT_DENSE_CASE(float, kFloat32, 112)
  RT_DENSE_CASE(float, kFloat32, 128)
  RT_DENSE_CASE(float, kFloat32, 256)
#undef RT_DENSE_CASE
  return (int)cudaErrorInvalidValue;
}
