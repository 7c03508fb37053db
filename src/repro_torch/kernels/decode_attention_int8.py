"""One-token attention over a dense int8 cache on the card: wrapper of
``csrc/decode_attention_int8.cu``.

Port of the TPU kernel ``repro/kernels/decode_attention.py:
decode_attention_int8``: int8 caches with per-(token, KV head) fp32 scales,
dequantized in the kernel, over ``lengths`` cached tokens, plus the fresh
token's own K/V at full precision as the reference's model path attends
them. ``decode_attention_int8.launches`` counts its launches. The plain
version is ``ref.decode_attention_int8_ref``; ``ops`` chooses by device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.decode_attention import HEAD_DIMS
from repro_torch.kernels.flash_attention import DTYPES
from repro_torch.kernels.paged_decode_attention import (
    _kernel, _ptr, check_decode, decode_strides)


def decode_attention_int8(q, k_cache, v_cache, k_scale, v_scale, lengths, *,
                          k_new=None, v_new=None):
    """q: [B,H,hd] (bf16 or fp32, hd in ``decode_attention.HEAD_DIMS``);
    caches [B,S,KVH,hd] int8 (rows 16-byte aligned); scales [B,S,KVH] fp32; lengths [B] int32 cached tokens,
    clamped to [0, S]; k_new/v_new [B,KVH,hd] of q's dtype or None ->
    [B,H,hd]."""
    check_decode("decode_attention_int8", q, k_cache, v_cache, k_scale,
                 v_scale, lengths, k_new, v_new, HEAD_DIMS)
    if k_cache.shape[0] != q.shape[0]:
        raise ValueError(f"decode_attention_int8: cache batch "
                         f"{k_cache.shape[0]} != {q.shape[0]}")
    B, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    st = decode_strides(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                        0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel("decode_attention_int8", "decode_attention_int8_fwd",
                      9, 6)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(),
            _ptr(k_new), _ptr(v_new), out.data_ptr(), DTYPES[q.dtype], hd,
            B, S, H, KVH, ctypes.addressof(st), 1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(f"decode_attention_int8 kernel launch failed: "
                           f"cudaError {err}")
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
