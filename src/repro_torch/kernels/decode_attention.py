"""One-token attention on the card: wrapper of ``csrc/decode_attention.cu``.

Port of the TPU kernel ``repro/kernels/decode_attention.py:decode_attention``
(attention of one new token over a ragged dense KV cache; ``lengths``
counts the token already inserted). The kernel is the paged decode's body
with each batch row as one page of S tokens; ``paged_decode_attention.plan``
(width 1, page S) gives its cut. The wrapper checks what the kernel
takes, allocates the output and launches on PyTorch's current stream;
``decode_attention.launches`` counts its launches. The plain version is
``ref.decode_attention_ref``; ``ops`` chooses between the two by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES

# the widths kernels 2 and 3 (the dense caches) are built for
HEAD_DIMS = (64, 112, 128, 256)
MAX_SPLITS = 8    # key splits of a row at most: one thread-block cluster


@functools.cache
def _kernel():
    fn = build.load("decode_attention").decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _aligned(t) -> bool:
    """Rows start on 16 bytes: the kernel reads them with vector loads."""
    es = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s * es % 16 == 0 for s in t.stride()[:-1]))


def decode_attention(q, k_cache, v_cache, lengths):
    """q: [B,H,hd]; caches: [B,S,KVH,hd] CUDA tensors (bf16 or fp32, hd
    in HEAD_DIMS, last dim contiguous, rows 16-byte aligned); lengths: [B] int32
    valid tokens per row, clamped to [0, S] by the kernel -> [B,H,hd]."""
    if (q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape
            or lengths.shape != (q.shape[0],)):
        raise ValueError(f"shapes q {tuple(q.shape)} k "
                         f"{tuple(k_cache.shape)} v {tuple(v_cache.shape)} "
                         f"lengths {tuple(lengths.shape)}")
    B, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != B or k_cache.shape[3] != hd or KVH == 0
            or H % KVH):
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(k_cache.shape)} (need H % KVH == 0)")
    for t in (q, k_cache, v_cache):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("decode_attention kernel takes CUDA tensors on "
                             "one device")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"dtype {t.dtype}: need one of {list(DTYPES)}")
        if t.stride(-1) != 1 or not _aligned(t):
            raise ValueError("head dim must be contiguous and rows 16-byte "
                             "aligned")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if (lengths.dtype != torch.int32 or lengths.device != q.device
            or not lengths.is_contiguous()):
        raise ValueError("lengths must be a contiguous int32 tensor on the "
                         "device of q")
    if MAX_SPLITS * B * KVH > 2 ** 31 - 1:
        raise ValueError(f"B*KVH {B * KVH}")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 8)(*q.stride()[:2],
                                      *k_cache.stride()[:3],
                                      *v_cache.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        lengths.data_ptr(), out.data_ptr(), DTYPES[q.dtype],
                        hd, B, S, H, KVH, ctypes.addressof(strides),
                        1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
