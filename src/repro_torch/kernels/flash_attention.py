"""Prefill attention on the card: wrapper of ``csrc/flash_attention.cu``.

Port of the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
(causal online-softmax GQA attention with an optional bidirectional
prefix). The wrapper checks what the kernel takes, allocates the output and
launches on PyTorch's current stream; ``flash_attention.launches`` counts
its launches. q and k share a head dim in ``HEAD_DIMS``, which v shares
too, except for the pairs of ``VALUE_DIMS``: MLA's expanded prefill, q/k
192 over v 128. Each kernel's wrapper keeps its own widths: hd 112
(zamba2) is kernel 1's, 2's and 3's, not 4's or 5's. The plain version is ``ref.attention_ref``; ``ops`` chooses
between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 112, 128, 256)
# q/k width -> the v width it takes where the two differ
VALUE_DIMS = {192: 128}


@functools.cache
def _kernel():
    fn = build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(dtype: torch.dtype, head_dim: int,
               value_dim: int | None = None) -> int:
    """Dynamic shared memory, in bytes, that the kernel's launch asks for
    at ``dtype``, q/k width ``head_dim`` and v width ``value_dim``
    (default ``head_dim``)."""
    fn = build.load("flash_attention").flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(DTYPES[dtype], head_dim, value_dim or head_dim)


def flash_attention(q, k, v, *, causal: bool = True, prefix_len: int = 0):
    """q: [B,Sq,H,hd]; k: [B,Sk,KVH,hd]; v: [B,Sk,KVH,vd] CUDA tensors
    (bf16 or fp32, hd in HEAD_DIMS with vd = hd, or a pair of VALUE_DIMS;
    last dim contiguous, any other strides) -> [B,Sq,H,vd]."""
    if q.dim() != 4 or k.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    vd = v.shape[3]
    Sk, KVH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KVH == 0 or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (need H % KVH == 0)")
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention kernel takes CUDA tensors on "
                             "one device")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"dtype {t.dtype}: need one of {list(DTYPES)}")
        if t.stride(-1) != 1:
            raise ValueError("head dim must be contiguous")
    if not (hd in HEAD_DIMS and vd == hd or VALUE_DIMS.get(hd) == vd):
        raise ValueError(f"head dims q/k {hd}, v {vd}: need one of "
                         f"{HEAD_DIMS} for both, or q/k over v in "
                         f"{VALUE_DIMS}")
    if prefix_len < 0 or B * KVH > 65535:
        raise ValueError(f"prefix_len {prefix_len}, B*KVH {B * KVH}")
    out = torch.empty((B, Sq, H, vd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), DTYPES[q.dtype], hd, vd, B, Sq, Sk,
                        H, KVH, ctypes.addressof(strides), int(causal),
                        int(prefix_len), 1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
