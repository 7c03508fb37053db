"""Chunk attention continued from a paged cache on the card: wrapper of
``csrc/paged_extend_attention.cu``.

Port of the TPU kernel ``repro/kernels/flash_attention.py:
paged_extend_attention``: a chunk of queries at per-row offsets ``pos``
attends to the row's cached pages (positions ``< pos``) and then to its
own K/V under the causal triangle. ``paged_extend_attention.launches``
counts its launches. The plain version is
``ref.paged_extend_attention_ref``; ``ops`` chooses by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES

# the widths kernel 5 is built for: no hd 112, which no paged path runs
HEAD_DIMS = (64, 128, 256)


@functools.cache
def _kernel():
    fn = build.load("paged_extend_attention").paged_extend_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def plan(dtype: torch.dtype, head_dim: int, chunk: int, heads: int,
         kv_heads: int, width: int, page: int) -> dict:
    """How the kernel cuts a call of this shape: row blocks, key splits
    (one cluster of blocks per row block), keys per split and the dynamic
    shared memory, in bytes, of its launch."""
    fn = build.load("paged_extend_attention").paged_extend_attention_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    if fn(DTYPES[dtype], head_dim, chunk, heads, kv_heads, width, page,
          ctypes.addressof(out)):
        raise ValueError(f"no paged extend kernel for {dtype} hd {head_dim}")
    return dict(zip(("row_blocks", "splits", "split_len", "smem"), out))


def paged_extend_attention(q, k_pool, v_pool, k_new, v_new, table, pos):
    """q: [B,C,H,hd]; pools [P,page,KVH,hd]; k_new/v_new [B,C,KVH,hd], all
    CUDA tensors of one dtype (bf16 or fp32, hd in HEAD_DIMS, last dim
    contiguous); table [B,W] int32 (ids past the pool clamp to its last
    page); pos [B] int32 cached tokens per row, clamped to [0, W*page]
    -> [B,C,H,hd]."""
    if (q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape
            or k_new.dim() != 4 or v_new.shape != k_new.shape):
        raise ValueError(f"shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} new "
                         f"{tuple(k_new.shape)}/{tuple(v_new.shape)}")
    B, C, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    P, page, KVH = k_pool.shape[:3]
    if (k_pool.shape[3] != hd or KVH == 0 or H % KVH
            or k_new.shape != (B, C, KVH, hd)):
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)} and new "
                         f"{tuple(k_new.shape)} (need H % KVH == 0)")
    for t in (q, k_pool, v_pool, k_new, v_new):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("paged_extend_attention kernel takes CUDA "
                             "tensors on one device")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"dtype {t.dtype}: need one of {list(DTYPES)}")
        if t.stride(-1) != 1:
            raise ValueError("head dim must be contiguous")
    if (table.dim() != 2 or table.shape[0] != B or table.shape[1] < 1
            or table.dtype != torch.int32 or table.device != q.device
            or table.stride(-1) != 1):
        raise ValueError(f"table must be [B, W>=1] int32 on the device of q "
                         f"with unit column stride, got {tuple(table.shape)}")
    if (pos.shape != (B,) or pos.dtype != torch.int32
            or pos.device != q.device or not pos.is_contiguous()):
        raise ValueError("pos must be a contiguous [B] int32 tensor on the "
                         "device of q")
    W = table.shape[1]
    if P < 1 or B * KVH > 65535 or W * page > 2 ** 31 - 1:
        raise ValueError(f"pool pages {P}, B*KVH {B * KVH}, width {W}")
    out = torch.empty((B, C, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 16)(
        *q.stride()[:3], *k_pool.stride()[:3], *v_pool.stride()[:3],
        *k_new.stride()[:3], *v_new.stride()[:3], table.stride(0))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        k_new.data_ptr(), v_new.data_ptr(), table.data_ptr(),
                        pos.data_ptr(), out.data_ptr(), DTYPES[q.dtype], hd,
                        B, C, H, KVH, W, page, P, ctypes.addressof(strides),
                        1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(f"paged_extend_attention kernel launch failed: "
                           f"cudaError {err}")
    paged_extend_attention.launches += 1
    return out


paged_extend_attention.launches = 0
