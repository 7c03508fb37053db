"""One-token attention over a paged cache on the card: wrappers of
``csrc/paged_decode_attention.cu``.

Port of the TPU kernel ``repro/kernels/decode_attention.py:
paged_decode_attention`` in its two forms, each with its own launch count:

  paged_decode_attention       fp pools (the dtype of q); ``lengths``
                               counts the token the caller just inserted;
  paged_decode_attention_int8  int8 pools with fp32 scales, dequantized in
                               the kernel, and the fresh token's own K/V
                               at full precision (``lengths`` counts only
                               the cached tokens).

The block table's sentinel (any id past the pool) is clamped to the
pool's last page, and each row's length to the table's width, so neither
faults. The plain versions are ``ref.paged_decode_attention_ref``; ``ops``
chooses by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import MAX_SPLITS, _aligned
from repro_torch.kernels.flash_attention import DTYPES

INT8 = 2          # the C interface's dtype code of an int8 cache
# the widths kernel 4 (and 4-int8) is built for: no hd 112, which no paged
# path runs (the hybrid keeps dense caches)
HEAD_DIMS = (64, 128, 256)


@functools.cache
def _kernel(lib: str, sym: str, n_ptrs: int, n_ints: int):
    """The C entry point ``sym`` of ``csrc/<lib>.cu``: ``n_ptrs`` pointers,
    ``n_ints`` ints, then strides, scale and stream."""
    fn = getattr(build.load(lib), sym)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def plan(dtype: torch.dtype, head_dim: int, heads: int, kv_heads: int,
         width: int, page: int) -> dict:
    """How the decode kernels cut a call over a cache of ``dtype`` (the
    pools' or the dense cache's: bf16, fp32 or int8) and ``width`` pages
    of ``page`` tokens (a dense cache of S tokens: width 1, page S): key
    splits (one cluster of blocks per row, KV head and group of up to 4
    query heads), keys per split and the dynamic shared memory, in bytes,
    of its launch. The cut follows the capacity, never the lengths."""
    fn = build.load("paged_decode_attention").paged_decode_attention_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    code = INT8 if dtype == torch.int8 else DTYPES.get(dtype, -1)
    if fn(code, head_dim, heads, kv_heads, width, page,
          ctypes.addressof(out)):
        raise ValueError(f"no decode kernel for {dtype} hd {head_dim} "
                         f"heads {heads}/{kv_heads} width {width} page "
                         f"{page}")
    return dict(zip(("splits", "split_len", "smem"), out))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _strides(t, n):
    return list(t.stride()[:n]) if t is not None else [0] * n


def check_decode(name, q, k, v, k_scale, v_scale, lengths, k_new, v_new,
                 widths=HEAD_DIMS):
    """Checks shared by the paged and the dense int8 decode: q [B,H,hd]
    with hd in ``widths`` (the entry point's);
    k/v [N,T,KVH,hd] (pages of T tokens, or batch rows of S); scales
    [N,T,KVH] fp32 with int8 caches; lengths [B] int32; k_new/v_new
    [B,KVH,hd] or None. Raises ValueError on what the kernel does not
    take."""
    if (q.dim() != 3 or k.dim() != 4 or v.shape != k.shape
            or lengths.shape != (q.shape[0],)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    B, H, hd = q.shape
    KVH = k.shape[2]
    if k.shape[3] != hd or KVH == 0 or H % KVH:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match cache "
                         f"{tuple(k.shape)} (need H % KVH == 0)")
    if hd not in widths:
        raise ValueError(f"{name}: head_dim {hd} not in {widths}")
    if q.dtype not in DTYPES:
        raise ValueError(f"{name}: q dtype {q.dtype}: need one of "
                         f"{list(DTYPES)}")
    int8 = k_scale is not None
    want = torch.int8 if int8 else q.dtype
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} kernel takes CUDA tensors on one "
                             "device")
        if t.stride(-1) != 1 or not _aligned(t):
            raise ValueError(f"{name}: head dim must be contiguous and rows "
                             "16-byte aligned")
    if k.dtype != want or v.dtype != want:
        raise ValueError(f"{name}: cache dtype {k.dtype}/{v.dtype}, need "
                         f"{want}")
    if int8:
        for t in (k_scale, v_scale):
            if (t is None or t.shape != k.shape[:3] or t.dtype != torch.float32
                    or t.device != q.device):
                raise ValueError(f"{name}: scales must be fp32 "
                                 f"{tuple(k.shape[:3])} on the device of q")
    if (k_new is None) != (v_new is None):
        raise ValueError(f"{name}: k_new and v_new come together")
    if k_new is not None:
        for t in (k_new, v_new):
            if (t.shape != (B, KVH, hd) or t.dtype != q.dtype
                    or t.device != q.device or t.stride(-1) != 1):
                raise ValueError(f"{name}: fresh k/v must be {(B, KVH, hd)} "
                                 f"{q.dtype} with a contiguous head dim")
    if (lengths.dtype != torch.int32 or lengths.device != q.device
            or not lengths.is_contiguous()):
        raise ValueError(f"{name}: lengths must be a contiguous int32 "
                         "tensor on the device of q")
    if MAX_SPLITS * B * KVH > 2 ** 31 - 1:
        raise ValueError(f"{name}: B*KVH {B * KVH}")


def decode_strides(q, k, v, k_scale, v_scale, k_new, v_new, tab_b):
    """The 19 element strides of ``paged_decode.cuh``'s ``Strides``."""
    vals = (_strides(q, 2) + _strides(k, 3) + _strides(v, 3)
            + _strides(k_scale, 3) + _strides(v_scale, 3)
            + _strides(k_new, 2) + _strides(v_new, 2) + [tab_b])
    return (ctypes.c_longlong * 19)(*vals)


def _paged(name, q, k_pool, v_pool, table, lengths, k_scale, v_scale,
           k_new, v_new):
    check_decode(name, q, k_pool, v_pool, k_scale, v_scale, lengths, k_new,
                 v_new)
    B, H, hd = q.shape
    P, page, KVH = k_pool.shape[:3]
    if (table.dim() != 2 or table.shape[0] != B or table.shape[1] < 1
            or table.dtype != torch.int32 or table.device != q.device
            or table.stride(-1) != 1):
        raise ValueError(f"{name}: table must be [B, W>=1] int32 on the "
                         f"device of q with unit column stride, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if P < 1 or page < 1:
        raise ValueError(f"{name}: pool {tuple(k_pool.shape)}")
    W = table.shape[1]
    if W * page > 2 ** 31 - 1:
        raise ValueError(f"{name}: table width {W} x page {page}")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    st = decode_strides(q, k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                        table.stride(0))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    cdtype = INT8 if k_scale is not None else DTYPES[q.dtype]
    with torch.cuda.device(q.device):
        err = _kernel("paged_decode_attention", "paged_decode_attention_fwd",
                      10, 9)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), table.data_ptr(),
            lengths.data_ptr(), _ptr(k_new), _ptr(v_new), out.data_ptr(),
            DTYPES[q.dtype], cdtype, hd, B, H, KVH, W, page, P,
            ctypes.addressof(st), 1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def paged_decode_attention(q, k_pool, v_pool, table, lengths):
    """q: [B,H,hd]; pools [P,page,KVH,hd] of q's dtype (bf16 or fp32, hd
    in HEAD_DIMS, rows 16-byte aligned); table [B,W] int32 (ids past the
    pool clamp to its last page); lengths [B] int32 valid tokens, the new
    one included, clamped to [0, W*page] -> [B,H,hd]."""
    out = _paged("paged_decode_attention", q, k_pool, v_pool, table,
                 lengths, None, None, None, None)
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_int8(q, k_pool, v_pool, k_scale, v_scale, table,
                                lengths, *, k_new=None, v_new=None):
    """As ``paged_decode_attention`` over int8 pools with fp32 scales
    [P,page,KVH]; ``lengths`` counts the cached tokens only, and the
    fresh token's ``k_new``/``v_new`` [B,KVH,hd] (q's dtype), if given,
    are attended at full precision after them."""
    out = _paged("paged_decode_attention_int8", q, k_pool, v_pool, table,
                 lengths, k_scale, v_scale, k_new, v_new)
    paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention_int8.launches = 0
