"""Capacity-bucketed expert GEMM on the card: wrapper of
``csrc/expert_matmul.cu``.

Port of the TPU kernel ``repro/kernels/grouped_matmul.py:expert_matmul``
(``[E,C,D] x [E,D,F] -> [E,C,F]`` with fp32 accumulation; rows at or past
``fill[e]`` are zero). The wrapper checks what the kernel takes, allocates
the output and launches on PyTorch's current stream; ``expert_matmul
.launches`` counts its launches. The plain version is
``ref.expert_matmul_ref``; ``ops`` chooses between the two by the tensors'
device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel():
    fn = build.load("expert_matmul").expert_matmul_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(dtype: torch.dtype, capacity: int) -> int:
    """Dynamic shared memory, in bytes, that the kernel's launch asks for
    at ``dtype`` and a bucket of ``capacity`` rows (C)."""
    fn = build.load("expert_matmul").expert_matmul_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(DTYPES[dtype], capacity)


def expert_matmul(xe, w, fill=None):
    """xe: [E,C,D]; w: [E,D,F] contiguous CUDA tensors of one dtype (bf16
    or fp32); ``fill`` [E] int32 on the same device (default C) ->
    [E,C,F] in xe's dtype."""
    if xe.dim() != 3 or w.dim() != 3 or w.shape[:2] != (xe.shape[0],
                                                        xe.shape[2]):
        raise ValueError(f"shapes xe {tuple(xe.shape)} w {tuple(w.shape)}: "
                         "need [E,C,D] x [E,D,F]")
    E, C, D = xe.shape
    F = w.shape[2]
    if fill is None:
        fill = torch.full((E,), C, dtype=torch.int32, device=xe.device)
    for t in (xe, w, fill):
        if not t.is_cuda or t.device != xe.device:
            raise ValueError("expert_matmul kernel takes CUDA tensors on one "
                             "device")
        if not t.is_contiguous():
            raise ValueError("expert_matmul kernel takes contiguous tensors")
    if xe.dtype not in DTYPES or w.dtype != xe.dtype:
        raise ValueError(f"dtypes {xe.dtype}, {w.dtype}: need one of "
                         f"{list(DTYPES)} for both")
    if fill.dtype != torch.int32 or fill.shape != (E,):
        raise ValueError(f"fill {fill.dtype} {tuple(fill.shape)}: need [E] "
                         "int32")
    if max(E, -(-C // 64)) > 65535:
        raise ValueError(f"E {E}, C {C}: grid too large")
    out = torch.empty((E, C, F), dtype=xe.dtype, device=xe.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(xe.device).cuda_stream
    with torch.cuda.device(xe.device):
        err = _kernel()(xe.data_ptr(), w.data_ptr(), fill.data_ptr(),
                        out.data_ptr(), DTYPES[xe.dtype], E, C, D, F, stream)
    if err:
        raise RuntimeError(f"expert_matmul kernel launch failed: "
                           f"cudaError {err}")
    expert_matmul.launches += 1
    return out


expert_matmul.launches = 0
