"""Chunked RWKV6 recurrence on the card: wrapper of ``csrc/wkv6.cu``.

Port of the TPU kernel ``repro/kernels/wkv6.py:wkv6`` (the WKV6
recurrence over a segment from a carried state, in chunks; returns the
output and the final state, both fp32). The kernel's chunk is 32 tokens
and it takes any S: the reference kernel's default chunk of 64 overflows
at the model's decay clamp (see ``csrc/wkv6.cu``). The wrapper checks what
the kernel takes, allocates the outputs and launches on PyTorch's current
stream; ``wkv6.launches`` counts its launches. The plain versions are
``ref.wkv6_chunked_ref`` (the same chunked form) and ``ref.wkv6_ref`` (the
token-serial definition); ``ops`` chooses by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64)


@functools.cache
def _kernel():
    fn = build.load("wkv6").wkv6_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(dtype: torch.dtype, head_dim: int, batch: int,
         heads: int) -> dict:
    """How the kernel cuts a call: value-column slices per head (blocks
    per (b, h)) and the dynamic shared memory, in bytes, of its launch."""
    lib = build.load("wkv6")
    lib.wkv6_split.argtypes = [ctypes.c_int] * 3
    lib.wkv6_smem_bytes.argtypes = [ctypes.c_int] * 4
    return {"slices": lib.wkv6_split(head_dim, batch, heads),
            "smem": lib.wkv6_smem_bytes(DTYPES[dtype], head_dim, batch,
                                        heads)}


def wkv6(r, k, v, logw, u, state0):
    """r/k/v: [B,S,H,hd] (bf16 or fp32, one dtype); logw: [B,S,H,hd] fp32,
    clamped to [-1.5, 0) by the model; u: [H,hd] fp32; state0:
    [B,H,hd,hd] fp32; all contiguous CUDA tensors, hd in (16, 64) ->
    (out [B,S,H,hd] fp32, state [B,H,hd,hd] fp32)."""
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape \
            or logw.shape != r.shape:
        raise ValueError(f"shapes r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} logw {tuple(logw.shape)}")
    B, S, H, hd = r.shape
    if u.shape != (H, hd) or state0.shape != (B, H, hd, hd):
        raise ValueError(f"u {tuple(u.shape)} state0 {tuple(state0.shape)} "
                         f"do not match r {tuple(r.shape)}")
    for t in (r, k, v, logw, u, state0):
        if not t.is_cuda or t.device != r.device:
            raise ValueError("wkv6 kernel takes CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError("wkv6 kernel takes contiguous tensors")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r/k/v dtypes {r.dtype}, {k.dtype}, {v.dtype}: "
                         f"need one of {list(DTYPES)}")
    if any(t.dtype != torch.float32 for t in (logw, u, state0)):
        raise ValueError("logw, u and state0 must be fp32")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    state = torch.empty_like(state0)
    if B * H == 0:
        return out, state
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        logw.data_ptr(), u.data_ptr(), state0.data_ptr(),
                        out.data_ptr(), state.data_ptr(), DTYPES[r.dtype], hd,
                        B, S, H, stream)
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: cudaError {err}")
    wkv6.launches += 1
    return out, state


wkv6.launches = 0
