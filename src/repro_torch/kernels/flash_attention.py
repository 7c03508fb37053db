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

Training: ``flash_attention(..., lse=buf)`` also writes each (row,
head)'s log-sum-exp into a preallocated fp32 [B,H,Sq] buffer (plain
version ``ref.attention_lse_ref``). ``flash_attention_bwd`` runs the three
backward kernels of ``csrc/flash_attention_bwd.cu`` (plain version
``ref.attention_bwd_ref``): ``flash_attention_bwd_dot`` (D = sum dO * O),
``flash_attention_bwd_dkdv`` and ``flash_attention_bwd_dq``, each with
its own ``.launches``, at the head dims of ``BWD_HEAD_DIMS``.
``FlashAttentionFn`` is the autograd Function that ``ops`` sends a CUDA
call to when it builds a graph: kernel 1 with the LSE forward, the three
backward kernels backward. A failed launch raises; nothing falls back.
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
# the head dims the backward kernels are built for (q/k and v alike)
BWD_HEAD_DIMS = (64, 112, 128, 256)


@functools.cache
def _kernel():
    fn = build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
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


def flash_attention(q, k, v, *, causal: bool = True, prefix_len: int = 0,
                    lse=None):
    """q: [B,Sq,H,hd]; k: [B,Sk,KVH,hd]; v: [B,Sk,KVH,vd] CUDA tensors
    (bf16 or fp32, hd in HEAD_DIMS with vd = hd, or a pair of VALUE_DIMS;
    last dim contiguous, any other strides) -> [B,Sq,H,vd]. ``lse``: an
    optional contiguous fp32 [B,H,Sq] buffer on the same device, which
    the kernel fills with each row's log-sum-exp of its scaled scores."""
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
    if lse is not None and (lse.shape != (B, H, Sq) or lse.device != q.device
                            or lse.dtype != torch.float32
                            or not lse.is_contiguous()):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: need a "
                         f"contiguous float32 {(B, H, Sq)} on {q.device}")
    out = torch.empty((B, Sq, H, vd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(),
                        None if lse is None else lse.data_ptr(),
                        DTYPES[q.dtype], hd, vd, B, Sq, Sk,
                        H, KVH, ctypes.addressof(strides), int(causal),
                        int(prefix_len), 1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ------------------------------------------------------------- backward

@functools.cache
def _bwd_kernel(name: str):
    fn = getattr(build.load("flash_attention_bwd"), name)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {
        "flash_attention_bwd_dot": [P] * 3 + [I] * 5 + [P],
        "flash_attention_bwd_dkdv": [P] * 8 + [I] * 9 + [ctypes.c_float, P],
        "flash_attention_bwd_dq": [P] * 7 + [I] * 9 + [ctypes.c_float, P],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def bwd_smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory, in bytes, of the dK/dV and dQ launches at
    ``dtype`` and ``head_dim`` (0 for a width not built)."""
    fn = build.load("flash_attention_bwd").flash_attention_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn(DTYPES[dtype], head_dim)


def _check_bwd(ts, what: str) -> None:
    """The backward kernels take contiguous, 16-byte aligned CUDA tensors
    of one dtype (bf16 or fp32) on one device, at a head dim of
    BWD_HEAD_DIMS."""
    q = ts[0]
    for t in ts:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what} takes CUDA tensors on one device")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"{what}: dtype {t.dtype}, need one of "
                             f"{list(DTYPES)} for all")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} takes contiguous tensors at 16-byte "
                             "aligned addresses")
        if t.shape[-1] not in BWD_HEAD_DIMS:
            raise ValueError(f"{what}: head dim {t.shape[-1]}, the backward "
                             f"is built for {BWD_HEAD_DIMS}")


def _check_stats(t, shape, device, what: str) -> None:
    if (tuple(t.shape) != shape or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"{what}: {tuple(t.shape)} {t.dtype}, need a "
                         f"contiguous float32 {shape} on {device}")


def _launch(name: str, *args) -> None:
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(args[0].device):
        err = _bwd_kernel(name)(*ptrs, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def flash_attention_bwd_dot(o, do):
    """Kernel 1-bwd (a): D [B,H,Sq] fp32 = sum over the head dim of
    ``do`` * ``o`` [B,Sq,H,hd]."""
    _check_bwd((o, do), "flash_attention_bwd_dot")
    if o.shape != do.shape:
        raise ValueError(f"o {tuple(o.shape)} vs do {tuple(do.shape)}")
    B, Sq, H, hd = o.shape
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=o.device)
    if D.numel():
        _launch("flash_attention_bwd_dot", o, do, D, DTYPES[o.dtype], hd, B,
                Sq, H)
        flash_attention_bwd_dot.launches += 1
    return D


def _bwd_shapes(q, k, v, do, lse, D, what):
    _check_bwd((q, k, v, do), what)
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or do.shape != q.shape or KVH == 0 or H % KVH
            or B * KVH > 65535):
        raise ValueError(f"{what}: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} do {tuple(do.shape)}")
    for t, n in ((lse, "lse"), (D, "D")):
        _check_stats(t, (B, H, Sq), q.device, f"{what} {n}")
    return B, Sq, Sk, H, KVH, hd


def flash_attention_bwd_dkdv(q, k, v, do, lse, D, *, causal: bool = True,
                             prefix_len: int = 0):
    """Kernel 1-bwd (b): (dk, dv) [B,Sk,KVH,hd], summed over the G query
    heads of each KV head, from q, k, v, ``do`` and the forward's ``lse``
    and (a)'s ``D``."""
    B, Sq, Sk, H, KVH, hd = _bwd_shapes(q, k, v, do, lse, D,
                                        "flash_attention_bwd_dkdv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        _launch("flash_attention_bwd_dkdv", q, k, v, do, lse, D, dk, dv,
                DTYPES[q.dtype], hd, B, Sq, Sk, H, KVH, int(causal),
                int(prefix_len), 1.0 / math.sqrt(hd))
        flash_attention_bwd_dkdv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, D, *, causal: bool = True,
                           prefix_len: int = 0):
    """Kernel 1-bwd (c): dq [B,Sq,H,hd] from q, k, v, ``do`` and the
    forward's ``lse`` and (a)'s ``D``."""
    B, Sq, Sk, H, KVH, hd = _bwd_shapes(q, k, v, do, lse, D,
                                        "flash_attention_bwd_dq")
    dq = torch.empty_like(q)
    if dq.numel():
        _launch("flash_attention_bwd_dq", q, k, v, do, lse, D, dq,
                DTYPES[q.dtype], hd, B, Sq, Sk, H, KVH, int(causal),
                int(prefix_len), 1.0 / math.sqrt(hd))
        flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        prefix_len: int = 0):
    """Kernel 1's gradient -> (dq, dk, dv): D by (a), then (b) and (c).
    Inputs as ``flash_attention`` gave them (``o``, ``lse``) and the
    output's gradient ``do``, all contiguous (``ref.attention_bwd_ref``
    is the plain version)."""
    if prefix_len < 0:
        raise ValueError(f"prefix_len {prefix_len}")
    D = flash_attention_bwd_dot(o, do)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, D, causal=causal,
                                      prefix_len=prefix_len)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, D, causal=causal,
                                prefix_len=prefix_len)
    return dq, dk, dv


flash_attention_bwd_dot.launches = 0
flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dq.launches = 0


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address (a copy if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable kernel 1 on the card: the forward runs the kernel
    with its LSE output and saves q, k, v, the output and the LSE; the
    backward runs the three backward kernels. Head dims: BWD_HEAD_DIMS
    (checked in the forward, before any graph is built on it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, prefix_len: int):
        if q.shape[-1] not in BWD_HEAD_DIMS or v.shape[-1] != q.shape[-1]:
            raise ValueError(
                f"head dims q/k {q.shape[-1]}, v {v.shape[-1]}: the backward "
                f"kernels are built for {BWD_HEAD_DIMS} (q/k and v alike)")
        q, k, v = (_aligned(t) for t in (q, k, v))
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        o = flash_attention(q, k, v, causal=causal, prefix_len=prefix_len,
                            lse=lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.prefix_len = causal, prefix_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, _aligned(do),
                                         causal=ctx.causal,
                                         prefix_len=ctx.prefix_len)
        return dq, dk, dv, None, None
