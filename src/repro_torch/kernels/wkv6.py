"""Chunked RWKV6 recurrence on the card: wrappers of ``csrc/wkv6.cu`` and
``csrc/wkv6_bwd.cu``.

Port of the TPU kernel ``repro/kernels/wkv6.py:wkv6`` (the WKV6
recurrence over a segment from a carried state, in chunks; returns the
output and the final state, both fp32). The kernel's chunk is 32 tokens
and it takes any S: the reference kernel's default chunk of 64 overflows
at the model's decay clamp (see ``csrc/wkv6.cu``). For training it also
writes the state at each chunk's start, which kernel 7-bwd
(``wkv6_bwd``, port only: the reference differentiates its chunked scan
in XLA) reads as it walks the chunks in reverse. ``WKV6Fn`` joins the
two under autograd. The wrappers check what the kernels take, allocate
the outputs and launch on PyTorch's current stream; ``wkv6.launches``
and ``wkv6_bwd.launches`` count their launches. The plain versions are
``ref.wkv6_chunked_ref`` (the same chunked form, with ``chunk_states``
for the training forward), ``ref.wkv6_ref`` (the token-serial
definition) and ``ref.wkv6_chunked_bwd_ref``; ``ops`` chooses by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64)
BWD_HEAD_DIMS = HEAD_DIMS     # kernel 7-bwd's instantiations
CHUNK = 32                    # both kernels' chunk (csrc/wkv6.cu kChunk)


@functools.cache
def _kernel():
    fn = build.load("wkv6").wkv6_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
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


def _check(r, k, v, logw, u, what, *more):
    """The forward's and the backward's common checks -> (B, S, H, hd)."""
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape \
            or logw.shape != r.shape:
        raise ValueError(f"{what}: shapes r {tuple(r.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} logw "
                         f"{tuple(logw.shape)}")
    B, S, H, hd = r.shape
    if u.shape != (H, hd):
        raise ValueError(f"{what}: u {tuple(u.shape)} does not match r "
                         f"{tuple(r.shape)}")
    for t in (r, k, v, logw, u, *more):
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"{what} kernel takes CUDA tensors on one "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"{what}: r/k/v dtypes {r.dtype}, {k.dtype}, "
                         f"{v.dtype}: need one of {list(DTYPES)}")
    if any(t.dtype != torch.float32 for t in (logw, u, *more)):
        raise ValueError(f"{what}: logw, u and the states must be fp32")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} not in {HEAD_DIMS}")
    return B, S, H, hd


def n_chunks(S: int) -> int:
    return -(-S // CHUNK)


def wkv6(r, k, v, logw, u, state0, *, chunk_states=None):
    """r/k/v: [B,S,H,hd] (bf16 or fp32, one dtype); logw: [B,S,H,hd] fp32,
    clamped to [-1.5, 0) by the model; u: [H,hd] fp32; state0:
    [B,H,hd,hd] fp32; all contiguous CUDA tensors, hd in (16, 64) ->
    (out [B,S,H,hd] fp32, state [B,H,hd,hd] fp32). ``chunk_states``, if
    given, a contiguous fp32 [B, ceil(S/32), H, hd, hd] the kernel fills
    with the state at each chunk's start (the training forward); serving
    leaves it None and the kernel writes nothing there."""
    B, S, H, hd = _check(r, k, v, logw, u, "wkv6", state0,
                         *(() if chunk_states is None else (chunk_states,)))
    if state0.shape != (B, H, hd, hd):
        raise ValueError(f"state0 {tuple(state0.shape)} does not match r "
                         f"{tuple(r.shape)}")
    if chunk_states is not None and \
            chunk_states.shape != (B, n_chunks(S), H, hd, hd):
        raise ValueError(f"chunk_states {tuple(chunk_states.shape)}: want "
                         f"{(B, n_chunks(S), H, hd, hd)}")
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    state = torch.empty_like(state0)
    if B * H == 0:
        return out, state
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        logw.data_ptr(), u.data_ptr(), state0.data_ptr(),
                        out.data_ptr(), state.data_ptr(),
                        None if chunk_states is None
                        else chunk_states.data_ptr(), DTYPES[r.dtype], hd,
                        B, S, H, stream)
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: cudaError {err}")
    wkv6.launches += 1
    return out, state


wkv6.launches = 0


@functools.cache
def _bwd_kernel():
    lib = build.load("wkv6_bwd")
    fn = lib.wkv6_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wkv6_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
    return fn


def bwd_smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """The dynamic shared memory, in bytes, of a kernel 7-bwd launch."""
    _bwd_kernel()
    return build.load("wkv6_bwd").wkv6_bwd_smem_bytes(DTYPES[dtype],
                                                      head_dim)


def wkv6_bwd(r, k, v, logw, u, chunk_states, dout, dstate=None):
    """Kernel 7-bwd: the gradient of ``wkv6`` from its inputs, the chunk
    states its training forward wrote, the output's gradient ``dout``
    [B,S,H,hd] fp32 and the final state's ``dstate`` [B,H,hd,hd] fp32
    (None: zero); all contiguous CUDA tensors -> (dr, dk, dv in r's
    dtype, dlogw fp32, du [H,hd] fp32, dstate0 fp32). du is the sum over B
    of the kernel's per-(b, h) partials; no float atomics anywhere, so
    the result repeats bit for bit and a row's bits do not depend on B."""
    more = (chunk_states, dout) + (() if dstate is None else (dstate,))
    B, S, H, hd = _check(r, k, v, logw, u, "wkv6_bwd", *more)
    if chunk_states.shape != (B, n_chunks(S), H, hd, hd) \
            or dout.shape != r.shape or (
                dstate is not None and dstate.shape != (B, H, hd, hd)):
        raise ValueError(
            f"wkv6_bwd: chunk_states {tuple(chunk_states.shape)}, dout "
            f"{tuple(dout.shape)}, dstate "
            f"{None if dstate is None else tuple(dstate.shape)} do not "
            f"match r {tuple(r.shape)}")
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlogw = torch.empty_like(logw)
    du_part = torch.empty((B, H, hd), dtype=torch.float32, device=r.device)
    dstate0 = torch.empty((B, H, hd, hd), dtype=torch.float32,
                          device=r.device)
    if B * H == 0:
        return dr, dk, dv, dlogw, du_part.sum(0), dstate0
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = _bwd_kernel()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), chunk_states.data_ptr(), dout.data_ptr(),
            None if dstate is None else dstate.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
            du_part.data_ptr(), dstate0.data_ptr(), DTYPES[r.dtype], hd, B,
            S, H, stream)
    if err:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: cudaError {err}")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dlogw, du_part.sum(0), dstate0


wkv6_bwd.launches = 0


class WKV6Fn(torch.autograd.Function):
    """Differentiable kernel 7 on the card: the forward runs the kernel
    with its chunk-state output and saves r, k, v, logw, u and the chunk
    states; the backward runs kernel 7-bwd and returns a gradient for
    each input that needs one. Head dims: BWD_HEAD_DIMS (checked in the
    forward, before any graph is built on it)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0):
        if r.shape[-1] not in BWD_HEAD_DIMS:
            raise ValueError(f"head_dim {r.shape[-1]}: kernel 7-bwd is "
                             f"built for {BWD_HEAD_DIMS}")
        B, S, H, hd = r.shape
        states = torch.empty((B, n_chunks(S), H, hd, hd),
                             dtype=torch.float32, device=r.device)
        out, state = wkv6(r, k, v, logw, u, state0, chunk_states=states)
        ctx.save_for_backward(r, k, v, logw, u, states)
        ctx.set_materialize_grads(False)
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, logw, u, states = ctx.saved_tensors
        dout = (torch.zeros(r.shape, dtype=torch.float32, device=r.device)
                if dout is None else dout.contiguous())
        grads = wkv6_bwd(r, k, v, logw, u, states, dout,
                         None if dstate is None else dstate.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
