"""Chunked RWKV6 recurrence on the card: wrappers of ``csrc/wkv6.cu`` and
``csrc/wkv6_bwd.cu``.

Port of the TPU kernel ``repro/kernels/wkv6.py:wkv6`` (the WKV6
recurrence over a segment from a carried state, in chunks; returns the
output and the final state, both fp32). The kernel's chunk is 32 tokens
and it takes any S: the reference kernel's default chunk of 64 overflows
at the model's decay clamp (see ``csrc/wkv6.cu``). For training it also
writes the state at each chunk's start, which kernel 7-bwd
(``wkv6_bwd``, port only: the reference differentiates its chunked scan
in XLA) reads. Kernel 7-bwd is four passes (``PASSES``): the dS pass
(``local``: each chunk's A^T dout; ``scan``: the gradient of the state at
every chunk's end, an elementwise reverse scan into a scratch buffer the
wrapper allocates), then ``chunk`` (every other gradient, a block per
(b, chunk, h)) and ``du`` (du's per-chunk partials summed in chunk
order). ``WKV6Fn`` joins the two kernels under autograd. The wrappers
check what the kernels take, allocate the outputs and launch on
PyTorch's current stream; ``wkv6.launches`` and ``wkv6_bwd.launches``
count their calls, ``wkv6_bwd.passes`` each pass's kernel launches. The
plain versions are ``ref.wkv6_chunked_ref`` (the same chunked form, with
``chunk_states`` for the training forward), ``ref.wkv6_ref`` (the
token-serial definition), ``ref.wkv6_bwd_ds_ref`` (the dS pass) and
``ref.wkv6_chunked_bwd_ref`` (the whole backward); ``ops`` chooses by the
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
    """The forward's and the backward's common checks -> (B, S, H, hd); k,
    v and u may be None where the kernel reads none of them (7-bwd's dS
    pass)."""
    kv = [t for t in (k, v) if t is not None]
    if r.dim() != 4 or any(t.shape != r.shape for t in (*kv, logw)):
        raise ValueError(f"{what}: shapes r {tuple(r.shape)} k/v "
                         f"{[tuple(t.shape) for t in kv]} logw "
                         f"{tuple(logw.shape)}")
    B, S, H, hd = r.shape
    if u is not None and u.shape != (H, hd):
        raise ValueError(f"{what}: u {tuple(u.shape)} does not match r "
                         f"{tuple(r.shape)}")
    fp32 = [t for t in (logw, u, *more) if t is not None]
    for t in (r, *kv, *fp32):
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"{what} kernel takes CUDA tensors on one "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors")
    if r.dtype not in DTYPES or any(t.dtype != r.dtype for t in kv):
        raise ValueError(f"{what}: r/k/v dtypes "
                         f"{[t.dtype for t in (r, *kv)]}: need one of "
                         f"{list(DTYPES)}")
    if any(t.dtype != torch.float32 for t in fp32):
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


# kernel 7-bwd's passes in launch order, and their bits in the C interface
PASSES = ("local", "scan", "chunk", "du")
_PASS_BIT = {p: 1 << i for i, p in enumerate(PASSES)}
_ALL = sum(_PASS_BIT.values())


@functools.cache
def _bwd_kernel():
    lib = build.load("wkv6_bwd")
    fn = lib.wkv6_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wkv6_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.wkv6_bwd_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    return fn


def bwd_smem_bytes(dtype: torch.dtype, head_dim: int) -> dict:
    """The dynamic shared memory, in bytes, of each pass of a kernel 7-bwd
    launch (0: none)."""
    _bwd_kernel()
    fn = build.load("wkv6_bwd").wkv6_bwd_smem_bytes
    return {p: fn(DTYPES[dtype], head_dim, _PASS_BIT[p]) for p in PASSES}


def bwd_blocks_per_sm(dtype: torch.dtype, head_dim: int) -> dict:
    """The blocks of each pass of kernel 7-bwd that one SM of the current
    device holds at once."""
    _bwd_kernel()
    fn = build.load("wkv6_bwd").wkv6_bwd_blocks_per_sm
    return {p: fn(DTYPES[dtype], head_dim, _PASS_BIT[p]) for p in PASSES}


def _bwd_launch(mask, r, k, v, logw, u, chunk_states, dout, dstate, outs,
                scratch) -> tuple:
    """Launch the passes in ``mask`` on the current stream; the pointers a
    pass does not read may be None. Returns the passes launched: the local
    and chunk passes have no block when S is 0."""
    B, S, H, hd = r.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = _bwd_kernel()(
            ptr(r), ptr(k), ptr(v), ptr(logw), ptr(u), ptr(chunk_states),
            ptr(dout), ptr(dstate), *map(ptr, outs), ptr(scratch), mask,
            DTYPES[r.dtype], hd, B, S, H, stream)
    if err:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: cudaError {err}")
    return tuple(p for p in PASSES if mask & _PASS_BIT[p]
                 and (S > 0 or p in ("scan", "du")))


def _bwd_buffers(r):
    """The backward's outputs (dr, dk, dv, dlogw, du_part, dstate0) and its
    scratch: dS at each chunk's end, then e^{c_L} and du's per-chunk
    partials."""
    B, S, H, hd = r.shape
    f32 = dict(dtype=torch.float32, device=r.device)
    outs = (*(torch.empty_like(r) for _ in range(3)),
            torch.empty((B, S, H, hd), **f32),
            torch.empty((B, H, hd), **f32), torch.empty((B, H, hd, hd), **f32))
    scratch = torch.empty(B * n_chunks(S) * H * hd * (hd + 2), **f32)
    return outs, scratch


def _check_bwd(r, k, v, logw, u, chunk_states, dout, dstate):
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
    return B, H


def wkv6_bwd(r, k, v, logw, u, chunk_states, dout, dstate=None):
    """Kernel 7-bwd: the gradient of ``wkv6`` from its inputs, the chunk
    states its training forward wrote, the output's gradient ``dout``
    [B,S,H,hd] fp32 and the final state's ``dstate`` [B,H,hd,hd] fp32
    (None: zero); all contiguous CUDA tensors -> (dr, dk, dv in r's
    dtype, dlogw fp32, du [H,hd] fp32, dstate0 fp32). Its four passes
    share a scratch buffer of B ceil(S/32) H hd (hd + 2) fp32, allocated
    here and freed on return. du is the sum over B of the kernel's
    per-(b, h) partials; no float atomics anywhere, so the result repeats
    bit for bit and a row's bits do not depend on B."""
    B, H = _check_bwd(r, k, v, logw, u, chunk_states, dout, dstate)
    outs, scratch = _bwd_buffers(r)
    dr, dk, dv, dlogw, du_part, dstate0 = outs
    if B * H == 0:
        return dr, dk, dv, dlogw, du_part.sum(0), dstate0
    for p in _bwd_launch(_ALL, r, k, v, logw, u, chunk_states, dout, dstate,
                         outs, scratch):
        wkv6_bwd.passes[p] += 1
    wkv6_bwd.launches += 1
    return dr, dk, dv, dlogw, du_part.sum(0), dstate0


wkv6_bwd.launches = 0
wkv6_bwd.passes = dict.fromkeys(PASSES, 0)


def wkv6_bwd_ds(r, logw, dout, dstate=None):
    """Kernel 7-bwd's dS pass alone (its ``local`` and ``scan`` kernels):
    r [B,S,H,hd] (bf16 or fp32), logw and dout [B,S,H,hd] fp32, dstate
    [B,H,hd,hd] fp32 or None (zero), contiguous CUDA tensors -> (the
    gradient of the state at each chunk's end [B, ceil(S/32), H, hd, hd],
    dstate0 [B,H,hd,hd]), both fp32: what ``ref.wkv6_bwd_ds_ref``
    computes. For tests and timing; ``wkv6_bwd`` runs these passes itself.
    Counts its calls in ``wkv6_bwd_ds.launches``."""
    B, S, H, hd = _check(r, None, None, logw, None, "wkv6_bwd_ds", dout,
                         *(() if dstate is None else (dstate,)))
    if dout.shape != r.shape or (dstate is not None
                                 and dstate.shape != (B, H, hd, hd)):
        raise ValueError(f"wkv6_bwd_ds: dout {tuple(dout.shape)}, dstate "
                         f"{None if dstate is None else tuple(dstate.shape)}"
                         f" do not match r {tuple(r.shape)}")
    n = n_chunks(S)
    f32 = dict(dtype=torch.float32, device=r.device)
    # these passes' part of the scratch: dS at each chunk's end, e^{c_L}
    scratch = torch.empty(B * n * H * hd * (hd + 1), **f32)
    dstate0 = torch.empty((B, H, hd, hd), **f32)
    if B * H:
        _bwd_launch(_PASS_BIT["local"] | _PASS_BIT["scan"], r, None, None,
                    logw, None, None, dout, dstate,
                    (None,) * 5 + (dstate0,), scratch)
        wkv6_bwd_ds.launches += 1
    return scratch[:B * n * H * hd * hd].view(B, n, H, hd, hd), dstate0


wkv6_bwd_ds.launches = 0


def bwd_pass_timers(r, k, v, logw, u, chunk_states, dout, dstate=None):
    """For timing each pass of kernel 7-bwd alone: runs the whole backward
    once on buffers of its own, then returns {pass: a function that
    launches that pass again on them}. The scan runs in place, so a
    repeated scan changes the scratch's values but not its work. These
    launches count in no ``launches``: they are not the main path's."""
    _check_bwd(r, k, v, logw, u, chunk_states, dout, dstate)
    outs, scratch = _bwd_buffers(r)
    args = (r, k, v, logw, u, chunk_states, dout, dstate, outs, scratch)
    _bwd_launch(_ALL, *args)
    return {p: functools.partial(_bwd_launch, _PASS_BIT[p], *args)
            for p in PASSES}


class WKV6Fn(torch.autograd.Function):
    """Differentiable kernel 7 on the card: the forward runs the kernel
    with its chunk-state output and saves r, k, v, logw, u and the chunk
    states; the backward runs kernel 7-bwd (its four passes) and returns
    a gradient for each input that needs one. Head dims: BWD_HEAD_DIMS
    (checked in the forward, before any graph is built on it)."""

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
