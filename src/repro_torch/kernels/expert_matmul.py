"""Capacity-bucketed expert GEMM on the card: wrapper of
``csrc/expert_matmul.cu``.

Port of the TPU kernel ``repro/kernels/grouped_matmul.py:expert_matmul``
(``[E,C,D] x [E,D,F] -> [E,C,F]`` with fp32 accumulation; rows at or past
``fill[e]`` are zero). The wrapper checks what the kernel takes, allocates
the output and launches on PyTorch's current stream; ``expert_matmul
.launches`` counts its launches. The plain version is
``ref.expert_matmul_ref``; ``ops`` chooses between the two by the tensors'
device.

Training: ``expert_matmul_bwd_dx`` and ``expert_matmul_bwd_dw`` wrap the
two backward kernels of ``csrc/expert_matmul_bwd.cu`` (dX = dY W^T over
the live rows, zero past ``fill``; dW = X^T dY over the live rows), each
with its own ``.launches``; their plain version is
``ref.expert_matmul_bwd_ref``. Each has three bodies, chosen by the
library from dtype and shape (``bwd_body``): fp32 ``fma``; bf16
``wgmma`` (persistent, TMA-fed) where TMA can address every row, else
``mma.sync``. ``ExpertMatmulFn`` is the autograd Function that ``ops``
sends a CUDA call to when it builds a graph: the forward kernel forward,
the two backward kernels backward. A shape or dtype a kernel does not
take raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's bodies, as ``expert_matmul_bwd_body`` numbers them
BWD_BODIES = ("fma", "mma.sync", "wgmma")


@functools.cache
def _kernel():
    fn = build.load("expert_matmul").expert_matmul_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn(name: str, argtypes: tuple):
    fn = getattr(build.load("expert_matmul_bwd"), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _bwd_kernel(name: str):
    return _bwd_fn(name, (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
                   + (ctypes.c_void_p,))


def smem_bytes(dtype: torch.dtype, capacity: int) -> int:
    """Dynamic shared memory, in bytes, that the kernel's launch asks for
    at ``dtype`` and a bucket of ``capacity`` rows (C)."""
    fn = build.load("expert_matmul").expert_matmul_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(DTYPES[dtype], capacity)


def bwd_smem_bytes(body: str, dw: bool) -> int:
    """Dynamic shared memory, in bytes, of the dX (``dw`` False) or dW
    backward launch of ``body`` (one of ``BWD_BODIES``; 0 for ``fma``:
    static only)."""
    fn = _bwd_fn("expert_matmul_bwd_smem_bytes", (ctypes.c_int,) * 2)
    return fn(BWD_BODIES.index(body), int(dw))


def bwd_body(a, b, out, din: int, dout: int) -> str:
    """The body (one of ``BWD_BODIES``) that a backward launch takes on
    these operands, in the order of the entry's arguments: (dy, w, dxe)
    for dX, (xe, dy, dw) for dW. The library decides, from the dtype, the
    16-byte alignment of the three bases and ``din``, ``dout`` % 8."""
    fn = _bwd_fn("expert_matmul_bwd_body",
                 (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3)
    got = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), DTYPES[a.dtype],
             din, dout)
    if got < 0:
        raise ValueError(f"expert_matmul_bwd: no body for {a.dtype}")
    return BWD_BODIES[got]


def _check(ts, fill, what: str) -> None:
    """CUDA tensors on one device, contiguous, of one dtype (bf16 or
    fp32); ``fill`` [E] int32 beside them."""
    x = ts[0]
    for t in (*ts, fill):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what} kernel takes CUDA tensors on one "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in ts):
        raise ValueError(f"{what}: dtypes {[t.dtype for t in ts]}: need one "
                         f"of {list(DTYPES)} for all")
    if fill.dtype != torch.int32 or fill.shape != (x.shape[0],):
        raise ValueError(f"{what}: fill {fill.dtype} {tuple(fill.shape)}: "
                         "need [E] int32")


def _grid_ok(body: str, E, rows, cols) -> bool:
    """Whether ``body``'s grid holds an [E, rows, cols] output: wgmma
    numbers its 128 x 256 tiles in an int, the others put E in grid z and
    rows in y (tiles of 128 rows, fma's of 64)."""
    if body == "wgmma":
        return E * -(-rows // 128) * -(-cols // 256) < 2 ** 31
    return max(E, -(-rows // (64 if body == "fma" else 128))) <= 65535


def _launch_bwd(name: str, a, b, fill, out, E, C, Din, Dout) -> str:
    """Launches ``name`` and returns the body it took."""
    rows, cols = (Din, Dout) if name.endswith("dw") else (C, Din)
    body = bwd_body(a, b, out, Din, Dout)
    if not _grid_ok(body, E, rows, cols):
        raise ValueError(f"{name}: E {E}, C {C}, Din {Din}, Dout {Dout}: "
                         f"grid too large for the {body} body")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = _bwd_kernel(name)(a.data_ptr(), b.data_ptr(), fill.data_ptr(),
                                out.data_ptr(), DTYPES[a.dtype], E, C, Din,
                                Dout, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return body


def _count(fn, body: str) -> None:
    fn.launches += 1
    fn.bodies[body] = fn.bodies.get(body, 0) + 1


def expert_matmul_bwd_dx(dy, w, fill):
    """Kernel 6-bwd dX: dy [E,C,F] and w [E,D,F] -> dxe [E,C,D] = dy @ w^T
    on rows below ``fill[e]`` ([E] int32), zero past it; fp32
    accumulation, in dy's dtype."""
    if dy.dim() != 3 or w.dim() != 3 or (w.shape[0], w.shape[2]) != (
            dy.shape[0], dy.shape[2]):
        raise ValueError(f"expert_matmul_bwd_dx: shapes dy {tuple(dy.shape)} "
                         f"w {tuple(w.shape)}: need [E,C,F] and [E,D,F]")
    _check((dy, w), fill, "expert_matmul_bwd_dx")
    E, C, F = dy.shape
    D = w.shape[1]
    dxe = torch.empty((E, C, D), dtype=dy.dtype, device=dy.device)
    if dxe.numel():
        _count(expert_matmul_bwd_dx, _launch_bwd(
            "expert_matmul_bwd_dx", dy, w, fill, dxe, E, C, D, F))
    return dxe


def expert_matmul_bwd_dw(xe, dy, fill):
    """Kernel 6-bwd dW: xe [E,C,D] and dy [E,C,F] -> dw [E,D,F] = xe^T @ dy
    over the rows below ``fill[e]`` ([E] int32), in row order (zeros for
    an expert with none); fp32 accumulation, in xe's dtype."""
    if xe.dim() != 3 or dy.dim() != 3 or dy.shape[:2] != xe.shape[:2]:
        raise ValueError(f"expert_matmul_bwd_dw: shapes xe {tuple(xe.shape)} "
                         f"dy {tuple(dy.shape)}: need [E,C,D] and [E,C,F]")
    _check((xe, dy), fill, "expert_matmul_bwd_dw")
    E, C, D = xe.shape
    F = dy.shape[2]
    dw = torch.empty((E, D, F), dtype=xe.dtype, device=xe.device)
    if dw.numel():
        _count(expert_matmul_bwd_dw, _launch_bwd(
            "expert_matmul_bwd_dw", xe, dy, fill, dw, E, C, D, F))
    return dw


# launches, and launches by body (``BWD_BODIES``)
expert_matmul_bwd_dx.launches = 0
expert_matmul_bwd_dw.launches = 0
expert_matmul_bwd_dx.bodies = {}
expert_matmul_bwd_dw.bodies = {}


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
    _check((xe, w), fill, "expert_matmul")
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


class ExpertMatmulFn(torch.autograd.Function):
    """Differentiable kernel 6 on the card: the forward kernel forward
    (saving xe, w and fill), dX and dW by the backward kernels backward.
    The contraction of dW runs over each expert's live rows only, and a
    row past ``fill`` gets a zero dX: the output there is a constant."""

    @staticmethod
    def forward(ctx, xe, w, fill):
        xe, w = xe.contiguous(), w.contiguous()
        if fill is None:
            fill = torch.full((xe.shape[0],), xe.shape[1], dtype=torch.int32,
                              device=xe.device)
        out = expert_matmul(xe, w, fill)
        ctx.save_for_backward(xe, w, fill)
        return out

    @staticmethod
    def backward(ctx, dy):
        xe, w, fill = ctx.saved_tensors
        dy = dy.contiguous()
        dxe = (expert_matmul_bwd_dx(dy, w, fill)
               if ctx.needs_input_grad[0] else None)
        dw = (expert_matmul_bwd_dw(xe, dy, fill)
              if ctx.needs_input_grad[1] else None)
        return dxe, dw, None
