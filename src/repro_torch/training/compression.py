"""Gradient compression: per-tensor absmax int8 quantisation.

Port of ``repro/training/compression.py``. Rounding is deterministic by
default (``torch.round``: half to even, as ``jnp.round``); the stochastic
mode adds uniform noise in [-0.5, 0.5) drawn from an explicit
``torch.Generator`` before rounding. ``train_step`` applies it behind
``compress_grads``.
"""
from __future__ import annotations

from typing import Optional

import torch


def compress_int8(x, *, generator: Optional[torch.Generator] = None):
    """x -> (q int8, scale fp32 scalar). Per-tensor absmax scaling."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-30) / 127.0
    y = x32 / scale
    if generator is not None:
        y = y + (torch.rand(y.shape, generator=generator,
                            device=generator.device) - 0.5).to(y.device)
    q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale
