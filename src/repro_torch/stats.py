"""Shared order-statistics helpers: percentiles for every latency tail.

An empty sample reports NaN, not a fake-perfect 0.0: an engine that
completed nothing has no tail.
"""
from __future__ import annotations

import math
from typing import Iterable, Union

import numpy as np


def percentile(xs: Union[Iterable, np.ndarray], q: float, *,
               empty: float = math.nan) -> float:
    """q-th percentile of ``xs`` (linear interpolation), ``empty`` when
    the sample has no elements."""
    arr = np.asarray(list(xs) if not isinstance(xs, np.ndarray) else xs,
                     dtype=float)
    if arr.size == 0:
        return float(empty)
    return float(np.percentile(arr, q))


def percentiles(xs, qs: Iterable[float], *,
                empty: float = math.nan) -> list[float]:
    """Several percentiles of one sample (single sort)."""
    arr = np.asarray(list(xs) if not isinstance(xs, np.ndarray) else xs,
                     dtype=float)
    if arr.size == 0:
        return [float(empty) for _ in qs]
    return [float(v) for v in np.percentile(arr, list(qs))]


def finite_or(x: float, fallback: float = 0.0) -> float:
    """Map NaN/inf to ``fallback``, for JSON consumers that cannot carry
    NaN."""
    return float(x) if math.isfinite(x) else float(fallback)
