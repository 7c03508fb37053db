"""Shared order-statistics helper: one percentile for every latency tail.

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
