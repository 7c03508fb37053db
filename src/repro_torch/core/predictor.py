"""Power & workload predictors (paper §2.3).

The paper's systems insight is that both wind generation and request
arrival have lag-1 autocorrelation ≥ 0.99 at 15-min granularity, so simple
time-series predictors are near-oracle and Heron can plan ahead. The
paper's own AI prediction framework is explicitly *orthogonal* work and is
treated as an oracle; we ship the same interface with three backends:

  ``oracle``       — returns the true next-slot value (paper's evaluation
                     setting for both planners);
  ``persistence``  — x̂_{t+1} = x_t (what autocorr 0.99 justifies);
  ``ar2``          — damped-trend AR: x̂ = x_t + β (x_t − x_{t−1}).

Predictors are *safe-sided* for power when ``margin`` > 0: the planner
plans against (1 − margin)·x̂ so residual mispredictions surface as spare
headroom, not request drops (Planner-S absorbs the rest, §5.3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import numpy as np

Kind = Literal["oracle", "persistence", "ar2"]


@dataclass
class SeriesPredictor:
    series: np.ndarray              # [T] ground truth
    kind: Kind = "oracle"
    margin: float = 0.0             # safe-side derating (power only)
    beta: float = 0.6               # damped-trend coefficient for ar2

    def predict(self, t: int) -> float:
        """Forecast for slot ``t`` made at the end of slot ``t-1``."""
        s = self.series
        if self.kind == "oracle" or t == 0:
            val = float(s[min(t, len(s) - 1)])
        elif self.kind == "persistence" or t == 1:
            val = float(s[t - 1])
        else:
            val = float(s[t - 1] + self.beta * (s[t - 1] - s[t - 2]))
        lo = float(s.min()) if len(s) else 0.0
        return max(lo, val * (1.0 - self.margin))

    def errors(self) -> np.ndarray:
        """Relative one-step-ahead errors over the whole series."""
        preds = np.array([self.predict(t) for t in range(1, len(self.series))])
        truth = self.series[1:]
        return np.abs(preds - truth) / np.maximum(np.abs(truth), 1e-9)


def autocorrelation(x: np.ndarray, lag: int = 1) -> float:
    x = np.asarray(x, float)
    a, b = x[:-lag], x[lag:]
    a = a - a.mean()
    b = b - b.mean()
    return float((a * b).mean() / (a.std() * b.std() + 1e-12))


def autocorr_by_granularity(x: np.ndarray, windows: list[int]) -> dict[int, float]:
    """Fig 7: aggregate to W-slot windows, report lag-1 autocorrelation."""
    out = {}
    for w in windows:
        n = (len(x) // w) * w
        agg = x[:n].reshape(-1, w).sum(axis=1)
        out[w] = autocorrelation(agg, 1)
    return out
