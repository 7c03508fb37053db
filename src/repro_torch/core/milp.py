"""MILP solving substrate for the Heron planners.

Exact solves go through ``scipy.optimize.milp`` (HiGHS branch-and-cut —
the offline stand-in for the paper's COIN-OR CBC). Very large instances or
solver timeouts fall back to LP relaxation + floor-rounding + greedy
repair, which preserves feasibility of the ≤-constraints by construction
and repairs ≥-constraints (serving capacity) greedily by cheapest column.

Warm starts
-----------
``scipy.optimize.milp`` cannot seed an incumbent, so warm starting is
implemented *around* the solver: ``solve_milp(..., warm=x0)`` clips and
rounds the previous solution onto the new bounds, repairs it against the
new constraints (shed over-draw, add cheapest capacity), and accepts it —
skipping branch-and-cut entirely — iff its objective is within
``warm_accept_gap`` of the LP-relaxation lower bound of the *new*
problem. The LP bound makes the shortcut sound: a stale or badly
repaired solution fails the gap test and falls through to the cold
solve. Planner-S re-solves inside a slot move power/load by a few
percent per second, so the previous second's plan almost always passes
(status ``"warm"``), turning the per-second MILP into one LP plus a few
vector repairs.

Two-part acceptance (``warm_split``)
------------------------------------
Planner objectives mix two scales: completion cost (latency/power per
instance, O(1..1e3)) and slack penalised at ``DROP_PENALTY`` (1e6 per
unserved rps). A single relative gap on their sum collapses in
slack-saturated droughts: 1% of a slack-dominated objective is under a
rps of unserved, so the one-instance rounding gap between any integer
point and the fractional LP rejects every warm candidate — even ones
that match the true MILP optimum — and the planner cold-solves each
second exactly when solves are hardest. ``warm_split`` (a boolean mask
of the penalty columns) splits the test: the cost part must sit within
``warm_accept_gap`` of the LP's cost part, and the penalty part within
the same relative gap of the LP's penalty part *plus* an absolute
allowance ``warm_slack_abs`` (one instance-granularity of drops, in
objective units) that is granted only when the LP itself carries slack
— outside droughts the penalty test stays exact, so a warm point that
drops servable load is still rejected.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, linprog, milp


@dataclass
class MilpResult:
    x: np.ndarray
    status: str          # 'optimal' | 'warm' | 'fallback' | 'infeasible'
    objective: float
    solve_seconds: float
    used_fallback: bool = False


def solve_milp(c, A_ub=None, b_ub=None, A_lb=None, b_lb=None,
               integrality=None, upper=None, time_limit: float = 60.0,
               mip_rel_gap: float = 1e-3,
               warm: Optional[np.ndarray] = None,
               warm_accept_gap: float = 0.01,
               warm_split: Optional[np.ndarray] = None,
               warm_slack_abs: float = 0.0,
               warm_slack_unit: Optional[np.ndarray] = None,
               warm_class: Optional[np.ndarray] = None) -> MilpResult:
    """min c.x  s.t.  A_ub x <= b_ub,  A_lb x >= b_lb,  0 <= x <= upper.

    ``warm``: a previous solution over the same variable layout; accepted
    without a branch-and-cut solve when, after repair, it is feasible and
    within ``warm_accept_gap`` (relative) of the LP bound.
    ``warm_split``: boolean mask of penalty (slack) columns enabling the
    two-part acceptance test (see module docstring); ``warm_slack_abs``
    is the absolute penalty-part allowance granted when the LP itself
    carries slack. ``warm_slack_unit`` refines that allowance to the
    actual instance granularity: a per-variable array of the penalty cost
    of rounding that column by one unit (0 for columns that carry none) —
    the drought allowance becomes the largest unit among the non-penalty
    columns the LP left *fractional* (the true integer-rounding frontier)
    instead of a pool-wide worst case, so warm projections cannot
    over-admit drops on pools that merely *contain* large-instance
    groups. When given, it supersedes ``warm_slack_abs``.
    ``warm_class``: per-variable class ids partitioning the penalty test
    — the slack of each class is tested against its *own* class's
    fractional frontier, so a mixed pool no longer hands every class the
    allowance of whichever class carries the largest instances.
    """
    t0 = time.perf_counter()
    n = len(c)
    ub = np.full(n, np.inf) if upper is None else np.asarray(upper, float)
    integ = np.zeros(n) if integrality is None else np.asarray(integrality)

    if warm is not None:
        if len(warm) != n:
            raise ValueError(f"warm vector has {len(warm)} entries for "
                             f"{n} variables — stale layout?")
        x = _warm_repair(np.asarray(warm, float), c, A_ub, b_ub, A_lb, b_lb,
                         integ, ub)
        if x is not None:
            x_lp = _lp_solution(c, A_ub, b_ub, A_lb, b_lb, ub)
            if x_lp is not None and _warm_accept(c, x, x_lp, warm_split,
                                                 warm_accept_gap,
                                                 warm_slack_abs,
                                                 warm_slack_unit,
                                                 warm_class):
                return MilpResult(x=x, status="warm", objective=float(c @ x),
                                  solve_seconds=time.perf_counter() - t0)

    cons = []
    if A_ub is not None and A_ub.shape[0]:
        cons.append(LinearConstraint(A_ub, -np.inf, b_ub))
    if A_lb is not None and A_lb.shape[0]:
        cons.append(LinearConstraint(A_lb, b_lb, np.inf))
    bounds = Bounds(np.zeros(n), ub)
    res = milp(c=c, constraints=cons, bounds=bounds, integrality=integ,
               options={"time_limit": time_limit, "mip_rel_gap": mip_rel_gap})
    dt = time.perf_counter() - t0
    if res.status == 0 and res.x is not None:
        x = np.where(integ > 0, np.round(res.x), res.x)
        return MilpResult(x=x, status="optimal", objective=float(res.fun),
                          solve_seconds=dt)
    # ---- fallback: LP relax + round down + greedy repair ----
    x = _lp_round_repair(c, A_ub, b_ub, A_lb, b_lb, integ, ub)
    dt = time.perf_counter() - t0
    if x is None:
        return MilpResult(x=np.zeros(n), status="infeasible",
                          objective=float("inf"), solve_seconds=dt,
                          used_fallback=True)
    return MilpResult(x=x, status="fallback", objective=float(c @ x),
                      solve_seconds=dt, used_fallback=True)


def _stack_leq(A_ub, b_ub, A_lb, b_lb):
    """Fold A_lb x >= b_lb into the <= system: one (A, b) pair."""
    if A_lb is not None and A_lb.shape[0]:
        if A_ub is not None:
            return sparse.vstack([A_ub, -A_lb]), np.concatenate([b_ub, -b_lb])
        return -A_lb, -b_lb
    return A_ub, b_ub


def _lp_bound(c, A_ub, b_ub, A_lb, b_lb, ub) -> Optional[float]:
    """LP-relaxation lower bound (one HiGHS simplex, no integrality)."""
    x = _lp_solution(c, A_ub, b_ub, A_lb, b_lb, ub)
    return None if x is None else float(c @ x)


def _lp_solution(c, A_ub, b_ub, A_lb, b_lb, ub) -> Optional[np.ndarray]:
    """LP-relaxation optimum (one HiGHS simplex, no integrality)."""
    n = len(c)
    A, b = _stack_leq(A_ub, b_ub, A_lb, b_lb)
    res = linprog(c, A_ub=A, b_ub=b, bounds=list(zip(np.zeros(n), ub)),
                  method="highs")
    return res.x if res.success else None


def _warm_accept(c, x, x_lp, split, gap, slack_abs,
                 slack_unit=None, cls=None) -> bool:
    """LP-bound acceptance: single-part, or two-part when ``split`` set."""
    if split is None:
        bound = float(c @ x_lp)
        return float(c @ x) <= bound + gap * max(1.0, abs(bound))
    m = np.asarray(split, bool)
    cost_x, cost_lp = float(c[~m] @ x[~m]), float(c[~m] @ x_lp[~m])
    pen_lp = float(c[m] @ x_lp[m])
    # absolute (one-instance-granularity) allowances only when the LP
    # itself is slack-saturated — outside droughts a warm point must
    # serve everything the LP serves, and the cost test stays relative
    drought = pen_lp > 1e-9
    cost_allow = (float(c[~m].max()) if drought and (~m).any() else 0.0)
    if cost_x > cost_lp + gap * max(1.0, abs(cost_lp)) + cost_allow:
        return False
    if cls is None:
        pen_x = float(c[m] @ x[m])
        allow = _drought_allowance(x_lp, m, slack_abs, slack_unit) \
            if drought else 0.0
        return pen_x <= pen_lp + gap * max(1.0, abs(pen_lp)) + allow
    cl = np.asarray(cls)
    for k in np.unique(cl[m]):
        mk = m & (cl == k)
        pen_x_k = float(c[mk] @ x[mk])
        pen_lp_k = float(c[mk] @ x_lp[mk])
        # per-class drought test: a class only earns the one-instance
        # rounding allowance when the LP drops *its* load, and only at
        # the granularity of its own fractional columns
        allow_k = (_drought_allowance(x_lp, m, slack_abs, slack_unit,
                                      sel=cl == k)
                   if pen_lp_k > 1e-9 else 0.0)
        if pen_x_k > pen_lp_k + gap * max(1.0, abs(pen_lp_k)) + allow_k:
            return False
    return True


def _drought_allowance(x_lp, split, slack_abs, slack_unit,
                       sel=None) -> float:
    """Penalty-part absolute allowance granted inside a drought.

    With ``slack_unit`` (per-variable penalty of a one-unit rounding of
    that column), the allowance tracks the LP's actual integer frontier:
    the largest unit among non-penalty columns the LP left fractional —
    those are the columns an integer point must round, and rounding one
    down sheds at most its own instance of load. Columns the LP holds at
    integral values need no rounding, so a pool merely *containing* a
    large-instance group no longer widens acceptance. Falls back to the
    largest unit among active columns (degenerate LPs can sit on integer
    vertices while the warm point still re-rounds), then to the scalar
    ``slack_abs``. ``sel`` restricts the candidate columns to one class
    (the per-class acceptance passes each class's own column mask) and
    switches the fractional frontier from the largest unit to the *sum*
    of the class's fractional units — an integer point rounds each
    fractional variable down at most once, so the class can shed up to
    that sum, and with few classes sharing a pool several of its columns
    are routinely left fractional at the LP vertex.
    """
    if slack_unit is None:
        return slack_abs
    u = np.asarray(slack_unit, float)
    zi = ~split & (u > 0)
    if sel is not None:
        zi = zi & np.asarray(sel, bool)
    frac = zi & (np.abs(x_lp - np.round(x_lp)) > 1e-6)
    if frac.any():
        return float(u[frac].sum() if sel is not None else u[frac].max())
    active = zi & (x_lp > 1e-9)
    if active.any():
        return float(u[active].max())
    return 0.0


def _repair_geq(x, c, A_lb, b_lb, integ, ub, allowed=None) -> None:
    """Repair A_lb x >= b_lb in place: bump the cheapest helpful column.

    ``allowed`` optionally restricts the candidate columns (the final
    warm-repair pass uses it to fill residual shortfall with pure-slack
    columns only, which no ≤-row can re-break).
    """
    if A_lb is None or not A_lb.shape[0]:
        return
    A = sparse.csr_matrix(A_lb)
    for _ in range(10_000):
        lhs = A @ x
        short = lhs < b_lb - 1e-9
        if not short.any():
            break
        i = int(np.argmax(b_lb - lhs))
        col_gain = A[i].toarray().ravel()
        ok = (col_gain > 1e-12) & (x < ub - 1e-9)
        if allowed is not None:
            ok &= allowed
        cand = np.where(ok)[0]
        if len(cand) == 0:
            break  # cannot repair; return best effort
        j = cand[np.argmin(c[cand] / col_gain[cand])]
        x[j] += 1.0 if integ[j] > 0 else (b_lb[i] - lhs[i]) / col_gain[j]


def _repair_leq(x, A_ub, b_ub, integ) -> None:
    """Repair A_ub x <= b_ub in place: shed the heaviest contributor."""
    if A_ub is None or not A_ub.shape[0]:
        return
    A = sparse.csr_matrix(A_ub)
    for _ in range(10_000):
        lhs = A @ x
        over = lhs > b_ub + 1e-6
        if not over.any():
            break
        i = int(np.argmax(lhs - b_ub))
        row = A[i].toarray().ravel()
        cand = np.where((row > 1e-12) & (x > 1e-9))[0]
        if len(cand) == 0:
            break
        j = cand[np.argmax(row[cand] * np.maximum(x[cand], 1))]
        x[j] = max(0.0, x[j] - (1.0 if integ[j] > 0 else
                                (lhs[i] - b_ub[i]) / row[j]))


def _feasible(x, A_ub, b_ub, A_lb, b_lb) -> bool:
    if A_ub is not None and A_ub.shape[0]:
        if (A_ub @ x > b_ub + 1e-6).any():
            return False
    if A_lb is not None and A_lb.shape[0]:
        if (A_lb @ x < b_lb - 1e-6).any():
            return False
    return True


def _warm_repair(x0, c, A_ub, b_ub, A_lb, b_lb, integ,
                 ub) -> Optional[np.ndarray]:
    """Project a previous solution onto the new feasible region.

    Shed ≤-violations first (power dropped since the last solve), then
    add capacity for ≥-violations (load rose), then re-shed in case the
    additions overdrew a cap. The re-shed can break ≥-rows again (the
    classic shed/cover cycle when a cap binds tightly in a drought), so
    a final pass fills any residual shortfall using only columns with
    no ≤-row footprint — the pure slack variables — which nothing can
    re-break. Returns None if still infeasible — the caller then
    cold-solves.
    """
    x = np.clip(x0, 0.0, np.where(np.isfinite(ub), ub, np.inf))
    x[integ > 0] = np.round(x[integ > 0])
    x = np.minimum(x, np.where(np.isfinite(ub), ub, np.inf))
    _repair_leq(x, A_ub, b_ub, integ)
    _repair_geq(x, c, A_lb, b_lb, integ, ub)
    _repair_leq(x, A_ub, b_ub, integ)
    if A_ub is not None and A_ub.shape[0]:
        foot = np.asarray(abs(sparse.csr_matrix(A_ub)).sum(axis=0)).ravel()
        _repair_geq(x, c, A_lb, b_lb, integ, ub, allowed=foot <= 1e-12)
    return x if _feasible(x, A_ub, b_ub, A_lb, b_lb) else None


def _lp_round_repair(c, A_ub, b_ub, A_lb, b_lb, integ, ub):
    n = len(c)
    A, b = _stack_leq(A_ub, b_ub, A_lb, b_lb)
    res = linprog(c, A_ub=A, b_ub=b,
                  bounds=list(zip(np.zeros(n), ub)), method="highs")
    if not res.success:
        return None
    x = res.x.copy()
    x[integ > 0] = np.floor(x[integ > 0] + 1e-9)
    # repair >= constraints (capacity) by bumping the cheapest helpful column
    _repair_geq(x, c, A_lb, b_lb, integ, ub)
    # re-check <= feasibility; if violated, undo proportionally
    _repair_leq(x, A_ub, b_ub, integ)
    return x
