"""Planner-S — the seconds-scale frequency/load re-planner (paper Fig. 11).

Planner-S keeps Planner-L's TP assignments (re-sharding is expensive) and
re-solves only the frequency and load dimension against *near-real-time*
power and workload, inside the GPU budget GPU_{s,c,t} that Planner-L
granted. Two effects (paper §5.3):

  * power drops below the 15-min prediction → downclock / shed load
    instead of dropping requests (elasticity);
  * power rises above it → upclock for better TTFT/TBT than planned.

The Fig. 11 ILP has no single-(f,l) constraint (no Y variables) — Planner-S
may split a config across frequencies; it is therefore much smaller and
runs in milliseconds-to-seconds even at 64 sites.

The problem is assembled over a ``ColumnPool`` restricted to the granted
(s, c, t) groups (see ``repro_torch.core.planning``), and the budget itself
travels as a columnar ``GpuBudget`` (legacy dicts are coerced). Repeated
re-solves inside a slot pass ``warm=<previous plan>``: the previous
counts are mapped onto the current columns and handed to
``solve_milp``'s warm path, which accepts them after repair when they
sit within 1% of the fresh LP bound — the common case when power/load
moved a few percent between seconds (status ``"warm"``).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from repro_torch.core.lookup import LookupTable, Row
from repro_torch.core.milp import solve_milp
from repro_torch.core.planner_l import DROP_PENALTY, Objective, Plan, SiteSpec
from repro_torch.core.planning import (ColumnPool, ConstraintBuilder, FleetState,
                                 GpuBudget, sct_key, trim_surplus)


def _warm_vector(warm: Plan, cols: list[tuple[int, Row]], pool: ColumnPool,
                 cost: np.ndarray, g_gpus: np.ndarray, codes: np.ndarray,
                 power_w: np.ndarray,
                 load_per_class: np.ndarray) -> np.ndarray:
    """Project a previous plan onto the current problem's column layout.

    Mapping the old counts alone is not enough: a feasible-but-stale
    point parks every load increase in the (heavily penalised) slack
    variables and keeps surplus instances on load decrease, so it would
    always fail ``solve_milp``'s LP-bound acceptance gap. The projection
    therefore also *optimizes at the margin* — trim surplus capacity
    (most expensive per rps first), then cover per-class shortfall with
    cheapest-completion columns inside the GPU-budget and power
    headroom (Fig. 11 has no one-(f,l) rule, so groups may mix points).
    Residual shortfall becomes slack.
    """
    n = len(pool)
    x0 = np.zeros(n + 9)
    wp = getattr(warm, "_pool", None)
    if wp is not None and wp.table is pool.table and len(wp):
        # vectorized join on (site, table-row) keys — the hot path when
        # chaining plan_s results (both plans carry their column pool)
        R = len(pool.table.rows)
        wkey = wp.site * R + wp.row_idx
        order = np.argsort(wkey, kind="stable")
        ckey = pool.site * R + pool.row_idx
        pos = np.clip(np.searchsorted(wkey[order], ckey), 0, len(order) - 1)
        hit = wkey[order][pos] == ckey
        x0[:n][hit] = np.asarray(warm.counts, float)[order][pos[hit]]
    else:
        prev = {(s, r): int(x)
                for (s, r), x in zip(warm.columns, warm.counts) if x > 0}
        if prev:
            x0[:n] = [prev.get(col, 0) for col in cols]
    load = np.maximum(np.asarray(load_per_class, float), 0.0)
    xc = x0[:n]
    trim_surplus(xc, pool, cost, load)
    st = FleetState(xc, pool, cost, g_gpus, codes, power_w,
                    enforce_sct=False)
    st.shed_overdraw()          # power dropped: free the worst W/rps
    st.cover_all(load)          # ... and re-cover at feasible rows
    x0[n:] = np.maximum(load - st.cap, 0.0)
    return x0


def plan_s(table: LookupTable, sites: list[SiteSpec], power_w: np.ndarray,
           load_per_class: np.ndarray,
           gpu_budget: Union[GpuBudget, dict],
           *, objective: Objective = "latency",
           frozen_sct: Optional[set] = None,
           time_limit: float = 10.0,
           warm: Optional[Plan] = None,
           site_rate: Optional[np.ndarray] = None) -> Plan:
    """Solve the Fig. 11 ILP.

    ``gpu_budget``: GPU_{s,c,t} from Planner-L's last plan — a columnar
    ``GpuBudget`` (``Plan.gpu_budget_pool()``) or a legacy dict.
    ``frozen_sct``: (s,c,t) groups with pending TP reconfigurations — the
    Configurator excludes them from placement (paper §4, Configurator).
    ``warm``: a previous Planner-S plan over the same budget; its counts
    seed the solve (see module docstring).
    ``site_rate``: per-site [S] price/carbon signal for the grid
    objectives ("cost"/"carbon") — see ``ColumnPool.cost``.
    """
    S = len(sites)
    budget = GpuBudget.coerce(gpu_budget)
    pool = ColumnPool.for_budget(table, budget, S, frozen_sct)
    n = len(pool)
    if n == 0:
        return Plan(columns=[], counts=np.zeros(0, int),
                    unserved=np.maximum(load_per_class, 0.0),
                    objective=objective, status="empty", solve_seconds=0.0,
                    num_sites=S)

    nv = n + 9
    iZ = np.arange(n)
    iSl = n + np.arange(9)
    c_vec = np.zeros(nv)
    c_vec[iZ] = pool.cost(objective, site_rate)
    c_vec[iSl] = DROP_PENALTY

    b = ConstraintBuilder(nv)
    # (1) per-site power cap at near-real-time power
    b.ub(pool.site, iZ, pool.power, np.asarray(power_w, float))
    # (3) per-(s,c,t) GPU budget from Planner-L — one row per granted
    # group that actually has columns, in sorted (s,c,t) order
    codes, g_site, g_cls, g_tp = pool.sct()
    g_key = sct_key(g_site, g_cls, g_tp)
    bud_key = sct_key(budget.site, budget.cls, budget.tp)
    g_gpus = budget.gpus[np.searchsorted(bud_key, g_key)].astype(float)
    b.ub(codes, iZ, pool.tp.astype(float), g_gpus)
    # (2) capacity with slack
    b.lb(np.concatenate([pool.cls, np.arange(9)]),
         np.concatenate([iZ, iSl]),
         np.concatenate([pool.load, np.ones(9)]),
         np.asarray(load_per_class, float))
    A_ub, b_ub, A_lb, b_lb = b.build()

    integrality = np.zeros(nv)
    integrality[iZ] = 1
    upper = np.full(nv, np.inf)
    upper[iZ] = (g_gpus[codes].astype(int)
                 // np.maximum(pool.tp, 1)).astype(float)
    upper[iSl] = np.maximum(load_per_class, 0.0)

    cols = pool.columns()
    x0 = (_warm_vector(warm, cols, pool, pool.cost(objective, site_rate),
                       g_gpus,
                       codes, np.asarray(power_w, float), load_per_class)
          if warm is not None else None)
    # two-part warm acceptance: slack terms tested separately from
    # completion cost, with a one-instance allowance *at the granularity
    # of the columns the LP actually leaves fractional* in slack-
    # saturated droughts (see core.milp docstring) — a pool-wide
    # load.max() allowance over-admitted drops whenever the pool merely
    # contained a large-instance group
    split = np.zeros(nv, bool)
    split[iSl] = True
    slack_unit = np.zeros(nv)
    slack_unit[iZ] = DROP_PENALTY * pool.load
    # the penalty test runs per class: each class's slack is measured
    # against its own fractional frontier, so a mixed pool does not
    # inherit the allowance of whichever class has the largest instances
    cls_vec = np.concatenate([pool.cls, np.arange(9)])
    res = solve_milp(c_vec, A_ub=A_ub, b_ub=b_ub, A_lb=A_lb, b_lb=b_lb,
                     integrality=integrality, upper=upper,
                     time_limit=time_limit, warm=x0, warm_split=split,
                     warm_slack_unit=slack_unit, warm_class=cls_vec)
    return Plan(columns=cols, counts=np.round(res.x[iZ]).astype(int),
                unserved=np.maximum(res.x[iSl], 0.0), objective=objective,
                status=res.status, solve_seconds=res.solve_seconds,
                num_sites=S, _cols=pool.column_arrays(), _pool=pool)
