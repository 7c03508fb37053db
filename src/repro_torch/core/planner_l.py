"""Planner-L — the 15-min lookahead ILP (paper Fig. 10).

Given per-site power/GPU budgets, predicted per-class peak load, and the
profiling lookup table, choose integer instance counts X_{c,f,t,s,l}
minimizing aggregate E2E latency (or power) subject to:

  (1) per-site GPU cap           (2) per-site power cap
  (3) per-class serving capacity (4,5) one (f,l) per (s,c,t) via binary Y
  (6,7) bounded reconfigurations vs the previous plan

Deviations from the literal Fig. 10:
  * Reconfiguration counting is at (s,c,t) granularity — *TP* changes,
    which is the stated intent ("Planner-L bounds TP reconfigurations") —
    and counts *drains* of live instances only: bring-up of fresh
    instances on idle GPUs is hidden by DynamoLLM-style background weight
    transfer (the paper adopts exactly this optimisation, K3), and
    capacity that already lost its power needs no drain. Without this,
    the diurnal load ramp itself would exhaust R_L — an artifact the
    paper's wording ("TP changes") clearly does not intend.
  * A per-class slack variable (heavily penalised) keeps the ILP feasible
    under extreme power droughts; slack == predicted request drops. The
    paper handles the same situation operationally ("min-latency converges
    to min-power in extreme resource-constrained cases").

Solve paths
-----------
The Fig. 10 ILP couples sites only through the per-class serving-capacity
constraint (3) and the fleet drain budget (6,7) — everything else ((1),
(2), (4), (5)) is block-diagonal per site. The monolithic HiGHS solve
exploits none of that structure and hits a wall around ~16 heterogeneous
sites (~10 s/slot); the paper's own premise (cross-farm complementarity)
and follow-up systems (XWind-style cross-site routing over dozens-to-
hundreds of micro-DCs) live exactly in the regime the monolith cannot
reach. ``plan_l`` therefore has two paths:

  * ``method="decomposed"`` (the default at every fleet size) —
    Lagrangian price decomposition on the coupling constraints. An LP
    relaxation of the aggregate problem — including the fleet drain
    budget — yields per-class capacity prices λ_c, a per-drain price
    λ_R (the budget row's dual), and fractional per-site capacity
    quotas. Each site then solves a small independent ILP covering its
    quota at minimum cost, with declined quota priced at the fleet
    marginal λ_c and drains of its live (s, c, t) groups priced at λ_R.
    Sites whose LP restriction rounds cleanly (residual shortfall
    within one-instance granularity) skip branch-and-cut outright —
    most do; the hard remainder are independent ILPs run in a
    ``ProcessPoolExecutor`` (``workers=``; contiguous chunks, results
    reassembled in site order — bit-identical to the sequential loop).
    A drain-aware surplus-trim, greedy cheapest-column repair, and a
    projection step that restores live capacity when the independent
    site solutions jointly overshoot R_L close the feasibility and
    integrality gaps; a drain-guarded cross-site 1-swap polish closes
    most of the rest. Fleet drains stay ≤ R_L on every slot
    (tests/test_planning.py) with objectives within ~1% of the monolith
    wherever the monolith can finish.
  * ``method="monolithic"`` — the original single HiGHS branch-and-cut
    over the full column pool, kept as the exact reference for parity
    tests and small-fleet A/B runs.

``method="auto"`` (the default) is an alias for ``decomposed``: the
two-regime site-count split is gone now that the decomposition enforces
the full Fig. 10 constraint set, R_L included.

Interactive-rate re-plans at 10k sites (``PlannerLSession``)
------------------------------------------------------------
Consecutive 15-min slots differ by a handful of forecast deltas, not a
new fleet — so the stateless cold solve is the wrong unit of work for
the steady state. ``PlannerLSession`` keeps per-slot state and layers
three reuse mechanisms on the decomposition:

  * **Restricted master with warm support** — the aggregate LP is
    solved over the previous slot's support columns plus a per-site
    deduplicated capacity seed (one column per (site, class); a site's
    class-c columns share its GPU/power headroom, so seeding more of
    them only bloats the LP). Negative-reduced-cost columns are priced
    in over at most ``max_rounds=2`` rounds of ``batch=8192`` — the
    large batch captures nearly all of the omitted rounds' columns in
    one cheaper resolve (objective within ~0.5% of full convergence).
    CSR constraint assembly is cached across slots; the support handed
    to the next slot is pruned back to LP-active ∪ integer-active
    columns so restricted LPs cannot compound across a week.
  * **Incremental dirty-site re-plans** — a site is *dirty* when its
    power or its load-weighted forecast moved by more than
    ``dirty_tol`` (relative); clean sites keep the previous slot's
    accepted quota ILP solutions verbatim while a compact sub-master
    (rows and columns restricted to the dirty sites, clean capacity
    folded into the class balances) re-prices only the dirty set —
    O(dirty) work per slot. The session falls back to a full warm
    re-plan when the dirty fraction exceeds ``max_dirty_frac`` (default
    0.5), when the fleet load vector itself moved, or on the first
    slot; ``plan.meta["fallback"]`` names the reason. With every site
    dirty the incremental path is bit-identical to the full warm path
    (tests/test_planner_session.py).
  * **λ_R subgradient refinement** — when the fleet drain constraint
    is tight, per-site drain sub-budgets are seeded from the master's
    fractional drains and λ_R is refined by a few subgradient steps so
    the independent site ILPs price drains near the true fleet
    marginal instead of over/under-draining and leaning on repair.

The session's non-cold modes also relax the cross-site 1-swap polish
with a relative-gain cutoff (``swap_rel_tol``, default 1e-3): polishing
stops once a full round's improvement falls under 0.1% of plan cost.
``mode="cold"`` keeps every knob at the stateless setting and is
bit-identical to ``plan_l`` — the session is an optimization layer,
not a different planner. Measured on synthetic fleets
(BENCH_planning.json): 10240-site drain-active full re-plan < 1 s;
incremental re-plans ≥ 5x faster than full at ≤ 10% dirty with
objective ratio ≥ 0.99.
"""
from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Literal, Optional

import numpy as np

from repro_torch.core.lookup import LookupTable, Row
from repro_torch.core.milp import solve_milp
from repro_torch.core.planning import (ColumnPool, ConstraintBuilder, FleetState,
                                 GpuBudget, sct_key, sct_unkey, table_soa)

DROP_PENALTY = 1e6          # per unserved rps — dominates any latency gain
# "cost"/"carbon" price power by a per-site rate signal (electricity
# price / grid-carbon factors) — see ColumnPool.cost(site_rate=...)
Objective = Literal["latency", "power", "cost", "carbon"]
Method = Literal["auto", "monolithic", "decomposed"]


@dataclass(frozen=True)
class SiteSpec:
    name: str
    num_gpus: int


@dataclass
class Plan:
    """Solved assignment for one slot.

    Derived views (``gpu_used``/``power_used``/``capacity``/``mean_e2e``)
    are vectorized over cached per-column arrays (``column_arrays``) —
    shared zero-copy with the ``ColumnPool`` the planner solved over when
    available, built lazily otherwise — so they stay O(columns) numpy
    bincounts even when called every simulated second. ``group_table``
    returns the cached columnar dispatch table consumed by the Request
    Scheduler's fast path; ``gpu_budget_pool`` the columnar GPU_{s,c,t}
    grant consumed by Planner-S.
    """
    columns: list[tuple[int, Row]]          # (site, row) per column
    counts: np.ndarray                      # instances per column (int)
    unserved: np.ndarray                    # [9] rps that cannot be served
    objective: Objective
    status: str
    solve_seconds: float
    num_sites: int
    _cols: Optional[tuple] = field(default=None, repr=False, compare=False)
    _gtable: object = field(default=None, repr=False, compare=False)
    _pool: object = field(default=None, repr=False, compare=False)
    _bpool: object = field(default=None, repr=False, compare=False)
    #: solver diagnostics (mode, dirty-set size, master/pricing rounds,
    #: per-stage seconds) — populated by ``PlannerLSession``; excluded
    #: from equality so metered plans compare equal to unmetered ones
    meta: Optional[dict] = field(default=None, repr=False, compare=False)

    def column_arrays(self) -> tuple:
        """(site, cls, tp, load, power, e2e) parallel arrays, cached."""
        if self._cols is None:
            if self._pool is not None:
                self._cols = self._pool.column_arrays()
            else:
                n = len(self.columns)
                site = np.empty(n, dtype=np.intp)
                cls_ = np.empty(n, dtype=np.intp)
                tp = np.empty(n, dtype=float)
                load = np.empty(n, dtype=float)
                power = np.empty(n, dtype=float)
                e2e = np.empty(n, dtype=float)
                for i, (s, r) in enumerate(self.columns):
                    site[i] = s
                    cls_[i] = r.cls
                    tp[i] = r.tp
                    load[i] = r.load
                    power[i] = r.power
                    e2e[i] = r.e2e
                self._cols = (site, cls_, tp, load, power, e2e)
        return self._cols

    def group_table(self):
        """Cached columnar view of the active groups (fast dispatch)."""
        if self._gtable is None:
            from repro_torch.core.scheduler import GroupTable
            self._gtable = GroupTable.from_plan(self)
        return self._gtable

    # ---- derived views (vectorized) ----
    def gpu_used(self) -> np.ndarray:
        site, _, tp, _, _, _ = self.column_arrays()
        return np.bincount(site, weights=self.counts * tp,
                           minlength=self.num_sites)

    def power_used(self) -> np.ndarray:
        site, _, _, _, power, _ = self.column_arrays()
        return np.bincount(site, weights=self.counts * power,
                           minlength=self.num_sites)

    def capacity(self) -> np.ndarray:
        """[9] provisioned serving capacity in rps per class."""
        _, cls_, _, load, _, _ = self.column_arrays()
        return np.bincount(cls_, weights=self.counts * load, minlength=9)

    def mean_e2e(self, load_per_class: Optional[np.ndarray] = None) -> float:
        """Provisioned-capacity-weighted mean E2E latency.

        ``load_per_class`` is accepted for API compatibility but unused:
        the weighting is by provisioned rps (counts x row load), which is
        what the planner objective optimizes and what the comparisons in
        tests/benchmarks have always measured.
        """
        _, _, _, load, _, e2e = self.column_arrays()
        w = self.counts * load
        return float((w * e2e).sum()) / max(float(w.sum()), 1e-9)

    def total_power(self) -> float:
        return float(self.power_used().sum())

    def active(self) -> list[tuple[int, Row, int]]:
        return [(s, r, int(x)) for (s, r), x in zip(self.columns, self.counts)
                if x > 0]

    def gpu_budget_pool(self) -> GpuBudget:
        """GPU_{s,c,t} as a columnar pool — what Planner-S consumes.

        Cached like ``group_table``: the router re-reads it every
        simulated second between Planner-L solves.
        """
        if self._bpool is None:
            self._bpool = GpuBudget.from_plan(self)
        return self._bpool

    def gpu_budget(self) -> dict[tuple[int, int, int], int]:
        """GPU_{s,c,t} as a legacy dict (see ``gpu_budget_pool``)."""
        return self.gpu_budget_pool().as_dict()

    def wrr_weights(self) -> dict[int, list[tuple[int, Row, float]]]:
        """Per class: [(site, row, weight)] with weight ∝ provisioned rps."""
        cap = self.capacity()
        _, cls_, _, load, _, _ = self.column_arrays()
        counts = np.asarray(self.counts)
        active = np.nonzero((counts > 0) & (cap[cls_] > 0))[0]
        w = counts[active] * load[active] / cap[cls_[active]]
        out: dict[int, list[tuple[int, Row, float]]] = {c: [] for c in range(9)}
        for j, wj in zip(active.tolist(), w.tolist()):
            s, r = self.columns[j]
            out[r.cls].append((s, r, wj))
        return out

    def agg_by_sct(self) -> dict[tuple[int, int, int], int]:
        """Instance counts per (s, c, t) group — vectorized aggregation."""
        site, cls_, tp, _, _, _ = self.column_arrays()
        counts = np.asarray(self.counts)
        active = counts > 0
        if not active.any():
            return {}
        uniq, inv = np.unique(sct_key(site[active], cls_[active],
                                      tp[active].astype(np.intp)),
                              return_inverse=True)
        agg = np.bincount(inv, weights=counts[active]).astype(int)
        g_site, g_cls, g_tp = sct_unkey(uniq)
        return {(int(s), int(c), int(t)): int(a)
                for s, c, t, a in zip(g_site, g_cls, g_tp, agg)}


def build_columns(table: LookupTable, num_sites: int):
    """Legacy helper: the dense (site, Row) enumeration as a list."""
    return ColumnPool.dense(table, num_sites).columns()


# ------------------------------------------------------------------
# monolithic path (Fig. 10 verbatim)
# ------------------------------------------------------------------
def _solve_monolithic(pool: ColumnPool, sites: list[SiteSpec],
                      power_w: np.ndarray, load_per_class: np.ndarray,
                      objective: Objective, old: Optional[Plan],
                      r_frac: float, time_limit: float,
                      site_rate: Optional[np.ndarray] = None) -> Plan:
    S = len(sites)
    n = len(pool)
    col_cost = pool.cost(objective, site_rate)
    codes, g_site, g_cls, g_tp = pool.sct()
    G = len(g_site)

    use_reconfig = old is not None
    # variable layout: [X (n) | Y (n) | slack (9) | R (G)]
    nv = n + n + 9 + (G if use_reconfig else 0)
    iX = np.arange(n)
    iY = n + np.arange(n)
    iSl = 2 * n + np.arange(9)
    iR = 2 * n + 9 + np.arange(G) if use_reconfig else None

    c_vec = np.zeros(nv)
    c_vec[iX] = col_cost
    c_vec[iSl] = DROP_PENALTY

    gpus = np.array([s.num_gpus for s in sites], float)
    N_total = float(gpus.sum())
    b = ConstraintBuilder(nv)
    # (1) per-site GPU cap ; (2) per-site power cap (interleaved rows)
    rhs12 = np.empty(2 * S)
    rhs12[0::2] = gpus
    rhs12[1::2] = np.asarray(power_w, float)
    b.ub(np.concatenate([2 * pool.site, 2 * pool.site + 1]),
         np.concatenate([iX, iX]),
         np.concatenate([pool.tp.astype(float), pool.power]), rhs12)
    # (4) one (f,l) per (s,c,t):  sum_{f,l} Y <= 1
    b.ub(codes, iY, np.ones(n), np.ones(G))
    # (5) X <= N_total * Y
    b.ub(np.concatenate([np.arange(n), np.arange(n)]),
         np.concatenate([iX, iY]),
         np.concatenate([np.ones(n), np.full(n, -N_total)]), np.zeros(n))
    # (6,7) reconfiguration bound: drains of *live* previous capacity only.
    # Old capacity at a site is first scaled by how much of the old plan's
    # power draw the new slot's power still supports — capacity whose power
    # died needs no drain (the instances are dark regardless).
    if use_reconfig:
        old_agg = _live_old_agg(old, power_w, pool)
        r_limit = _drain_budget(old_agg, r_frac)
        # drain count: R >= old_live - sum X   (growth is free)
        b.ub(np.concatenate([codes, np.arange(G)]),
             np.concatenate([iX, iR]),
             np.concatenate([-np.ones(n), -np.ones(G)]), -old_agg)
        b.ub(np.zeros(G, dtype=np.intp), iR, np.ones(G), [r_limit])
    # (3) capacity: sum X*load + slack_c >= Load_c
    b.lb(np.concatenate([pool.cls, np.arange(9)]),
         np.concatenate([iX, iSl]),
         np.concatenate([pool.load, np.ones(9)]),
         np.asarray(load_per_class, float))
    A_ub, b_ub, A_lb, b_lb = b.build()

    integrality = np.zeros(nv)
    integrality[iX] = 1
    integrality[iY] = 1
    upper = np.full(nv, np.inf)
    upper[iX] = (gpus[pool.site].astype(int)
                 // np.maximum(pool.tp, 1)).astype(float)
    upper[iY] = 1.0
    upper[iSl] = np.maximum(load_per_class, 0.0)

    res = solve_milp(c_vec, A_ub=A_ub, b_ub=b_ub, A_lb=A_lb, b_lb=b_lb,
                     integrality=integrality, upper=upper,
                     time_limit=time_limit)
    x = res.x
    return Plan(columns=pool.columns(), counts=np.round(x[iX]).astype(int),
                unserved=np.maximum(x[iSl], 0.0), objective=objective,
                status=res.status, solve_seconds=res.solve_seconds,
                num_sites=S, _cols=pool.column_arrays(), _pool=pool)


def _drain_budget(old_agg: np.ndarray, r_frac: float) -> float:
    """R_L in instances: r_frac of the (power-scaled) live fleet, ≥ 1."""
    return max(1.0, r_frac * max(1.0, float(old_agg.sum())))


def _live_scale(old: Plan, power_w: np.ndarray) -> np.ndarray:
    """Per-site survival fraction of the old plan's power draw."""
    old_power = old.power_used()
    scale = np.ones(old.num_sites)
    pos = old_power > 0
    scale[pos] = np.minimum(
        1.0, np.asarray(power_w, float)[:old.num_sites][pos] / old_power[pos])
    return scale


def fleet_drains(old: Plan, new: Plan, power_w: np.ndarray) -> float:
    """Σ_g max(0, live_old_g − new_g) — the drain total R_L bounds.

    Counts drains of *live* previous capacity at (s, c, t) granularity,
    with old capacity power-scaled exactly as the planners scale it
    (capacity whose power died needs no drain). Public so tests and
    benchmarks can audit any plan pair against the budget.
    """
    pool = getattr(new, "_pool", None)
    if pool is not None and len(pool):
        old_agg = _live_old_agg(old, np.asarray(power_w, float), pool)
        new_g = np.bincount(pool.sct()[0],
                            weights=np.asarray(new.counts, float),
                            minlength=len(old_agg))
        return float(np.maximum(old_agg - new_g, 0.0).sum())
    scale = _live_scale(old, power_w)
    new_agg = new.agg_by_sct()
    return float(sum(max(0.0, v * scale[k[0]] - new_agg.get(k, 0))
                     for k, v in old.agg_by_sct().items()))


def drain_limit(old: Plan, power_w: np.ndarray, r_frac: float) -> float:
    """The R_L budget the planner enforces for this (old, power) slot."""
    scale = _live_scale(old, power_w)
    site = old.column_arrays()[0]
    total = float((np.asarray(old.counts, float) * scale[site]).sum())
    return max(1.0, r_frac * max(1.0, total))


def _live_old_agg(old: Plan, power_w: np.ndarray,
                  pool: ColumnPool) -> np.ndarray:
    """Old live instance counts per current (s,c,t) group, power-scaled."""
    codes, g_site, g_cls, g_tp = pool.sct()
    scale = _live_scale(old, power_w)
    if getattr(old, "_pool", None) is pool and len(pool):
        # same pool (chained session re-plans): each old column's group
        # is its own pool code — same weights, same accumulation order
        # as the searchsorted path below, so bit-identical
        return np.bincount(codes, weights=np.asarray(old.counts, float)
                           * scale[pool.site], minlength=len(g_site))
    g_key = sct_key(g_site, g_cls, g_tp)
    old_site, old_cls, old_tp, _, _, _ = old.column_arrays()
    old_key = sct_key(old_site, old_cls, old_tp.astype(np.intp))
    pos_idx = np.searchsorted(g_key, old_key)
    pos_idx = np.clip(pos_idx, 0, len(g_key) - 1)
    match = g_key[pos_idx] == old_key
    agg = np.zeros(len(g_key))
    np.add.at(agg, pos_idx[match],
              (np.asarray(old.counts, float) * scale[old_site])[match])
    return agg


# ------------------------------------------------------------------
# decomposed path (Lagrangian prices + per-site ILPs)
# ------------------------------------------------------------------
def _lp_master(pool: ColumnPool, gpus: np.ndarray, power_w: np.ndarray,
               load: np.ndarray, cost: np.ndarray,
               old_agg: Optional[np.ndarray] = None,
               r_limit: float = np.inf
               ) -> tuple[np.ndarray, float, np.ndarray]:
    """LP relaxation of the aggregate problem: prices + quotas.

    The LP drops integrality and the one-(f,l) constraint — it is the
    natural Lagrangian master: its capacity duals price one rps of each
    class at the margin, its (fractional) solution says how much
    capacity of each class each site should provision, and — when an
    old plan is present — the dual of its fleet drain-budget row prices
    one drained live instance at the margin (λ_R). Returns
    (prices [9], λ_R, x_lp [n]).
    """
    from scipy.optimize import linprog

    n = len(pool)
    if old_agg is not None:
        codes = pool.sct()[0]
        G = len(pool.sct()[1])
        dgrp = np.nonzero(old_agg > 1e-9)[0]
    else:
        dgrp = np.empty(0, dtype=np.intp)
    Gd = len(dgrp)
    nv = n + 9 + Gd
    c_vec = np.concatenate([cost, np.full(9, DROP_PENALTY), np.zeros(Gd)])
    b = ConstraintBuilder(nv)
    b.ub(pool.site, np.arange(n), pool.tp.astype(float), gpus)
    b.ub(pool.site, np.arange(n), pool.power, np.asarray(power_w, float))
    # capacity as <=:  -(sum load x + slack) <= -Load_c
    b.ub(np.concatenate([pool.cls, np.arange(9)]),
         np.concatenate([np.arange(n), n + np.arange(9)]),
         np.concatenate([-pool.load, -np.ones(9)]),
         -np.asarray(load, float))
    if Gd:
        # drain link per live group:  -Σ_{j∈g} x_j - d_g <= -old_g
        gmap = np.full(G, -1, dtype=np.intp)
        gmap[dgrp] = np.arange(Gd)
        loc = gmap[codes]
        msk = loc >= 0
        b.ub(np.concatenate([loc[msk], np.arange(Gd)]),
             np.concatenate([np.arange(n)[msk], n + 9 + np.arange(Gd)]),
             np.concatenate([-np.ones(int(msk.sum())), -np.ones(Gd)]),
             -old_agg[dgrp])
        # fleet drain budget:  Σ_g d_g <= R_L   (dual → λ_R)
        b.ub(np.zeros(Gd, dtype=np.intp), n + 9 + np.arange(Gd),
             np.ones(Gd), [float(r_limit)])
    A_ub, b_ub, _, _ = b.build()
    S = len(gpus)
    res = linprog(c_vec, A_ub=A_ub, b_ub=b_ub, method="highs")
    if not res.success:
        return np.zeros(9), 0.0, np.zeros(n)
    marg = res.ineqlin.marginals
    prices = np.maximum(-marg[2 * S: 2 * S + 9], 0.0)
    lam_r = float(max(-marg[-1], 0.0)) if Gd else 0.0
    return prices, lam_r, np.maximum(res.x[:n], 0.0)


def _site_subproblem(shared: tuple, sub: tuple) -> np.ndarray:
    """Per-site ILP: meet the site's LP capacity quota at minimum cost.

    min Σ cost_j x_j + Σ_c λ_c u_c + λ_R Σ_g d_g
    s.t. GPU cap, power cap, one (f,l) per (c,t),
         Σ_j load_j x_j + u_c >= quota_c,
         Σ_{j∈g} x_j + d_g >= old_g          (live groups only).

    Unserved quota ``u_c`` is priced at the fleet marginal λ_c — the
    site covers its share only where local serving beats buying the
    capacity back at the fleet margin; what it declines flows to the
    global repair step. Drains ``d_g`` of the site's live previous
    capacity are priced at the fleet drain marginal λ_R, so a site only
    walks away from running instances when the re-placement win beats
    the fleet's going drain price; the hard R_L cap itself is restored
    globally by ``FleetState.project_drains``.

    When ``x0`` (the master LP's restriction to this site) is given,
    the solve is warm-started by rounding: the restriction is projected
    onto one (f, l) per group and floored — always feasible (caps only
    shrink, declined quota is priced slack) — and *accepted outright*
    when every class's residual shortfall sits within one-instance
    rounding granularity, because that residue is exactly what the
    integer program could not serve either (it would round up where the
    fleet margin says decline) and the global repair re-covers it at
    the same greedy margin. Sites whose restriction splits across
    operating points — where branch-and-cut genuinely reorganizes —
    fall through to the ILP. Most sites take the fast path, which is
    what makes fleet-scale drain-priced re-plans cheap.

    ``shared``/``sub`` are plain array tuples (not objects) so site
    problems pickle cheaply into worker processes; results depend only
    on their contents, which keeps pooled and sequential solves
    bit-identical. Returns integer counts over all table rows.
    """
    x = _site_round_accept(shared, sub)
    return x if x is not None else _site_ilp(shared, sub)


def _site_round_accept(shared: tuple, sub: tuple) -> Optional[np.ndarray]:
    """The rounding fast path of ``_site_subproblem`` (numpy only)."""
    cls, tp, load_r, power_r, cost_rows, prices, time_limit = shared
    quota, gpus_s, power_s, old_g, lam, x0 = sub
    if x0 is None:
        return None
    m = len(cls)
    key = sct_key(np.zeros(m, dtype=np.intp), cls, tp)
    codes = np.unique(key, return_inverse=True)[1]
    cap_j = np.maximum(gpus_s // np.maximum(tp, 1), 0).astype(float)
    xs = np.minimum(np.asarray(x0, float), cap_j)
    # one (f,l) per (c,t): keep each group's largest-capacity row
    order = np.lexsort((np.arange(m), -xs * load_r, codes))
    first = np.ones(m, bool)
    first[1:] = codes[order][1:] != codes[order][:-1]
    keep = np.zeros(m, bool)
    keep[order[first]] = True
    xk = np.where(keep, np.floor(xs + 1e-9), 0.0)
    covered = np.bincount(cls, weights=xk * load_r, minlength=9)
    shortfall = np.maximum(quota, 0.0) - covered
    gran = np.zeros(9)                      # per-class one-instance load
    np.maximum.at(gran, cls, load_r)
    if (shortfall <= gran + 1e-9).all():
        return xk.astype(int)
    return None


def _site_ilp(shared: tuple, sub: tuple) -> np.ndarray:
    """The branch-and-cut body of ``_site_subproblem``."""
    cls, tp, load_r, power_r, cost_rows, prices, time_limit = shared
    quota, gpus_s, power_s, old_g, lam, x0 = sub
    m = len(cls)
    tpf = tp.astype(float)
    # (cls, tp) groups via the shared validated encoding (site fixed at 0)
    key = sct_key(np.zeros(m, dtype=np.intp), cls, tp)
    uniq, codes = np.unique(key, return_inverse=True)
    G = len(uniq)
    cap_j = np.maximum(gpus_s // np.maximum(tp, 1), 0).astype(float)
    drain = (old_g is not None and lam > 1e-12
             and float(np.sum(old_g)) > 1e-9)
    dgrp = np.nonzero(old_g > 1e-9)[0] if drain else np.empty(0, np.intp)
    Gd = len(dgrp)
    # variable layout: [X (m) | Y (m) | u (9) | d (Gd)]
    nv = 2 * m + 9 + Gd
    iX = np.arange(m)
    iY = m + np.arange(m)
    iU = 2 * m + np.arange(9)
    iD = 2 * m + 9 + np.arange(Gd)

    c_vec = np.zeros(nv)
    c_vec[iX] = cost_rows
    c_vec[iU] = prices
    if Gd:
        c_vec[iD] = lam
    b = ConstraintBuilder(nv)
    b.ub(np.zeros(m, np.intp), iX, tpf, [gpus_s])
    b.ub(np.zeros(m, np.intp), iX, power_r, [power_s])
    b.ub(codes, iY, np.ones(m), np.ones(G))
    b.ub(np.concatenate([np.arange(m), np.arange(m)]),
         np.concatenate([iX, iY]),
         np.concatenate([np.ones(m), -cap_j]), np.zeros(m))
    b.lb(np.concatenate([cls, np.arange(9)]),
         np.concatenate([iX, iU]),
         np.concatenate([load_r, np.ones(9)]), quota)
    if Gd:
        gmap = np.full(G, -1, dtype=np.intp)
        gmap[dgrp] = np.arange(Gd)
        loc = gmap[codes]
        msk = loc >= 0
        b.lb(np.concatenate([loc[msk], np.arange(Gd)]),
             np.concatenate([iX[msk], iD]),
             np.ones(int(msk.sum()) + Gd), old_g[dgrp])
    A_ub, b_ub, A_lb, b_lb = b.build()
    integrality = np.zeros(nv)
    integrality[iX] = 1
    integrality[iY] = 1
    upper = np.concatenate([cap_j, np.ones(m), np.maximum(quota, 0.0),
                            old_g[dgrp] if Gd else np.empty(0)])
    res = solve_milp(c_vec, A_ub=A_ub, b_ub=b_ub, A_lb=A_lb, b_lb=b_lb,
                     integrality=integrality, upper=upper,
                     time_limit=time_limit)
    return np.round(res.x[iX]).astype(int)


def _solve_site_chunk(payload: tuple) -> list:
    shared, subs = payload
    return [_site_ilp(shared, sub) for sub in subs]


def _resolve_workers(workers: Optional[int], n_hard: int) -> int:
    if workers is not None:
        return max(1, int(workers))
    if n_hard < 24:                   # pool spin-up beats small ILP batches
        return 1
    return min(os.cpu_count() or 1, 8)


def _solve_sites(shared: tuple, subs: list, workers: Optional[int]) -> list:
    """Solve the independent site problems, pooling the hard ones.

    The rounding fast path runs inline for every site first (pure
    numpy, sub-millisecond); only the sites whose LP restriction did
    not round — the ones that pay a real branch-and-cut — go to the
    ``ProcessPoolExecutor``, in contiguous chunks reassembled in site
    order. Each solve depends only on its (shared, sub) arrays, so any
    worker count (including the sequential fallback) returns
    bit-identical plans — provided the site ILPs finish inside their
    per-site time limit (a branch-and-cut truncated mid-search is
    wall-clock dependent like any time-limited solve; the ILPs here are
    tiny and the budget is split deterministically over the hard batch,
    so limits bind only under extreme contention). The pool engages
    exactly when there is enough ILP work to amortise its spin-up.
    """
    out: list = [_site_round_accept(shared, sub) for sub in subs]
    hard = [i for i, x in enumerate(out) if x is None]
    # split the solve's time budget over the ILPs that actually run —
    # a deterministic bound (no wall-clock break mid-loop, which would
    # make pooled and sequential runs diverge under time pressure)
    sub_tl = max(0.05, min(2.0, shared[-1] / max(1, len(hard))))
    shared = shared[:-1] + (sub_tl,)
    w = _resolve_workers(workers, len(hard))
    if w <= 1 or len(hard) < 2:
        for i in hard:
            out[i] = _site_ilp(shared, subs[i])
        return out
    from concurrent.futures import ProcessPoolExecutor
    chunk = max(1, -(-len(hard) // (w * 4)))
    payloads = [(shared, [subs[i] for i in hard[k:k + chunk]])
                for k in range(0, len(hard), chunk)]
    with ProcessPoolExecutor(max_workers=w) as ex:
        solved = [x for xs in ex.map(_solve_site_chunk, payloads)
                  for x in xs]
    for i, x in zip(hard, solved):
        out[i] = x
    return out


def _drain_exchange(st: FleetState, load: np.ndarray, deadline: float,
                    max_moves: int = 400) -> None:
    """Re-choose *which* live groups spend the drain budget (in place).

    The projection restores drained capacity cheapest-first, which fixes
    feasibility but not the monolith's other degree of freedom: with the
    budget binding, the optimal plan drains the most *expensive* live
    surplus and keeps the cheap. Each move evicts one live instance
    whose class capacity is surplus (creating one drain) and restores
    one instance of the currently-cheapest drained group (retiring one
    drain) — net drains ≈ 0, cost strictly down; moves that would leave
    the budget violated or a class short are undone.
    """
    p = st.pool
    if st.old_group is None:
        return
    cheapest = st._group_best()
    blocked: set = set()                    # restore groups with no room
    for _ in range(max_moves):
        if time.perf_counter() > deadline:
            return
        gs = np.nonzero(st.drains > 1e-9)[0]
        gs = gs[[int(g) not in blocked for g in gs]]
        if len(gs) == 0:
            return
        js = np.where(st.group_row[gs] >= 0, st.group_row[gs], cheapest[gs])
        ok = js >= 0
        js, gr = js[ok], gs[ok]
        if len(js) == 0:
            return
        i = int(np.argmin(st.cost[js]))
        j_r, g_r = int(js[i]), int(gr[i])
        # evictable: live-old instances whose class stays covered —
        # one O(columns) nonzero for the active set, every other mask
        # over that (small) subset; same candidates in the same order
        act = np.nonzero(st.counts > 0)[0]
        ev = ((st.cap[p.cls[act]] - p.load[act] >= load[p.cls[act]] - 1e-9)
              & (st.cost[act] > st.cost[j_r] + 1e-9))
        cand = act[ev]
        g = st.codes[cand]                  # vectorized removal_drain(j, 1)
        dgain = (np.maximum(st.old_group[g] - (st.group_count[g] - 1), 0.0)
                 - st.drains[g])
        cand = cand[dgain > 1e-9]
        if len(cand) == 0:
            return
        j_e = int(cand[np.argmax(st.cost[cand])])
        st.remove(j_e, 1)
        room = (st.gpu_left[st.gpu_key[j_r]] >= p.tp[j_r]
                and st.pw_left[p.site[j_r]] >= p.power[j_r] - 1e-9)
        if room:
            st.add(j_r, 1)
        if not room or st.fleet_drains > st.r_limit + 1e-9:
            if room:
                st.remove(j_r, 1)
            st.add(j_e, 1)
            # this restore group cannot take the exchange — skip it and
            # keep trying the other drained groups
            blocked.add(g_r)


def _swap_improve(st: FleetState, load: np.ndarray, deadline: float,
                  max_rounds: int = 8, exact: bool = True,
                  rel_tol: float = 0.0) -> None:
    """Cross-site 1-swap polish (in place on ``st``).

    The per-site quota ILPs cannot mix load points inside one (s, c, t)
    group (constraint 4), so a site handed a 5-rps quota may round up to
    2x4-rps where the monolith would mix 4+1 across sites. Each round
    tries, per class, to evict one instance of the most expensive active
    column and re-cover the lost capacity with the fleet's cheapest
    columns; the swap commits only when it strictly lowers cost, and an
    eviction that would spend drain budget the fleet no longer has is
    skipped outright.

    ``exact=True`` rolls a rejected swap back through the historical
    ``counts.copy()`` + ``rebuild()`` pair (canonical bincount state —
    the byte-for-byte ``plan_l`` behavior the anchors pin).
    ``exact=False`` rolls back through the O(ops) op log instead: same
    decisions, ULP-level float-headroom drift possible, an order of
    magnitude cheaper at 10k sites — the session re-plan path uses it.

    ``rel_tol > 0`` stops polishing once a whole round's cost saving
    falls below ``rel_tol`` of the current plan cost — at 10k sites the
    late rounds each cost a fleet-wide ``cover`` scan per class to
    recover a vanishing fraction of the objective. The canonical
    ``plan_l`` path keeps ``rel_tol=0`` (run until no strict improvement).
    """
    pool, counts, cost = st.pool, st.counts, st.cost
    for _ in range(max_rounds):
        improved = False
        round_gain = 0.0
        for c in range(9):
            idx_c = pool.cls_index(c)
            act = idx_c[counts[idx_c] > 0]
            if len(act) == 0:
                continue
            j = int(act[np.argmax(cost[act])])
            if st.removal_drain(j, 1) > st.drain_headroom() + 1e-9:
                continue
            saved = cost[j]
            before = counts.copy() if exact else None
            if not exact:
                st.log_begin()
            st.remove(j, 1)
            deficit = load[c] - st.cap[c]
            added = (st.cover(c, deficit, budget=saved - 1e-9)
                     if deficit > 1e-9 else 0.0)
            if added is not None and added < saved - 1e-9:
                improved = True
                round_gain += saved - added
                if not exact:
                    st.log_commit()
            elif exact:
                counts[:] = before
                st.rebuild()
            else:
                st.log_rollback()
            if time.perf_counter() > deadline:
                return
        if not improved:
            return
        if rel_tol > 0.0 and round_gain < rel_tol * float(counts @ cost):
            return


def _site_group_starts(pool: ColumnPool) -> np.ndarray:
    """[S+1] start offsets of each site's (s,c,t) group range.

    ``pool.sct()`` orders groups by site-major key, so ``g_site`` is
    nondecreasing and ``old_agg[starts[s]:starts[s+1]]`` is the exact
    slice the historical ``old_agg[g_site == s]`` boolean scan produced
    — without the O(S·G) fleet-wide mask per site.
    """
    g_site = pool.sct()[1]
    return np.searchsorted(g_site, np.arange(pool.num_sites + 1))


def _round_accept_all(soa, quotas: np.ndarray, gpus: np.ndarray,
                      x_lp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``_site_round_accept`` for every site at once (pure numpy).

    Same arithmetic in the same order as the per-site helper — floor /
    min / per-(site, group) keep-largest with first-row tie-break
    (segment max + min-position over a static (group, row) permutation
    of the table), and per-site class coverage summed row-ascending via
    one flat bincount — so a site accepts here iff its
    ``_site_round_accept`` accepts, with bit-identical counts
    (pinned by tests/test_planning.py). ``quotas``/``gpus``/``x_lp``
    are the *solved subset's* rows (the caller pre-gathers them), so an
    incremental re-plan pays O(dirty·R), not O(fleet). Returns
    (xk [S, R], accepted [S]); rows of non-accepted sites are
    meaningless.
    """
    S = quotas.shape[0]
    R = len(soa.cls)
    key = sct_key(np.zeros(R, dtype=np.intp), soa.cls, soa.tp)
    codes = np.unique(key, return_inverse=True)[1]
    perm = np.lexsort((np.arange(R), codes))        # group-major, row asc
    starts = np.nonzero(np.r_[True, codes[perm][1:] != codes[perm][:-1]])[0]
    cap_j = np.maximum(gpus[:, None] // np.maximum(soa.tp, 1)[None, :],
                       0).astype(float)
    xs = np.minimum(x_lp.reshape(S, R), cap_j)
    w = xs * soa.load[None, :]
    wp = w[:, perm]
    gmax = np.maximum.reduceat(wp, starts, axis=1)
    reps = np.diff(np.r_[starts, R])
    pos = np.where(wp == np.repeat(gmax, reps, axis=1),
                   np.arange(R)[None, :], R)
    first = np.minimum.reduceat(pos, starts, axis=1)
    keep = np.zeros((S, R), dtype=bool)
    keep[np.arange(S)[:, None], perm[first]] = True
    xk = np.where(keep, np.floor(xs + 1e-9), 0.0)
    flat = np.repeat(np.arange(S), R) * 9 + np.tile(soa.cls, S)
    covered = np.bincount(flat, weights=(xk * soa.load[None, :]).ravel(),
                          minlength=S * 9).reshape(S, 9)
    gran = np.zeros(9)                      # per-class one-instance load
    np.maximum.at(gran, soa.cls, soa.load)
    shortfall = np.maximum(quotas, 0.0) - covered
    accepted = (shortfall <= gran[None, :] + 1e-9).all(axis=1)
    return xk, accepted


def _assign_sites(pool: ColumnPool, soa, quotas: np.ndarray,
                  gpus: np.ndarray, power: np.ndarray,
                  old_agg: Optional[np.ndarray], starts: np.ndarray,
                  lam_r: float, x_lp: Optional[np.ndarray],
                  row_cost: np.ndarray, prices: np.ndarray,
                  time_limit: float, workers: Optional[int],
                  site_warm: bool,
                  site_mask: Optional[np.ndarray] = None
                  ) -> tuple[np.ndarray, int, int]:
    """Solve the per-site quota problems; returns (counts2d, #accept, #ilp).

    Sites outside ``site_mask`` (and sites the LP left idle) come back
    as zero rows — the caller decides what to reuse for them. The
    vectorized rounding pass accepts most sites without touching
    Python; the remainder go through ``_solve_sites`` exactly as
    before (the hard count, and so the deterministic per-ILP time
    split, is unchanged — a site fails the vectorized accept iff it
    fails the per-site accept).
    """
    S = quotas.shape[0]
    R = len(soa.cls)
    active = quotas.max(axis=1) > 1e-9
    if site_mask is not None:
        active &= site_mask
    counts2d = np.zeros((S, R), dtype=int)
    acc = np.zeros(S, dtype=bool)
    if site_warm and x_lp is not None and active.any():
        # gather the active rows first: each site's accept arithmetic is
        # row-local, so the subset pass is bit-identical to the full one
        # and an incremental re-plan pays O(dirty·R) here, not O(S·R)
        act = np.nonzero(active)[0]
        xk, ok = _round_accept_all(soa, quotas[act], gpus[act],
                                   x_lp.reshape(S, R)[act].ravel())
        hit = act[ok]
        acc[hit] = True
        counts2d[hit] = xk[ok].astype(int)
    hard_sites = np.nonzero(active & ~acc)[0].tolist()
    shared = (soa.cls, soa.tp, soa.load, soa.power, row_cost, prices,
              time_limit)
    subs = []
    for s in hard_sites:
        old_s = (old_agg[starts[s]:starts[s + 1]]
                 if old_agg is not None else None)
        x0 = x_lp[s * R:(s + 1) * R] if (site_warm and x_lp is not None) \
            else None
        subs.append((quotas[s], gpus[s], power[s], old_s, lam_r, x0))
    for s, x in zip(hard_sites, _solve_sites(shared, subs, workers)):
        counts2d[s] = x
    return counts2d, int(acc.sum()), len(hard_sites)


def _global_repair(fcounts: np.ndarray, pool: ColumnPool, cost: np.ndarray,
                   gpus: np.ndarray, power: np.ndarray, load: np.ndarray,
                   old_agg: Optional[np.ndarray], r_limit: float,
                   deadline: float, exact: bool = True,
                   restore_best: Optional[np.ndarray] = None,
                   swap_rel_tol: float = 0.0
                   ) -> tuple[FleetState, bool]:
    """Fleet-level feasibility + polish over assembled site counts."""
    st = FleetState(fcounts, pool, cost, gpus, pool.site, power,
                    old_group=old_agg, r_limit=r_limit,
                    restore_best=restore_best)
    st.trim(load)               # drain-aware surplus trim
    drains_ok = st.project_drains()
    #                             hard R_L feasibility across sites —
    #                             before the cover, so restorations claim
    #                             their headroom first and the repair
    #                             places serving capacity around them
    st.cover_all(load)          # greedy cheapest-completion repair
    _drain_exchange(st, load, deadline=deadline)
    _swap_improve(st, load, deadline=deadline, exact=exact,
                  rel_tol=swap_rel_tol)
    return st, drains_ok


def _quotas_from_lp(pool: ColumnPool, x_lp: np.ndarray,
                    S: int) -> np.ndarray:
    """Per-site per-class capacity quotas from the fractional optimum.

    Flat bincount with site-major bins — accumulates in column order,
    bit-identical to the historical ``np.add.at`` scatter.
    """
    return np.bincount(pool.site * 9 + pool.cls,
                       weights=x_lp * pool.load,
                       minlength=S * 9).reshape(S, 9)


def _solve_decomposed(pool: ColumnPool, sites: list[SiteSpec],
                      power_w: np.ndarray, load_per_class: np.ndarray,
                      objective: Objective, time_limit: float,
                      old: Optional[Plan] = None, r_frac: float = 0.03,
                      workers: Optional[int] = None,
                      site_warm: bool = True,
                      site_rate: Optional[np.ndarray] = None) -> Plan:
    t0 = time.perf_counter()
    S = len(sites)
    table = pool.table
    soa = table_soa(table)
    gpus = np.array([s.num_gpus for s in sites], float)
    power = np.asarray(power_w, float)
    load = np.maximum(np.asarray(load_per_class, float), 0.0)
    cost = pool.cost(objective, site_rate)
    # the site subproblem's shared row costs are per table row (shared
    # across sites) — site-rate scaling binds through the master duals
    # and the repair's column costs, not here
    row_cost = soa.e2e if objective == "latency" else soa.power

    if old is not None:
        old_agg = _live_old_agg(old, power, pool)
        r_limit = _drain_budget(old_agg, r_frac)
    else:
        old_agg, r_limit = None, np.inf
    prices, lam_r, x_lp = _lp_master(pool, gpus, power, load, cost,
                                     old_agg, r_limit)
    quotas = _quotas_from_lp(pool, x_lp, S)
    counts2d, _, _ = _assign_sites(
        pool, soa, quotas, gpus, power, old_agg, _site_group_starts(pool),
        lam_r, x_lp if site_warm else None, row_cost, prices, time_limit,
        workers, site_warm)
    # Sites rationally *decline* quota priced exactly at the LP margin
    # (integer serving rounds up, declining does not), so the marginal
    # capacity of each class intentionally lands in the global repair
    # below — a ratio-greedy cover that is near-LP-optimal at the margin.
    # Do not re-price and re-solve on shortfall: forcing a declined
    # quota back onto its site makes a GPU-starved site serve at a worse
    # TP instead of exporting the load (observed as a 5% objective gap).

    fcounts = counts2d.reshape(-1).astype(float)
    st, drains_ok = _global_repair(fcounts, pool, cost, gpus, power, load,
                                   old_agg, r_limit,
                                   deadline=t0 + time_limit)
    counts = np.round(fcounts).astype(int)
    cap = np.bincount(pool.cls, weights=counts * pool.load, minlength=9)
    unserved = np.maximum(load - cap, 0.0)
    unserved[unserved <= 1e-9] = 0.0
    # projection is best-effort in fractional power-scaling corners
    # (restoring integer instances cannot always reach a fractional
    # old-live total) — never fail silently when the budget is missed
    status = "decomposed"
    if not drains_ok:
        status = "decomposed_overbudget"
        warnings.warn(
            f"plan_l: drain projection left fleet drains "
            f"{st.fleet_drains:.1f} above R_L={st.r_limit:.1f} "
            "(no feasible restoration); plan returned with status "
            "'decomposed_overbudget'", RuntimeWarning, stacklevel=3)
    return Plan(columns=pool.columns(), counts=counts, unserved=unserved,
                objective=objective, status=status,
                solve_seconds=time.perf_counter() - t0, num_sites=S,
                _cols=pool.column_arrays(), _pool=pool)


# ------------------------------------------------------------------
# session path: warm restricted master + incremental dirty-site re-plans
# ------------------------------------------------------------------
class _MasterCache:
    """Static pieces of the aggregate master, shared across a session.

    Everything here depends only on (pool, objective): the float TP
    column, the (s,c,t) group index and per-site group ranges, and each
    group's min-cost column (restore fallback when a live group has no
    support column). The per-slot restricted assembly gathers from
    these instead of rebuilding fleet-wide arrays every solve.
    """

    def __init__(self, pool: ColumnPool, cost: np.ndarray):
        self.pool = pool
        self.cost = cost
        self.tp_f = pool.tp.astype(float)
        self.codes, self.g_site, _, _ = pool.sct()
        self.G = len(self.g_site)
        self.starts = _site_group_starts(pool)
        order = np.argsort(cost, kind="stable")[::-1]
        cheap = np.full(self.G, -1, dtype=np.intp)
        cheap[self.codes[order]] = order        # last write = min cost,
        self.group_cheap = cheap                # first index on ties
        # per-group min cost-per-rps column — FleetState._group_best's
        # default score, hoisted so per-slot repairs skip the argsort
        score = cost / np.maximum(pool.load, 1e-12)
        sorder = np.argsort(score, kind="stable")[::-1]
        rb = np.full(self.G, -1, dtype=np.intp)
        rb[self.codes[sorder]] = sorder
        self.restore_best = rb
        # per-class cost-ascending column order (capacity seed below)
        self.cls_order = [np.nonzero(pool.cls == c)[0][
            np.argsort(cost[pool.cls == c], kind="stable")]
            for c in range(9)]

    def capacity_seed(self, gpus: np.ndarray, power_w: np.ndarray,
                      load: np.ndarray, margin: float = 2.0,
                      sites_sel: Optional[np.ndarray] = None) -> np.ndarray:
        """Cheapest columns whose relaxed capacity covers ``margin``× load.

        The previous slot's LP support is tiny (active sites only), so
        after a fleet-wide power drop a support-only restricted LP
        drops load and its duals jump to DROP_PENALTY — pricing then
        floods with ~every column in the pool. Seeding each class with
        its cost-cheapest columns until their fractional instance
        bound (min of GPU and power headroom) covers a multiple of the
        class demand keeps the first restricted solve feasible, so the
        duals start near the fleet optimum and pricing converges in a
        round or two. Pure function of (pool, cost, slot inputs) —
        identical for incremental and full re-plans by construction.
        ``sites_sel`` restricts the candidate columns to those sites
        (the incremental sub-master); selecting every site is
        bit-identical to no selection.
        """
        pool = self.pool
        smask = None
        if sites_sel is not None:
            smask = np.zeros(pool.num_sites, dtype=bool)
            smask[sites_sel] = True
        pw = np.asarray(power_w, float)
        picks = []
        for c in range(9):
            if load[c] <= 1e-9:
                continue
            oc = self.cls_order[c]
            if smask is not None:
                oc = oc[smask[pool.site[oc]]]
            # one column per site: a site's class-c columns share its
            # GPU/power headroom, so summing all their bounds would
            # overcount the site ~|operating points|-fold and balloon
            # the seed; the cheapest column per site is the LP's likely
            # pick and pricing rounds add any missed mixes
            first = np.unique(pool.site[oc], return_index=True)[1]
            oc = oc[np.sort(first)]
            soc = pool.site[oc]
            ub = np.minimum(gpus[soc] // np.maximum(self.tp_f[oc], 1.0),
                            pw[soc] / np.maximum(pool.power[oc], 1e-12))
            cum = np.cumsum(np.maximum(ub, 0.0) * pool.load[oc])
            k = int(np.searchsorted(cum, margin * load[c])) + 1
            picks.append(oc[:k])
        if not picks:
            return np.empty(0, dtype=np.intp)
        return np.concatenate(picks)


def _lp_master_restricted(cache: _MasterCache, gpus: np.ndarray,
                          power_w: np.ndarray, load: np.ndarray,
                          support: np.ndarray,
                          old_agg: Optional[np.ndarray], r_limit: float,
                          max_rounds: int = 2, batch: int = 8192,
                          sites_sel: Optional[np.ndarray] = None
                          ) -> Optional[tuple]:
    """Restricted master + column generation off the previous support.

    scipy's HiGHS binding exposes no basis warm-start, but the aggregate
    LP's optimal support is tiny (hundreds of columns at 10k sites): a
    restricted LP over the previous slot's support + fresh drain block
    solves in milliseconds, and one reduced-cost pricing pass over the
    full pool (r_j = c_j + π_gpu·tp + π_pw·power − λ_c·load − α_g)
    either certifies it optimal for the whole fleet or adds the worst
    violated columns and re-solves. Returns (prices, λ_R, x_lp, support,
    rounds, converged); ``converged=False`` means ``max_rounds`` ran
    out and the last restricted optimum is returned as-is (load is
    still fully covered thanks to the capacity seed — only the prices
    are approximate). None only when a restricted LP itself fails —
    the caller then falls back to the cold full-pool master.

    ``sites_sel`` prices a *sub-fleet*: candidate columns, drain links
    and the pricing pass restrict to the selected sites, and the caller
    hands in residual ``load`` / ``r_limit`` with the unselected sites'
    fixed assignments folded into them — the incremental dirty-site
    master, O(dirty columns) per round. Selecting every site with the
    un-reduced inputs is bit-identical to ``sites_sel=None``.
    """
    from scipy.optimize import linprog

    pool, cost = cache.pool, cache.cost
    n = len(pool)
    S = len(gpus)
    codes, G = cache.codes, cache.G
    dgrp = (np.nonzero(old_agg > 1e-9)[0] if old_agg is not None
            else np.empty(0, dtype=np.intp))
    pw0 = np.asarray(power_w, float)
    smask = sel = None
    if sites_sel is not None:
        sel = np.asarray(sites_sel, dtype=np.intp)   # sorted site ids
        smask = np.zeros(S, dtype=bool)
        smask[sel] = True
        support = np.asarray(support, dtype=np.intp)
        support = support[smask[pool.site[support]]]
        if len(dgrp):
            dgrp = dgrp[smask[cache.g_site[dgrp]]]
    idx = np.concatenate([np.asarray(support, dtype=np.intp),
                          cache.capacity_seed(gpus, pw0, load,
                                              sites_sel=sites_sel)])
    if len(dgrp):
        # every live group needs a column, or its drain link row would
        # force d_g = old_g with no way to keep the capacity instead
        covered = np.zeros(G, dtype=bool)
        covered[codes[idx]] = True
        missing = dgrp[~covered[dgrp]]
        if len(missing):
            idx = np.concatenate([idx, cache.group_cheap[missing]])
    idx = np.unique(idx)
    pw = pw0
    load9 = np.asarray(load, float)
    if smask is None:
        u = np.arange(n, dtype=np.intp)
        Sr, gpus_r, pw_r = S, gpus, pw
    else:
        u = np.nonzero(smask[pool.site])[0]     # priced universe
        # compact GPU/power rows to the selected sites — a 10%-dirty
        # sub-master otherwise still carries 2S trivial fleet rows,
        # and the LP pays presolve for every one of them
        Sr, gpus_r, pw_r = len(sel), gpus[sel], pw[sel]
    cost_u, tp_u, pow_u = cost[u], cache.tp_f[u], pool.power[u]
    site_u, cls_u, load_u, codes_u = (pool.site[u], pool.cls[u],
                                      pool.load[u], codes[u])
    row_u = site_u if sel is None else np.searchsorted(sel, site_u)
    res = None
    for rounds in range(1, max_rounds + 1):
        k = len(idx)
        Gd = len(dgrp)
        nv = k + 9 + Gd
        c_vec = np.concatenate([cost[idx], np.full(9, DROP_PENALTY),
                                np.zeros(Gd)])
        site_k = (pool.site[idx] if sel is None
                  else np.searchsorted(sel, pool.site[idx]))
        b = ConstraintBuilder(nv)
        b.ub(site_k, np.arange(k), cache.tp_f[idx], gpus_r)
        b.ub(site_k, np.arange(k), pool.power[idx], pw_r)
        b.ub(np.concatenate([pool.cls[idx], np.arange(9)]),
             np.concatenate([np.arange(k), k + np.arange(9)]),
             np.concatenate([-pool.load[idx], -np.ones(9)]), -load9)
        if Gd:
            gmap = np.full(G, -1, dtype=np.intp)
            gmap[dgrp] = np.arange(Gd)
            loc = gmap[codes[idx]]
            msk = loc >= 0
            b.ub(np.concatenate([loc[msk], np.arange(Gd)]),
                 np.concatenate([np.arange(k)[msk], k + 9 + np.arange(Gd)]),
                 np.concatenate([-np.ones(int(msk.sum())), -np.ones(Gd)]),
                 -old_agg[dgrp])
            b.ub(np.zeros(Gd, dtype=np.intp), k + 9 + np.arange(Gd),
                 np.ones(Gd), [float(r_limit)])
        A_ub, b_ub, _, _ = b.build()
        res = linprog(c_vec, A_ub=A_ub, b_ub=b_ub, method="highs")
        if not res.success:
            return None
        marg = res.ineqlin.marginals
        pi_g = np.maximum(-marg[:Sr], 0.0)
        pi_p = np.maximum(-marg[Sr:2 * Sr], 0.0)
        lam_c = np.maximum(-marg[2 * Sr:2 * Sr + 9], 0.0)
        alpha = np.zeros(G)
        lam_r = 0.0
        if Gd:
            alpha[dgrp] = np.maximum(
                -marg[2 * Sr + 9:2 * Sr + 9 + Gd], 0.0)
            lam_r = float(max(-marg[-1], 0.0))
        red = (cost_u + pi_g[row_u] * tp_u + pi_p[row_u] * pow_u
               - lam_c[cls_u] * load_u - alpha[codes_u])
        red[np.searchsorted(u, idx)] = 0.0
        vpos = np.nonzero(red < -1e-7)[0]
        viol = u[vpos]
        if len(viol) == 0 or rounds == max_rounds:
            # converged (pricing certifies fleet-wide optimality), or
            # rounds exhausted: the whole optimum moved (fleet-wide
            # weather front) and chasing it column-by-column costs more
            # than it buys — the truncated restricted optimum already
            # covers all load (capacity seed) and feeds a repair
            # pipeline that keeps R_L hard, so return it flagged
            # rather than burning 10x the budget on the cold master
            x_lp = np.zeros(n)
            x_lp[idx] = np.maximum(res.x[:k], 0.0)
            return lam_c, lam_r, x_lp, idx, rounds, len(viol) == 0
        if len(viol) > batch:
            viol = viol[np.argpartition(red[vpos], batch)[:batch]]
        idx = np.unique(np.concatenate([idx, viol]))
    return None


class PlannerLSession:
    """Stateful Planner-L driver for event-driven fleet-scale re-plans.

    One session owns one fleet (table, sites, objective): the dense
    column pool, the master cache, and the previous slot's solution are
    built once and reused every ``plan()`` call. Three things make the
    chained re-plans cheap where ``plan_l`` starts over each slot:

      * **warm restricted master** — the aggregate LP re-solves over
        the previous slot's support with reduced-cost pricing over the
        full pool (``_lp_master_restricted``); milliseconds instead of
        seconds at 10k sites, exact (certified by pricing) or it falls
        back to the cold master.
      * **incremental dirty-site re-plans** (``mode="auto"``) — a site
        re-solves its quota ILP only when its knowledge-plane power
        moved beyond ``dirty_tol`` (relative) or its previous
        assignment no longer fits the new power cap; clean sites reuse
        the previous slot's accepted counts verbatim. The master still
        re-prices the whole fleet, and the global repair (trim /
        project_drains / cover / polish) runs fleet-wide, so the R_L
        drain budget stays a hard constraint — clean-site reuse can
        never violate it. Falls back to a full re-plan when fleet load
        shifts more than ``dirty_tol`` (quotas move everywhere) or the
        dirty fraction exceeds ``max_dirty_frac`` (incremental would
        not pay); ``plan.meta["fallback"]`` names the reason.
      * **λ_R refinement** — after assembly, if fleet drains still
        exceed R_L, up to ``subgradient_rounds`` multiplicative updates
        raise λ_R and re-solve only the sites draining beyond their
        sub-budget (seeded from the master's fractional drains), so one
        global price no longer under-drains at fleet scale; the hard
        budget is then enforced by the projection as always.

    ``mode="full"`` re-solves every site but keeps the warm master and
    λ_R refinement; ``mode="cold"`` replays the exact ``plan_l``
    pipeline (bit-identical to ``plan_l(old=prev)``, pinned in tests).
    Every plan carries ``meta`` diagnostics (mode, dirty-set size,
    master rounds, per-stage seconds). Single-threaded determinism:
    results are bit-identical across ``workers`` settings, like
    ``plan_l``.
    """

    def __init__(self, table: LookupTable, sites: list[SiteSpec], *,
                 objective: Objective = "latency", r_frac: float = 0.03,
                 time_limit: float = 60.0, workers: Optional[int] = None,
                 site_warm: bool = True, dirty_tol: float = 0.02,
                 max_dirty_frac: float = 0.5, subgradient_rounds: int = 2,
                 swap_rel_tol: float = 1e-3, dual_coupling: bool = True):
        self.table = table
        self.sites = sites
        self.objective: Objective = objective
        self.r_frac = float(r_frac)
        self.time_limit = float(time_limit)
        self.workers = workers
        self.site_warm = bool(site_warm)
        self.dirty_tol = float(dirty_tol)
        self.max_dirty_frac = float(max_dirty_frac)
        self.subgradient_rounds = int(subgradient_rounds)
        self.swap_rel_tol = float(swap_rel_tol)
        self.dual_coupling = bool(dual_coupling)
        self.pool = ColumnPool.dense(table, len(sites))
        self.soa = table_soa(table)
        self.gpus = np.array([s.num_gpus for s in sites], float)
        self.cost = self.pool.cost(objective)
        self.row_cost = (self.soa.e2e if objective == "latency"
                         else self.soa.power)
        self.cache = _MasterCache(self.pool, self.cost)
        self._prev: Optional[dict] = None
        self._subs: dict = {}           # dirty-count -> sub-fleet pool

    def _subfleet(self, D: int) -> tuple:
        """(pool, cost, restore_best) for a ``D``-site sub-fleet (cached).

        The session pool is dense site-major — every site carries the
        same table-row block — so the dirty sub-fleet's columns are
        structurally ``ColumnPool.dense(table, D)`` with sites
        renumbered to their dirty rank. Selecting all ``S`` sites
        reproduces the session pool's arrays exactly, which is what
        keeps all-sites-dirty incremental == full bit-for-bit through
        the repair stage.
        """
        hit = self._subs.get(D)
        if hit is None:
            sp = ColumnPool.dense(self.table, D)
            sc = sp.cost(self.objective)
            codes = sp.sct()[0]
            score = sc / np.maximum(sp.load, 1e-12)
            order = np.argsort(score, kind="stable")[::-1]
            rb = np.full(int(codes.max()) + 1 if len(codes) else 0, -1,
                         dtype=np.intp)
            rb[codes[order]] = order
            hit = (sp, sc, rb)
            self._subs[D] = hit
        return hit

    # ---- dirty-set detection ----
    def _dirty_mask(self, power: np.ndarray, load: np.ndarray,
                    meta: dict) -> Optional[np.ndarray]:
        prev = self._prev
        lref = np.maximum(np.maximum(load, prev["load"]), 1e-9)
        if float(np.max(np.abs(load - prev["load"]) / lref)) > self.dirty_tol:
            meta["fallback"] = "load_moved"
            return None
        dp = np.abs(power - prev["power"])
        ref = np.maximum(np.maximum(prev["power"], power), 1.0)
        dirty = dp > self.dirty_tol * ref
        # reuse must stay power-feasible: a site whose new cap is below
        # its previous assignment's draw has to re-solve
        used = np.bincount(self.pool.site,
                           weights=prev["counts2d"].reshape(-1)
                           * self.pool.power, minlength=len(power))
        dirty |= power < used - 1e-6
        frac = float(dirty.mean()) if len(dirty) else 0.0
        meta["dirty_frac"] = frac
        if frac > self.max_dirty_frac:
            meta["fallback"] = "dirty_frac"
            return None
        return dirty

    # ---- λ_R subgradient refinement ----
    def _refine_lam_r(self, counts2d: np.ndarray, quotas: np.ndarray,
                      power: np.ndarray, old_agg: np.ndarray,
                      r_limit: float, lam_r: float, x_lp: np.ndarray,
                      prices: np.ndarray) -> tuple[np.ndarray, int, float]:
        codes, g_site, G = self.cache.codes, self.cache.g_site, self.cache.G
        S = counts2d.shape[0]
        starts = self.cache.starts
        # per-site drain sub-budgets from the master's fractional drains
        d_frac = np.maximum(
            old_agg - np.bincount(codes, weights=x_lp, minlength=G), 0.0)
        site_budget = np.bincount(g_site, weights=d_frac, minlength=S)
        rounds = 0
        for _ in range(self.subgradient_rounds):
            gcount = np.bincount(
                codes, weights=counts2d.reshape(-1).astype(float),
                minlength=G)
            drains = np.maximum(old_agg - gcount, 0.0)
            overshoot = float(drains.sum()) - r_limit
            if overshoot <= 1e-9:
                break
            # multiplicative price step ∝ relative violation
            lam_r = max(lam_r, 1e-6) * (
                1.0 + min(2.0, overshoot / max(r_limit, 1.0)))
            site_drains = np.bincount(g_site, weights=drains, minlength=S)
            # one instance of slack per site — integer rounding noise
            over = np.nonzero(site_drains > site_budget + 1.0 + 1e-9)[0]
            if len(over) == 0:
                break
            rounds += 1
            shared = (self.soa.cls, self.soa.tp, self.soa.load,
                      self.soa.power, self.row_cost, prices,
                      self.time_limit)
            # x0=None forces branch-and-cut: the rounding fast path
            # ignores drain pricing, so a re-priced λ_R only binds
            # through the ILP's d_g objective terms
            subs = [(quotas[s], self.gpus[s], power[s],
                     old_agg[starts[s]:starts[s + 1]], lam_r, None)
                    for s in over.tolist()]
            for s, x in zip(over.tolist(),
                            _solve_sites(shared, subs, self.workers)):
                counts2d[s] = x
        return counts2d, rounds, lam_r

    # ---- main entry ----
    def plan(self, power_w: np.ndarray, load_per_class: np.ndarray, *,
             mode: str = "auto") -> Plan:
        """Solve one slot; ``mode`` ∈ {"auto", "full", "cold"}."""
        t0 = time.perf_counter()
        pool = self.pool
        S = len(self.sites)
        R = len(self.table.rows)
        power = np.asarray(power_w, float)
        load = np.maximum(np.asarray(load_per_class, float), 0.0)
        prev = self._prev
        meta: dict = {"num_sites": S}
        old_plan = prev["plan"] if prev is not None else None
        if old_plan is not None:
            old_agg = _live_old_agg(old_plan, power, pool)
            r_limit = _drain_budget(old_agg, self.r_frac)
        else:
            old_agg, r_limit = None, np.inf

        dirty = None
        if prev is None or mode == "cold":
            mode_eff = "cold"
        elif mode == "full":
            mode_eff = "full"
        else:
            dirty = self._dirty_mask(power, load, meta)
            mode_eff = "incremental" if dirty is not None else "full"
        meta["mode"] = mode_eff
        meta["dirty_sites"] = (int(dirty.sum()) if dirty is not None
                               else (0 if mode_eff == "cold" else S))

        # ---- master ----
        tm = time.perf_counter()
        warm = None
        sel = None
        cmask = flat_prev = None
        load_m, r_m, clean_drains = load, r_limit, 0.0
        if mode_eff == "incremental":
            # fold the clean sites' reused assignments into the RHS and
            # price only the dirty sub-fleet: residual class demand,
            # residual drain budget, dirty columns.  With every site
            # dirty the residuals and the selection reduce bit-for-bit
            # to the full-mode inputs (the all-dirty == full pin).
            sel = np.nonzero(dirty)[0]
            cmask = ~dirty[pool.site]
            flat_prev = prev["counts2d"].reshape(-1).astype(float)
            clean_cap = np.bincount(
                pool.cls[cmask],
                weights=flat_prev[cmask] * pool.load[cmask], minlength=9)
            load_m = np.maximum(load - clean_cap, 0.0)
            gclean = np.bincount(self.cache.codes[cmask],
                                 weights=flat_prev[cmask],
                                 minlength=self.cache.G)
            cgmask = ~dirty[self.cache.g_site]
            clean_drains = float(np.maximum(
                old_agg - gclean, 0.0)[cgmask].sum())
            r_m = r_limit - clean_drains
            meta["clean_drains"] = clean_drains
        if (mode_eff != "cold" and prev is not None
                and (sel is None or len(sel))):
            warm = _lp_master_restricted(self.cache, self.gpus, power,
                                         load_m, prev["support"], old_agg,
                                         r_m, sites_sel=sel)
        if warm is not None:
            prices, lam_r, x_lp, support, rounds, converged = warm
            meta["master"] = "restricted"
            meta["master_rounds"] = rounds
            meta["master_converged"] = converged
        elif sel is not None and len(sel) == 0:
            # nothing moved beyond tolerance: keep every assignment
            prices, lam_r = np.zeros(9), 0.0
            x_lp = np.zeros(len(pool))
            support = np.asarray(prev["support"], dtype=np.intp)
            meta["master"] = "skipped"
        else:
            if mode_eff != "cold" and prev is not None:
                meta["master_fallback"] = True
            prices, lam_r, x_lp = _lp_master(pool, self.gpus, power, load,
                                             self.cost, old_agg, r_limit)
            support = np.nonzero(x_lp > 1e-9)[0]
            meta["master"] = "full"
        if cmask is not None:
            # composite fractional solution: clean sites at their reused
            # counts, dirty sites at the sub-master optimum (empty
            # clean set leaves x_lp untouched — the all-dirty case)
            x_lp[cmask] = flat_prev[cmask]
            # ---- cross-site dual coupling --
            # a site can be "clean" by its own power/load deltas while
            # the master's capacity/drain duals touching it moved — a
            # clean site next to a hugely dirty neighbor used to keep
            # stale quotas until the next full re-plan. Price each
            # site's reused assignment under the previous and current
            # duals; sites whose dual pressure moved beyond dirty_tol
            # join the dirty set: their reused counts stay the
            # fractional seed (so their quota is unchanged) but they now
            # re-solve at the NEW prices and participate in the
            # sub-fleet repair, which can move capacity onto/off them.
            # No master re-run — the restricted master's duals are the
            # signal, the repair closes the gap.
            if (self.dual_coupling and warm is not None
                    and prev.get("duals") is not None and len(sel)
                    and old_agg is not None):
                p_old, lam_old = prev["duals"]
                cap_sc = np.bincount(
                    pool.site * 9 + pool.cls,
                    weights=flat_prev * pool.load,
                    minlength=S * 9).reshape(S, 9)
                live_site = np.bincount(self.cache.g_site,
                                        weights=old_agg, minlength=S)
                press_new = cap_sc @ prices + lam_r * live_site
                press_old = cap_sc @ p_old + lam_old * live_site
                ref = np.maximum(np.maximum(np.abs(press_new),
                                            np.abs(press_old)), 1e-9)
                newly = ((np.abs(press_new - press_old) / ref
                          > self.dirty_tol) & ~dirty)
                meta["dual_dirty"] = int(newly.sum())
                if newly.any():
                    dirty = dirty | newly
                    sel = np.nonzero(dirty)[0]
                    cmask = ~dirty[pool.site]
                    clean_cap = np.bincount(
                        pool.cls[cmask],
                        weights=flat_prev[cmask] * pool.load[cmask],
                        minlength=9)
                    load_m = np.maximum(load - clean_cap, 0.0)
                    gclean = np.bincount(self.cache.codes[cmask],
                                         weights=flat_prev[cmask],
                                         minlength=self.cache.G)
                    cgmask = ~dirty[self.cache.g_site]
                    clean_drains = float(np.maximum(
                        old_agg - gclean, 0.0)[cgmask].sum())
                    r_m = r_limit - clean_drains
                    meta["clean_drains"] = clean_drains
                    meta["dirty_sites"] = int(dirty.sum())
        meta["t_master"] = time.perf_counter() - tm

        # ---- per-site assignment ----
        ts = time.perf_counter()
        quotas = _quotas_from_lp(pool, x_lp, S)
        counts2d, n_acc, n_hard = _assign_sites(
            pool, self.soa, quotas, self.gpus, power, old_agg,
            self.cache.starts, lam_r, x_lp if self.site_warm else None,
            self.row_cost, prices, self.time_limit, self.workers,
            self.site_warm, site_mask=dirty)
        meta["accepted_sites"] = n_acc
        meta["hard_ilps"] = n_hard
        if dirty is not None:
            keep = ~dirty               # clean sites: previous assignment
            counts2d[keep] = prev["counts2d"][keep]
        meta["t_sites"] = time.perf_counter() - ts

        # ---- λ_R refinement (skipped in cold mode: plan_l parity) ----
        lam_rounds = 0
        if (mode_eff != "cold" and old_agg is not None
                and self.subgradient_rounds > 0):
            counts2d, lam_rounds, lam_r = self._refine_lam_r(
                counts2d, quotas, power, old_agg, r_limit, lam_r, x_lp,
                prices)
        meta["lam_r_rounds"] = lam_rounds

        # ---- global repair ----
        tr = time.perf_counter()
        if sel is not None:
            # trim / project / cover / polish over the dirty sub-fleet
            # only, against the residual load and drain budget — the
            # clean sites' counts (already repaired last slot) stay
            # byte-identical and their drains are accounted in r_m
            D = len(sel)
            if D:
                sp, sc, rb = self._subfleet(D)
                fsub = counts2d[sel].reshape(-1).astype(float)
                starts = self.cache.starts
                lens = starts[sel + 1] - starts[sel]
                off = np.repeat(starts[sel], lens)
                within = (np.arange(int(lens.sum()))
                          - np.repeat(np.cumsum(lens) - lens, lens))
                st, drains_ok = _global_repair(
                    fsub, sp, sc, self.gpus[sel], power[sel], load_m,
                    old_agg[off + within], r_m,
                    deadline=t0 + self.time_limit, exact=False,
                    restore_best=rb, swap_rel_tol=self.swap_rel_tol)
                counts2d[sel] = np.round(fsub).astype(int).reshape(D, -1)
                fleet_dr = st.fleet_drains + clean_drains
            else:
                drains_ok, fleet_dr = True, clean_drains
            if clean_drains > 0.0 and fleet_dr > r_limit + 1e-9:
                drains_ok = False
            counts = counts2d.reshape(-1).copy()
        else:
            fcounts = counts2d.reshape(-1).astype(float)
            st, drains_ok = _global_repair(
                fcounts, pool, self.cost, self.gpus, power, load, old_agg,
                r_limit, deadline=t0 + self.time_limit,
                exact=(mode_eff == "cold"),
                restore_best=self.cache.restore_best,
                swap_rel_tol=(0.0 if mode_eff == "cold"
                              else self.swap_rel_tol))
            counts = np.round(fcounts).astype(int)
            fleet_dr = st.fleet_drains
        meta["t_repair"] = time.perf_counter() - tr
        meta["fleet_drains"] = float(fleet_dr)
        cap = np.bincount(pool.cls, weights=counts * pool.load, minlength=9)
        unserved = np.maximum(load - cap, 0.0)
        unserved[unserved <= 1e-9] = 0.0
        status = "decomposed"
        if not drains_ok:
            status = "decomposed_overbudget"
            warnings.warn(
                f"PlannerLSession: drain projection left fleet drains "
                f"{fleet_dr:.1f} above R_L={r_limit:.1f}; plan "
                "returned with status 'decomposed_overbudget'",
                RuntimeWarning, stacklevel=2)
        plan = Plan(columns=pool.columns(), counts=counts,
                    unserved=unserved, objective=self.objective,
                    status=status,
                    solve_seconds=time.perf_counter() - t0, num_sites=S,
                    _cols=pool.column_arrays(), _pool=pool, meta=meta)
        # next-slot support: this slot's fractional LP support + active
        # plan columns — NOT the whole restricted working set (support ∪
        # capacity seed ∪ priced-in columns), which compounds across
        # slots and re-inflates every later master LP
        support_out = np.unique(np.concatenate(
            [np.nonzero(x_lp > 1e-9)[0], np.nonzero(counts > 0)[0]]))
        # duals for next slot's cross-site coupling check; a skipped
        # master solved nothing, so its zero prices are not a signal —
        # carry the last real duals forward
        if meta.get("master") == "skipped" and prev is not None:
            duals = prev.get("duals")
        else:
            duals = (np.asarray(prices, float).copy(), float(lam_r))
        self._prev = dict(power=power.copy(), load=load.copy(),
                          counts2d=counts.reshape(S, R).copy(), plan=plan,
                          support=support_out, duals=duals)
        return plan


def plan_l(table: LookupTable, sites: list[SiteSpec], power_w: np.ndarray,
           load_per_class: np.ndarray, *, objective: Objective = "latency",
           old: Optional[Plan] = None, r_frac: float = 0.03,
           time_limit: float = 60.0, method: Method = "auto",
           workers: Optional[int] = None, site_warm: bool = True,
           site_rate: Optional[np.ndarray] = None) -> Plan:
    """Solve the Fig. 10 ILP for one 15-min slot.

    ``method`` selects the solve path (see module docstring): "auto"
    (the default) is the drain-priced Lagrangian decomposition at every
    fleet size — the full constraint set, R_L included, with per-site
    ILPs solved independently; "monolithic" is the exact single-solve
    reference. ``workers`` sizes the process pool for the hard site
    ILPs on the decomposed path (None = auto: sequential for small hard
    batches, else one worker per core up to 8); any value returns
    bit-identical plans. ``site_warm`` enables the rounding fast path
    off the master LP's site restriction (disable for an
    all-branch-and-cut A/B — the sequential loop).
    ``site_rate``: per-site [S] relative price/carbon signal for the
    grid objectives ("cost"/"carbon") — scales each site's power cost
    so the planner shifts load toward cheap/clean sites.
    """
    S = len(sites)
    pool = ColumnPool.dense(table, S)
    if method in ("auto", "decomposed"):
        return _solve_decomposed(pool, sites, power_w, load_per_class,
                                 objective, time_limit, old=old,
                                 r_frac=r_frac, workers=workers,
                                 site_warm=site_warm, site_rate=site_rate)
    return _solve_monolithic(pool, sites, power_w, load_per_class, objective,
                             old, r_frac, time_limit, site_rate=site_rate)
