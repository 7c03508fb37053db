"""Baseline schedulers (paper §5.2 (c) and (d)).

(c) WRR + DynamoLLM: a weighted-round-robin router splits the workload
    across sites ∝ provisioned compute; each site runs a DynamoLLM-style
    scheduler that picks per-class (TP, f, load) minimizing power/energy,
    assuming a traditional DC — i.e. *power-variability agnostic* (it
    plans as if the site always has its full provisioned power).

(d) Greedy min-latency: assigns TP_max + highest frequency, capping each
    GPU instance's load at the per-class knee point of the latency-vs-load
    curve (the paper's fix for the naive lowest-load variant that strands
    ~33% of requests on capacity limits).

Both baselines produce the same ``Plan`` shape as the Heron planners, so
the simulator scores everyone identically: when the *actual* available
power at a site is below the plan's draw, whole instances brown out
(greedy highest-power-first shedding) and their load is dropped — exactly
the C1 failure mode of Fig. 8.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.lookup import LookupTable, Row
from repro_torch.core.planner_l import Plan, SiteSpec, plan_l
from repro_torch.core.planning import ColumnPool
from repro_torch.core.scheduler import DispatchResult, RequestScheduler


def wrr_split(sites: list[SiteSpec], load_per_class: np.ndarray) -> list[np.ndarray]:
    """Split the global per-class load across sites ∝ provisioned GPUs."""
    w = np.array([s.num_gpus for s in sites], float)
    w = w / w.sum()
    return [load_per_class * wi for wi in w]


def dynamollm_site_plan(table: LookupTable, site: SiteSpec,
                        site_load: np.ndarray, time_limit: float = 30.0) -> Plan:
    """Site-local min-power assignment with *assumed-infinite* power.

    Pinned to the monolithic solve: the baseline is a fixed external
    reference (single-site ILPs are cheap), so its plans must not move
    when the Heron-side decomposition heuristics evolve.
    """
    inf_power = np.array([1e15])
    return plan_l(table, [site], inf_power, site_load, objective="power",
                  time_limit=time_limit, method="monolithic")


def baseline_wrr_dynamollm(table: LookupTable, sites: list[SiteSpec],
                           load_per_class: np.ndarray,
                           time_limit: float = 30.0) -> Plan:
    """Baseline (c): per-site DynamoLLM under a compute-proportional WRR.

    Each site's ILP runs over the same dense single-site column pool (the
    full lookup table), so the fleet plan is just the dense S-site pool
    with each site's solved counts scattered into its slice — no
    per-object merge loop.
    """
    splits = wrr_split(sites, load_per_class)
    S = len(sites)
    R = len(table.rows)
    pool = ColumnPool.dense(table, S)
    counts = np.zeros(S * R, dtype=int)
    unserved = np.zeros(9)
    for s, (site, sl) in enumerate(zip(sites, splits)):
        p = dynamollm_site_plan(table, site, sl, time_limit)
        counts[s * R:(s + 1) * R] = p.counts
        unserved += p.unserved
    return Plan(columns=pool.columns(), counts=counts,
                unserved=unserved, objective="power", status="baseline",
                solve_seconds=0.0, num_sites=S,
                _cols=pool.column_arrays(), _pool=pool)


def knee_points(table: LookupTable) -> dict[int, Row]:
    """Per class: the TP_max/f_max row at the knee of e2e-vs-load.

    Knee = the largest load whose marginal latency increase per doubling
    stays below 25% of the base latency (paper: "the latency increase
    before such a point is small").
    """
    out: dict[int, Row] = {}
    tp_max = max(table.hw.tp_degrees)
    f_max = table.hw.f_max
    for c in range(9):
        rows = [r for r in table.valid_rows(c)
                if r.tp == tp_max and abs(r.freq - f_max) < 1e-9]
        rows.sort(key=lambda r: r.load)
        if not rows:
            continue
        base = rows[0].e2e
        knee = rows[0]
        for r in rows[1:]:
            if r.e2e <= 1.25 * base:
                knee = r
            else:
                break
        out[c] = knee
    return out


def baseline_greedy_min_latency(table: LookupTable, sites: list[SiteSpec],
                                load_per_class: np.ndarray) -> Plan:
    """Baseline (d): TP_max + f_max instances at knee-point loads, WRR.

    Vectorized over sites: each class round is one array pass (ceil,
    min-with-headroom, headroom update), and the plan is built as a
    (site x knee-class) column pool — the historical per-site/per-class
    construction loop closed into 9 vector steps.
    """
    knees = knee_points(table)
    S = len(sites)
    splits = np.stack(wrr_split(sites, load_per_class))       # [S, 9]
    gpus_left = np.array([s.num_gpus for s in sites], dtype=int)
    kcls = sorted(knees)
    fit = np.zeros((S, len(kcls)), dtype=int)
    unserved = np.zeros(9)
    for k, c in enumerate(kcls):
        r = knees[c]
        sl = splits[:, c]
        need = np.where(sl > 0, np.ceil(sl / r.load), 0).astype(int)
        fit[:, k] = np.minimum(need, gpus_left // r.tp)
        gpus_left -= fit[:, k] * r.tp
        unserved[c] += float(((need - fit[:, k]) * r.load).sum())
    for c in range(9):
        if c not in knees:
            unserved[c] += float(np.maximum(splits[:, c], 0.0).sum())
    row_of = {id(r): i for i, r in enumerate(table.rows)}
    knee_idx = np.array([row_of[id(knees[c])] for c in kcls], dtype=np.intp)
    pool = ColumnPool(table, np.repeat(np.arange(S, dtype=np.intp), len(kcls)),
                      np.tile(knee_idx, S), S)
    return Plan(columns=pool.columns(), counts=fit.ravel(),
                unserved=unserved, objective="latency", status="baseline",
                solve_seconds=0.0, num_sites=S,
                _cols=pool.column_arrays(), _pool=pool)


# ------------------------------------------------------------------
# RoutingPolicy wrappers (see repro_torch.sim.policy)
# ------------------------------------------------------------------
@dataclass
class _BaselinePolicy:
    """Shared lifecycle for the power-variability-agnostic baselines.

    They re-plan every slot from per-class load alone, never re-solve
    inside a slot (``plan_fine`` returns the standing plan), and ignore
    health feedback and scenario control events — the agnosticism the
    paper's §5.2 comparison is about. Dispatch runs through a plain WRR
    Request Scheduler (no packing, matching the week simulator's
    historical scoring of every policy).
    """
    table: LookupTable
    sites: list[SiteSpec]
    packing: bool = False
    _plan: Optional[Plan] = field(default=None, repr=False)
    _dispatcher: RequestScheduler = field(init=False, repr=False)

    def __post_init__(self):
        self._dispatcher = RequestScheduler(len(self.sites),
                                            packing=self.packing)

    def plan_fine(self, now: float, power_w: np.ndarray,
                  observed_load: np.ndarray) -> Plan:
        assert self._plan is not None, "plan_slot first"
        return self._plan

    def route(self, groups, arrivals: np.ndarray) -> DispatchResult:
        return self._dispatcher.dispatch(groups, arrivals)

    def observe(self, latency: np.ndarray, mask=None) -> None:
        pass                    # no health integration (by design)

    def on_event(self, event) -> None:
        pass                    # no control-plane integration (by design)


@dataclass
class WrrDynamoLLMPolicy(_BaselinePolicy):
    """Baseline (c) as a RoutingPolicy: WRR split + per-site DynamoLLM."""
    time_limit: float = 20.0
    name: str = "wrr_dynamollm"

    def plan_slot(self, pred_power_w: np.ndarray,
                  pred_load: np.ndarray) -> Plan:
        self._plan = baseline_wrr_dynamollm(self.table, self.sites, pred_load,
                                            time_limit=self.time_limit)
        return self._plan


@dataclass
class GreedyMinLatencyPolicy(_BaselinePolicy):
    """Baseline (d) as a RoutingPolicy: knee-point greedy min-latency."""
    name: str = "greedy_min_latency"

    def plan_slot(self, pred_power_w: np.ndarray,
                  pred_load: np.ndarray) -> Plan:
        self._plan = baseline_greedy_min_latency(self.table, self.sites,
                                                 pred_load)
        return self._plan


def shed_counts_batch(plan: Plan, actual_power_w: np.ndarray) -> np.ndarray:
    """Vectorized brownout shedding over a batch of power realizations.

    ``actual_power_w``: [S, B] available watts per site for B scenarios
    (e.g. the seconds between two Planner-S re-solves, where the plan —
    and hence the shed geometry — is constant). Returns the surviving
    instance counts, shape [n_columns, B].

    Semantics match ``apply_power_reality_reference`` exactly: per site,
    groups are shed whole-instance, worst power-per-served-rps first
    (stable ties), until the site's draw fits its budget. The greedy
    instance-by-instance loop closes to a cumsum: with groups in shed
    order, group j sheds ``clip(ceil((need - cum_before_j)/power_j),
    0, count_j)`` instances, where ``need = draw - budget``.
    """
    site, cls_, _, load, power, _ = plan.column_arrays()
    counts = plan.counts.astype(float)
    B = actual_power_w.shape[1]
    out = np.repeat(counts[:, None], B, axis=1)
    ratio = power / np.maximum(load, 1e-9)
    for s in range(plan.num_sites):
        cols = np.nonzero(site == s)[0]
        if cols.size == 0:
            continue
        order = cols[np.argsort(-ratio[cols], kind="stable")]
        grp_pow = counts[order] * power[order]
        cum = np.cumsum(grp_pow)
        need = cum[-1] - actual_power_w[s]                   # [B]
        over = need > 0
        if not over.any():
            continue
        before = cum - grp_pow                               # draw shed by prior groups
        shed = np.ceil((need[None, over] - before[:, None])
                       / np.maximum(power[order], 1e-12)[:, None])
        shed = np.clip(shed, 0.0, counts[order, None])
        out[order[:, None], np.nonzero(over)[0][None, :]] = (
            counts[order, None] - shed)
    return out


def apply_power_reality(plan: Plan, actual_power_w: np.ndarray) -> Plan:
    """Brown out instances where the plan draws more than reality provides.

    Variability-agnostic baselines routinely overshoot during droughts; we
    shed whole instance groups (highest power-per-rps first — the site
    keeps its most power-efficient capacity alive, which is the DynamoLLM-
    friendly assumption) until the site fits its actual power. Vectorized
    via ``shed_counts_batch``; the original loop survives as
    ``apply_power_reality_reference`` for equivalence testing.
    """
    counts = shed_counts_batch(plan, actual_power_w[:, None])[:, 0]
    _, cls_, _, load, _, _ = plan.column_arrays()
    extra_unserved = np.bincount(cls_, weights=(plan.counts - counts) * load,
                                 minlength=9)
    real = Plan(columns=plan.columns, counts=counts.astype(int),
                unserved=plan.unserved + extra_unserved,
                objective=plan.objective, status=plan.status + "+reality",
                solve_seconds=plan.solve_seconds, num_sites=plan.num_sites)
    real._cols = plan.column_arrays()      # same columns -> share the cache
    return real


def apply_power_reality_reference(plan: Plan,
                                  actual_power_w: np.ndarray) -> Plan:
    """Original per-instance shedding loop (equivalence oracle)."""
    S = plan.num_sites
    counts = plan.counts.copy()
    extra_unserved = np.zeros(9)
    for s in range(S):
        idx = [i for i, (site, r) in enumerate(plan.columns)
               if site == s and counts[i] > 0]
        draw = sum(counts[i] * plan.columns[i][1].power for i in idx)
        budget = actual_power_w[s]
        if draw <= budget:
            continue
        # shed order: worst power-per-served-rps first
        idx.sort(key=lambda i: plan.columns[i][1].power
                 / max(plan.columns[i][1].load, 1e-9), reverse=True)
        for i in idx:
            r = plan.columns[i][1]
            while counts[i] > 0 and draw > budget:
                counts[i] -= 1
                draw -= r.power
                extra_unserved[r.cls] += r.load
            if draw <= budget:
                break
    return Plan(columns=plan.columns, counts=counts,
                unserved=plan.unserved + extra_unserved,
                objective=plan.objective, status=plan.status + "+reality",
                solve_seconds=plan.solve_seconds, num_sites=S)
