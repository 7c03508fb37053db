"""Request Scheduler, packing heuristic, and Configurator (paper §4).

The Request Scheduler dispatches arriving inference requests across sites
with weighted round-robin (WRR), weights taken from the latest plan's
provisioned per-class capacity. The paper's Request Class Predictor
(Albert/DistilBert + regressor, 99.95% bucket accuracy) is treated as an
oracle exactly as the paper does ("we treat output length as an oracle in
our experiments") — ``classify`` on the trace plays that role.

The packing heuristic moves smaller-class requests into under-loaded
instances configured for larger classes (LS→LM, …), starting from the
larger requests — improving latency when a class transiently overloads
its own instances while a bigger class has headroom.

Fast path
---------
Dispatch is the hot inner loop of the week/fine simulators (672 slots,
900 s × 3 variants) and of fleet-scale benchmarks, so it has two
implementations:

  * ``dispatch`` — columnar/vectorized over a ``GroupTable``
    (struct-of-arrays), used everywhere. Both the WRR pass and the
    packing waterfall are numpy matrix ops: WRR shares come from a
    per-class capacity bincount, packing uses the precomputed [9, 9]
    class-dominance mask plus a stable argsort-by-e2e host order and a
    cumsum waterfall per class (9 iterations total, never per-group).
  * ``dispatch_reference`` — the original per-``InstanceGroup`` Python
    loop, kept verbatim as the semantic reference. Equivalence to 1e-9
    on randomized plans is enforced by tests/test_scheduler.py and by
    benchmarks/bench_dispatch.py.

Invariants both paths maintain: served + dropped == arrivals exactly
per class; per-site loads sum to total served; packing only moves a
class onto hosts whose class strictly dominates it (both buckets >=,
not equal); hosts are filled in ascending-e2e order with stable ties.

The Configurator applies TP/frequency changes between plans; groups with
pending TP re-shards are frozen (excluded from Planner-S placement) for
``tp_reshard_seconds`` — the paper's C3 overhead, hidden DynamoLLM-style
by background weight transfer. Its (s, c, t) diffs come from
``Plan.agg_by_sct()``, which aggregates straight off the plan's columnar
pool (one np.unique + bincount — no per-object loop), the same pool
``GroupTable.from_plan`` reads for dispatch and ``Plan.gpu_budget_pool``
reads for the Planner-S hand-off.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.lookup import LookupTable, Row
from repro_torch.core.planner_l import Plan

# class index helpers: c = 3*input_bucket + output_bucket
def _in_bucket(c: int) -> int:
    return c // 3


def _out_bucket(c: int) -> int:
    return c % 3


def smaller_classes(c: int) -> list[int]:
    """Classes strictly dominated by c (both buckets <=, not equal) —
    requests of those classes can safely run on a class-c instance."""
    ic, oc = _in_bucket(c), _out_bucket(c)
    return [3 * i + o for i in range(ic + 1) for o in range(oc + 1)
            if (i, o) != (ic, oc)]


# DOMINANCE[host_cls, req_cls]: a host of class ``host_cls`` may serve
# overflow of class ``req_cls`` (strict dominance, both buckets).
DOMINANCE = np.zeros((9, 9), dtype=bool)
for _c in range(9):
    DOMINANCE[_c, smaller_classes(_c)] = True


@dataclass
class InstanceGroup:
    """All instances at one (site, row) operating point."""
    site: int
    row: Row
    count: int

    @property
    def capacity(self) -> float:
        return self.count * self.row.load


class GroupTable:
    """Columnar (struct-of-arrays) view of a plan's instance groups.

    One row per (site, lookup-row) group; all fields are parallel numpy
    arrays so dispatch is pure vector math. Built once per plan (see
    ``Plan.group_table``) and reused across every dispatch against that
    plan; per-second brownouts only swap the ``counts`` column (see
    ``with_counts``) while the static geometry (dominance-filtered host
    masks, stable e2e host order) is shared.
    """

    __slots__ = ("site", "cls", "count", "load", "e2e", "power",
                 "capacity", "num_sites", "order", "host_ok",
                 "site_groups", "site_e2e_sum")

    def __init__(self, site: np.ndarray, cls: np.ndarray, count: np.ndarray,
                 load: np.ndarray, e2e: np.ndarray, power: np.ndarray,
                 num_sites: int):
        self.site = np.asarray(site, dtype=np.intp)
        self.cls = np.asarray(cls, dtype=np.intp)
        self.count = np.asarray(count, dtype=float)
        self.load = np.asarray(load, dtype=float)
        self.e2e = np.asarray(e2e, dtype=float)
        self.power = np.asarray(power, dtype=float)
        self.capacity = self.count * self.load
        self.num_sites = int(num_sites)
        # stable ascending-e2e order == the reference's stable host sort
        self.order = np.argsort(self.e2e, kind="stable")
        # host_ok[g, c]: group g's class strictly dominates class c
        self.host_ok = DOMINANCE[self.cls]
        # per-site group stats for the router's straggler EWMA (static)
        self.site_groups = np.bincount(self.site, minlength=self.num_sites)
        self.site_e2e_sum = np.bincount(self.site, weights=self.e2e,
                                        minlength=self.num_sites)

    def __len__(self) -> int:
        return self.site.shape[0]

    @classmethod
    def from_groups(cls, groups: list[InstanceGroup],
                    num_sites: int) -> "GroupTable":
        return cls(site=np.array([g.site for g in groups], dtype=np.intp),
                   cls=np.array([g.row.cls for g in groups], dtype=np.intp),
                   count=np.array([g.count for g in groups], dtype=float),
                   load=np.array([g.row.load for g in groups], dtype=float),
                   e2e=np.array([g.row.e2e for g in groups], dtype=float),
                   power=np.array([g.row.power for g in groups], dtype=float),
                   num_sites=num_sites)

    @classmethod
    def from_plan(cls, plan: Plan, active_only: bool = True) -> "GroupTable":
        site, cl, tp, load, power, e2e = plan.column_arrays()
        counts = plan.counts.astype(float)
        if active_only:
            m = counts > 0
            site, cl, load, power, e2e, counts = (
                site[m], cl[m], load[m], power[m], e2e[m], counts[m])
        return cls(site=site, cls=cl, count=counts, load=load, e2e=e2e,
                   power=power, num_sites=plan.num_sites)

    def with_counts(self, counts: np.ndarray) -> "GroupTable":
        """Cheap shallow copy with a different ``count`` column (brownouts)."""
        t = GroupTable.__new__(GroupTable)
        for name in GroupTable.__slots__:       # share all static geometry
            setattr(t, name, getattr(self, name))
        t.count = np.asarray(counts, dtype=float)
        t.capacity = t.count * t.load
        return t

    def total_power(self) -> float:
        return float((self.count * self.power).sum())


@dataclass
class DispatchResult:
    served: np.ndarray            # [9] rps served within capacity
    dropped: np.ndarray           # [9] rps dropped (power/capacity)
    mean_e2e: np.ndarray          # [9] load-weighted mean E2E per class
    packed: np.ndarray            # [9] rps moved by the packing heuristic
    per_site_load: np.ndarray     # [S] rps landing on each site

    def aggregate_e2e(self) -> float:
        m = self.served > 0
        if not m.any():
            return 0.0
        return float((self.mean_e2e[m] * self.served[m]).sum()
                     / self.served[m].sum())


class RequestScheduler:
    """WRR dispatch + optional packing, fluid-flow semantics."""

    def __init__(self, num_sites: int, packing: bool = True):
        self.num_sites = num_sites
        self.packing = packing

    def groups_from_plan(self, plan: Plan) -> list[InstanceGroup]:
        return [InstanceGroup(site=s, row=r, count=int(x))
                for s, r, x in plan.active()]

    # ---------------- vectorized fast path ----------------
    def dispatch(self, groups, arrivals: np.ndarray) -> DispatchResult:
        """Route ``arrivals`` [9] rps across ``groups`` by WRR weights.

        ``groups`` may be a ``GroupTable`` (fast path, preferred) or a
        ``list[InstanceGroup]`` (converted on the fly). Overflow beyond
        rated capacity that packing cannot place is reported as dropped;
        the fluid backlog / 2x queueing model lives in the caller
        (``simulate_slot_fine``), which re-offers queued load as demand.
        """
        if not isinstance(groups, GroupTable):
            groups = GroupTable.from_groups(groups, self.num_sites)
        t = groups
        S = self.num_sites
        load = arrivals.astype(float)
        cap9 = np.bincount(t.cls, weights=t.capacity, minlength=9)

        # ---- first pass: own-class WRR (∝ group capacity) ----
        take = np.minimum(load, cap9)
        take[cap9 <= 0] = 0.0
        frac = np.divide(take, cap9, out=np.zeros(9), where=cap9 > 0)
        share = t.capacity * frac[t.cls]                       # [n]
        free = t.capacity - share
        served = take.copy()
        overflow = load - take
        e2e_num = np.bincount(t.cls, weights=share * t.e2e, minlength=9)
        per_site = np.bincount(t.site, weights=share, minlength=S)
        packed = np.zeros(9)

        # ---- packing: overflow of smaller classes into larger hosts ----
        if self.packing and (overflow > 1e-12).any():
            order = t.order
            site_o = t.site[order]
            e2e_o = t.e2e[order]
            host_ok_o = t.host_ok[order]
            free_o = free[order]
            for c in range(8, -1, -1):        # larger requests first (paper)
                ov = overflow[c]
                if ov <= 1e-12:
                    continue
                hosts = np.nonzero(host_ok_o[:, c] & (free_o > 1e-12))[0]
                if hosts.size == 0:
                    continue
                # waterfall: fill hosts in ascending-e2e order via cumsum
                cum = np.cumsum(free_o[hosts])
                taken = np.diff(np.minimum(cum, ov), prepend=0.0)
                moved = min(ov, cum[-1])
                free_o[hosts] -= taken
                overflow[c] -= moved
                served[c] += moved
                packed[c] += moved
                # a smaller request on a larger-class instance finishes
                # no slower than the host class's e2e
                e2e_num[c] += float((taken * e2e_o[hosts]).sum())
                per_site += np.bincount(site_o[hosts], weights=taken,
                                        minlength=S)
        dropped = overflow
        mean_e2e = np.where(served > 0, e2e_num / np.maximum(served, 1e-12), 0.0)
        return DispatchResult(served=served, dropped=dropped, mean_e2e=mean_e2e,
                              packed=packed, per_site_load=per_site)

    # ---------------- loop reference (equivalence oracle) ----------------
    def dispatch_reference(self, groups: list[InstanceGroup],
                           arrivals: np.ndarray) -> DispatchResult:
        """Original per-object dispatch loop, kept as the semantic oracle
        for the vectorized path (tests assert 1e-9 agreement)."""
        S = self.num_sites
        served = np.zeros(9)
        dropped = np.zeros(9)
        packed = np.zeros(9)
        e2e_num = np.zeros(9)
        per_site = np.zeros(S)
        cap = np.zeros(9)
        for g in groups:
            cap[g.row.cls] += g.capacity

        load = arrivals.astype(float).copy()
        free = {id(g): g.capacity for g in groups}

        # ---- first pass: own-class WRR (∝ group capacity) ----
        overflow = np.zeros(9)
        for c in range(9):
            gs = [g for g in groups if g.row.cls == c]
            if not gs or cap[c] <= 0:
                overflow[c] = load[c]
                continue
            take = min(load[c], cap[c])
            overflow[c] = load[c] - take
            for g in gs:
                share = take * (g.capacity / cap[c])
                free[id(g)] -= share
                served[c] += share
                e2e_num[c] += share * g.row.e2e
                per_site[g.site] += share
        # ---- packing: overflow of smaller classes into larger hosts ----
        if self.packing:
            for c in range(8, -1, -1):        # larger requests first (paper)
                if overflow[c] <= 1e-12:
                    continue
                hosts = [g for g in groups
                         if c in smaller_classes(g.row.cls)
                         and free[id(g)] > 1e-12]
                hosts.sort(key=lambda g: g.row.e2e)
                for g in hosts:
                    if overflow[c] <= 1e-12:
                        break
                    take = min(overflow[c], free[id(g)])
                    free[id(g)] -= take
                    overflow[c] -= take
                    served[c] += take
                    packed[c] += take
                    e2e_num[c] += take * g.row.e2e
                    per_site[g.site] += take
        dropped = overflow
        mean_e2e = np.where(served > 0, e2e_num / np.maximum(served, 1e-12), 0.0)
        return DispatchResult(served=served, dropped=dropped, mean_e2e=mean_e2e,
                              packed=packed, per_site_load=per_site)


@dataclass
class Configurator:
    """Tracks TP re-shards between consecutive plans; freezes groups."""
    tp_reshard_seconds: float = 30.0
    freq_switch_seconds: float = 0.05
    _pending: dict[tuple[int, int, int], float] = field(default_factory=dict)

    def apply(self, old: Plan | None, new: Plan, now: float) -> None:
        """Diff (s,c,t) instance counts; start re-shard timers on changes.
        Already-expired timers are purged so long-running drivers (the
        week simulator applies once per slot) don't accumulate stale
        pending entries."""
        self._pending = {k: t for k, t in self._pending.items() if t > now}
        if old is None:
            return
        o = old.agg_by_sct()
        n = new.agg_by_sct()
        for k in set(o) | set(n):
            if o.get(k, 0) != n.get(k, 0):
                self._pending[k] = now + self.tp_reshard_seconds

    def frozen(self, now: float) -> set:
        self._pending = {k: t for k, t in self._pending.items() if t > now}
        return set(self._pending)

    def reconfig_count(self, old: Plan | None, new: Plan) -> int:
        if old is None:
            return 0
        o = old.agg_by_sct()
        n = new.agg_by_sct()
        return int(sum(abs(o.get(k, 0) - n.get(k, 0)) for k in set(o) | set(n)))
