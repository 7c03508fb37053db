"""Shared problem-construction layer for the Heron planners.

Both planners (Figs. 10/11), both baselines, and the decomposed fleet
solver enumerate the same object: *columns* — (site, lookup Row) pairs
whose integer multiplicity is the decision variable. Before this layer
existed, each consumer re-derived per-column cost/power/load/class/TP
arrays with its own Python loop; now they all draw from one columnar
pool and assemble their sparse constraint blocks through one builder.

  * ``TableSOA``       — struct-of-arrays over a ``LookupTable``'s rows,
    cached on the table instance (rows are immutable), plus a
    (cls, tp) → row-index map used to expand GPU budgets into columns.
  * ``ColumnPool``     — struct-of-arrays over (site, Row) columns:
    cost/power/load/cls/tp/freq/e2e plus the (s, c, t) group index that
    constraints (4)-(7) and the Configurator aggregate over.
  * ``ConstraintBuilder`` — accumulates ≤ / ≥ constraint blocks as
    vectorized COO triplets and emits the CSR matrices ``solve_milp``
    consumes. Blocks are appended in declaration order, so a builder-
    assembled problem is bit-identical to the historical hand-rolled
    loops (same (row, col, value) multiset → same canonical CSR).
  * ``GpuBudget``      — the columnar form of Planner-L's GPU_{s,c,t}
    grant. ``plan_s``, the router, and the fine simulator pass this
    around instead of re-materialising {(s,c,t): gpus} dicts per solve.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy import sparse

from repro_torch.core.lookup import LookupTable, Row

# (s, c, t) group keys: site-major integer encoding shared by every
# consumer that aggregates over (site, class, TP) groups — the pool's
# group index, GPU-budget aggregation, Configurator diffs, and the
# planners' constraint alignment. cls < _CLS_BASE and tp < _TP_BASE by
# construction (9 request classes; TP degrees are small powers of two).
_TP_BASE = 64
_CLS_BASE = 9


def sct_key(site: np.ndarray, cls: np.ndarray, tp) -> np.ndarray:
    """Encode (site, cls, tp) triples as sortable int64 keys."""
    tp = np.asarray(tp)
    if len(tp) and (tp.max() >= _TP_BASE or np.asarray(cls).max() >= _CLS_BASE):
        raise ValueError("sct_key: tp/cls out of encodable range")
    return (np.asarray(site).astype(np.int64) * (_CLS_BASE * _TP_BASE)
            + np.asarray(cls).astype(np.int64) * _TP_BASE
            + tp.astype(np.int64))


def sct_unkey(key: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode ``sct_key`` values back to (site, cls, tp) arrays."""
    key = np.asarray(key, dtype=np.int64)
    return (key // (_CLS_BASE * _TP_BASE),
            (key // _TP_BASE) % _CLS_BASE,
            key % _TP_BASE)


# ------------------------------------------------------------------
# table struct-of-arrays (cached per LookupTable)
# ------------------------------------------------------------------
class TableSOA:
    """Columnar view of a lookup table's rows + (cls, tp) index."""

    __slots__ = ("rows", "cls", "tp", "freq", "load", "power", "e2e",
                 "by_cls_tp")

    def __init__(self, table: LookupTable):
        rows = table.rows
        n = len(rows)
        self.rows = np.empty(n, dtype=object)
        self.cls = np.empty(n, dtype=np.intp)
        self.tp = np.empty(n, dtype=np.intp)
        self.freq = np.empty(n, dtype=float)
        self.load = np.empty(n, dtype=float)
        self.power = np.empty(n, dtype=float)
        self.e2e = np.empty(n, dtype=float)
        for i, r in enumerate(rows):
            self.rows[i] = r
            self.cls[i] = r.cls
            self.tp[i] = r.tp
            self.freq[i] = r.freq
            self.load[i] = r.load
            self.power[i] = r.power
            self.e2e[i] = r.e2e
        # (cls, tp) -> row indices, preserving table order (valid_rows order)
        self.by_cls_tp: dict[tuple[int, int], np.ndarray] = {}
        for i in range(n):
            self.by_cls_tp.setdefault(
                (int(self.cls[i]), int(self.tp[i])), []).append(i)
        self.by_cls_tp = {k: np.asarray(v, dtype=np.intp)
                          for k, v in self.by_cls_tp.items()}


def table_soa(table: LookupTable) -> TableSOA:
    """Cached columnar view of ``table`` (rows are immutable)."""
    soa = getattr(table, "_soa", None)
    if soa is None:
        soa = TableSOA(table)
        table._soa = soa
    return soa


# ------------------------------------------------------------------
# column pool
# ------------------------------------------------------------------
class ColumnPool:
    """Struct-of-arrays over the (site, Row) columns of one problem.

    ``row_idx`` indexes into the owning table's rows so ``columns()``
    can materialise the legacy list[(site, Row)] without a per-column
    attribute walk. ``sct`` lazily builds the (s, c, t) group index that
    the one-(f,l)-per-group and reconfiguration constraints range over;
    groups are ordered by sorted (s, c, t) key — exactly the historical
    ``sorted({...})`` enumeration.
    """

    __slots__ = ("table", "site", "row_idx", "cls", "tp", "freq", "load",
                 "power", "e2e", "num_sites", "_sct", "_columns",
                 "_cls_idx")

    def __init__(self, table: LookupTable, site: np.ndarray,
                 row_idx: np.ndarray, num_sites: int):
        soa = table_soa(table)
        self.table = table
        self.site = np.asarray(site, dtype=np.intp)
        self.row_idx = np.asarray(row_idx, dtype=np.intp)
        self.cls = soa.cls[self.row_idx]
        self.tp = soa.tp[self.row_idx]
        self.freq = soa.freq[self.row_idx]
        self.load = soa.load[self.row_idx]
        self.power = soa.power[self.row_idx]
        self.e2e = soa.e2e[self.row_idx]
        self.num_sites = int(num_sites)
        self._sct = None
        self._columns = None
        self._cls_idx = None

    def __len__(self) -> int:
        return self.site.shape[0]

    @classmethod
    def dense(cls, table: LookupTable, num_sites: int) -> "ColumnPool":
        """Every row at every site — Planner-L's search space."""
        R = len(table.rows)
        site = np.repeat(np.arange(num_sites, dtype=np.intp), R)
        row_idx = np.tile(np.arange(R, dtype=np.intp), num_sites)
        return cls(table, site, row_idx, num_sites)

    @classmethod
    def for_budget(cls, table: LookupTable, budget: "GpuBudget",
                   num_sites: int,
                   frozen: Optional[set] = None) -> "ColumnPool":
        """Planner-S's search space: rows matching granted (s, c, t)s."""
        soa = table_soa(table)
        frozen = frozen or set()
        sites_out, rows_out = [], []
        for s, c, t, g in zip(budget.site, budget.cls, budget.tp,
                              budget.gpus):
            if g <= 0 or (int(s), int(c), int(t)) in frozen:
                continue
            idx = soa.by_cls_tp.get((int(c), int(t)))
            if idx is None:
                continue
            rows_out.append(idx)
            sites_out.append(np.full(len(idx), s, dtype=np.intp))
        if not rows_out:
            return cls(table, np.empty(0, np.intp), np.empty(0, np.intp),
                       num_sites)
        return cls(table, np.concatenate(sites_out),
                   np.concatenate(rows_out), num_sites)

    def cost(self, objective: str,
             site_rate: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-column objective coefficients.

        ``"latency"`` -> E2E; ``"power"`` -> watts. The grid objectives
        ``"cost"`` ($/MWh) and ``"carbon"`` (gCO2/kWh) are power scaled
        by a per-site rate signal: ``site_rate`` is a relative [S]
        vector (mean ~1.0, e.g. price factors from the knowledge plane)
        gathered per column, so expensive/dirty sites price higher and
        the planner shifts load off them. Without ``site_rate`` they
        degrade to plain power (uniform rates change nothing).
        """
        if objective == "latency":
            return self.e2e
        if site_rate is not None and objective in ("cost", "carbon"):
            return self.power * np.asarray(site_rate, float)[self.site]
        return self.power

    def columns(self) -> list[tuple[int, Row]]:
        """Legacy list[(site, Row)] view (what ``Plan`` stores).

        Cached: every Plan built over this pool shares one list (treated
        as read-only everywhere), so per-slot re-plans at 10k sites stop
        paying an 860k-tuple materialisation per solve.
        """
        if self._columns is None:
            rows = table_soa(self.table).rows[self.row_idx]
            self._columns = list(zip(self.site.tolist(), rows.tolist()))
        return self._columns

    def column_arrays(self) -> tuple:
        """The (site, cls, tp, load, power, e2e) tuple ``Plan`` caches."""
        return (self.site, self.cls, self.tp.astype(float), self.load,
                self.power, self.e2e)

    def cls_index(self, c: int) -> np.ndarray:
        """Ascending column indices of class ``c`` (cached).

        The greedy fleet moves scan one class at a time; pre-splitting
        the pool turns their per-step fleet-wide masks into masks over
        one class's columns (~1/9 of the pool) without changing the
        candidate order.
        """
        if self._cls_idx is None:
            self._cls_idx = [np.nonzero(self.cls == k)[0] for k in range(9)]
        return self._cls_idx[c]

    def sct(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(codes [n], g_site, g_cls, g_tp) — (s, c, t) group index.

        Group g spans the columns with ``codes == g``; groups are sorted
        by (site, cls, tp) so constraint row order matches the
        historical ``sorted({(s, cls, tp)})`` enumeration bit-for-bit.
        """
        if self._sct is None:
            uniq, codes = np.unique(sct_key(self.site, self.cls, self.tp),
                                    return_inverse=True)
            g_site, g_cls, g_tp = (a.astype(np.intp)
                                   for a in sct_unkey(uniq))
            self._sct = (codes.astype(np.intp), g_site, g_cls, g_tp)
        return self._sct


# ------------------------------------------------------------------
# constraint builder
# ------------------------------------------------------------------
class _Block:
    __slots__ = ("rows", "cols", "data", "rhs", "nrows")

    def __init__(self):
        self.rows, self.cols, self.data, self.rhs = [], [], [], []
        self.nrows = 0

    def add(self, rows, cols, data, rhs):
        rows = np.asarray(rows, dtype=np.intp)
        rhs = np.atleast_1d(np.asarray(rhs, dtype=float))
        self.rows.append(rows + self.nrows)
        self.cols.append(np.asarray(cols, dtype=np.intp))
        self.data.append(np.asarray(data, dtype=float))
        self.rhs.append(rhs)
        self.nrows += len(rhs)

    def build(self, nv: int):
        if not self.rhs:
            return None, None
        A = sparse.csr_matrix(
            (np.concatenate(self.data),
             (np.concatenate(self.rows), np.concatenate(self.cols))),
            shape=(self.nrows, nv))
        return A, np.concatenate(self.rhs)


class ConstraintBuilder:
    """Vectorized COO accumulation of A_ub x ≤ b_ub and A_lb x ≥ b_lb.

    ``ub``/``lb`` append one *block* each call: ``rows`` are block-local
    row ids in [0, len(rhs)), offset automatically by the rows already
    emitted on that side. Duplicate (row, col) entries sum, exactly like
    the historical triplet lists.
    """

    def __init__(self, nv: int):
        self.nv = nv
        self._ub = _Block()
        self._lb = _Block()

    def ub(self, rows, cols, data, rhs) -> None:
        self._ub.add(rows, cols, data, rhs)

    def lb(self, rows, cols, data, rhs) -> None:
        self._lb.add(rows, cols, data, rhs)

    def build(self):
        A_ub, b_ub = self._ub.build(self.nv)
        A_lb, b_lb = self._lb.build(self.nv)
        return A_ub, b_ub, A_lb, b_lb


# ------------------------------------------------------------------
# columnar GPU budget (Planner-L -> Planner-S hand-off)
# ------------------------------------------------------------------
@dataclass(frozen=True)
class GpuBudget:
    """GPU_{s,c,t} in struct-of-arrays form, sorted by (site, cls, tp).

    The sort order is load-bearing — ``plan_s`` aligns constraint rows
    to budget entries with ``searchsorted`` — so construction re-sorts
    defensively if handed unsorted arrays.
    """

    site: np.ndarray            # [G] intp
    cls: np.ndarray             # [G] intp
    tp: np.ndarray              # [G] intp
    gpus: np.ndarray            # [G] int

    def __post_init__(self):
        key = sct_key(self.site, self.cls, self.tp)
        if len(key) and (np.diff(key) <= 0).any():
            order = np.argsort(key, kind="stable")
            for name in ("site", "cls", "tp", "gpus"):
                object.__setattr__(self, name, getattr(self, name)[order])

    @classmethod
    def from_plan(cls, plan) -> "GpuBudget":
        """Aggregate a plan's active columns — vectorized, no dict loop."""
        site, cls_, tp, _, _, _ = plan.column_arrays()
        counts = np.asarray(plan.counts)
        active = counts > 0
        if not active.any():
            z = np.empty(0, np.intp)
            return cls(z, z, z, np.empty(0, int))
        uniq, inv = np.unique(sct_key(site[active], cls_[active],
                                      tp[active].astype(np.intp)),
                              return_inverse=True)
        gpus = np.bincount(inv, weights=counts[active]
                           * tp[active]).astype(int)
        g_site, g_cls, g_tp = (a.astype(np.intp) for a in sct_unkey(uniq))
        return cls(g_site, g_cls, g_tp, gpus)

    @classmethod
    def coerce(cls, budget) -> "GpuBudget":
        """Accept a legacy {(s, c, t): gpus} dict or pass through."""
        if isinstance(budget, cls):
            return budget
        keys = sorted(budget)
        site = np.array([k[0] for k in keys], dtype=np.intp)
        cls_ = np.array([k[1] for k in keys], dtype=np.intp)
        tp = np.array([k[2] for k in keys], dtype=np.intp)
        gpus = np.array([budget[k] for k in keys], dtype=int)
        return cls(site, cls_, tp, gpus)

    def as_dict(self) -> dict[tuple[int, int, int], int]:
        return {(int(s), int(c), int(t)): int(g)
                for s, c, t, g in zip(self.site, self.cls, self.tp,
                                      self.gpus) if g > 0}

    def __len__(self) -> int:
        return len(self.gpus)


# ------------------------------------------------------------------
# greedy fleet-inventory moves (shared by the decomposed Planner-L
# solve and Planner-S's warm-start projection)
# ------------------------------------------------------------------
class FleetState:
    """Mutable fleet inventory for greedy cover / trim / swap moves.

    Tracks integer column counts plus the derived quantities greedy
    moves need: GPU headroom per *capacity group* (per site for
    Planner-L, per granted (s,c,t) budget group for Planner-S —
    ``gpu_key`` maps each column to its group), power headroom per
    site, per-class capacity, and the active operating point of each
    (s, c, t) group (the one-(f,l) rule: a live group only grows at its
    current point; pass ``enforce_sct=False`` for Fig. 11 problems,
    which have no such constraint).

    Drain accounting (R_L)
    ----------------------
    When ``old_group`` (previous live instance counts per (s, c, t)
    group, aligned to ``pool.sct()`` order) and ``r_limit`` are given,
    the state also tracks the fleet drain total
    ``Σ_g max(0, old_g − count_g)`` — the quantity the Fig. 10
    reconfiguration bound (6,7) caps. ``trim`` and the swap polish
    consult ``drain_headroom``/``removal_drain`` before removing live
    capacity, and ``project_drains`` restores feasibility when the
    incoming counts (independent per-site solutions) overshoot R_L.
    """

    def __init__(self, counts: np.ndarray, pool: ColumnPool,
                 cost: np.ndarray, gpu_cap: np.ndarray,
                 gpu_key: np.ndarray, power_w: np.ndarray,
                 enforce_sct: bool = True,
                 old_group: Optional[np.ndarray] = None,
                 r_limit: float = np.inf,
                 restore_best: Optional[np.ndarray] = None):
        self._gbest = restore_best
        self.counts = counts
        self.pool = pool
        self.cost = cost
        self._gpu_cap = np.asarray(gpu_cap, float)
        self._power_w = np.asarray(power_w, float)
        self.gpu_key = np.asarray(gpu_key, dtype=np.intp)
        self.enforce_sct = enforce_sct
        self.codes = pool.sct()[0]
        G = int(self.codes.max()) + 1 if len(self.codes) else 0
        self.group_row = np.full(G, -1, dtype=np.intp)
        act = np.nonzero(counts > 0)[0]
        self.group_row[self.codes[act]] = act
        self.gpu_left = (np.asarray(gpu_cap, float)
                         - np.bincount(self.gpu_key, weights=counts * pool.tp,
                                       minlength=len(gpu_cap)))
        self.pw_left = (np.asarray(power_w, float)
                        - np.bincount(pool.site, weights=counts * pool.power,
                                      minlength=pool.num_sites))
        self.cap = np.bincount(pool.cls, weights=counts * pool.load,
                               minlength=9)
        self.r_limit = float(r_limit)
        self._log: Optional[list] = None
        if old_group is None:
            self.old_group = None
            self.fleet_drains = 0.0
        else:
            self.old_group = np.asarray(old_group, float)
            self.group_count = np.bincount(self.codes, weights=counts,
                                           minlength=G).astype(float)
            self.drains = np.maximum(self.old_group - self.group_count, 0.0)
            self.fleet_drains = float(self.drains.sum())

    def _shift_group(self, g: int, delta: float) -> None:
        if self.old_group is None:
            return
        self.group_count[g] += delta
        d = max(0.0, self.old_group[g] - self.group_count[g])
        self.fleet_drains += d - self.drains[g]
        self.drains[g] = d

    def rebuild(self) -> None:
        """Recompute all derived state after an external counts rollback."""
        self.__init__(self.counts, self.pool, self.cost, self._gpu_cap,
                      self.gpu_key, self._power_w, self.enforce_sct,
                      self.old_group, self.r_limit, self._gbest)

    def log_begin(self) -> None:
        """Start recording add/remove ops for a cheap ``log_rollback``.

        The rollback replays the inverse ops, so it undoes the counts
        and headroom deltas in O(ops touched) instead of the O(fleet)
        ``counts.copy()`` + ``rebuild()`` pair. Float headrooms come
        back via ``x + a - a``, which can drift a ULP from the
        canonical bincount — deterministic, but not the byte-for-byte
        state ``rebuild()`` recomputes, so exact-replay paths
        (``plan_l`` / session cold mode) must keep using ``rebuild``.
        """
        self._log = []

    def log_commit(self) -> None:
        self._log = None

    def log_rollback(self) -> None:
        ops, self._log = self._log, None
        for j, k in reversed(ops):
            (self.remove if k > 0 else self.add)(j, abs(k))

    def drain_headroom(self) -> float:
        return self.r_limit - self.fleet_drains

    def removal_drain(self, j: int, k: int) -> float:
        """By how much removing ``k`` of column ``j`` grows fleet drains."""
        if self.old_group is None:
            return 0.0
        g = self.codes[j]
        return (max(0.0, self.old_group[g] - (self.group_count[g] - k))
                - self.drains[g])

    def add(self, j: int, k: int) -> None:
        p = self.pool
        if self._log is not None:
            self._log.append((j, k))
        self.counts[j] += k
        self.gpu_left[self.gpu_key[j]] -= k * p.tp[j]
        self.pw_left[p.site[j]] -= k * p.power[j]
        self.cap[p.cls[j]] += k * p.load[j]
        self.group_row[self.codes[j]] = j
        self._shift_group(self.codes[j], k)

    def remove(self, j: int, k: int) -> None:
        p = self.pool
        if self._log is not None:
            self._log.append((j, -k))
        self.counts[j] -= k
        self.gpu_left[self.gpu_key[j]] += k * p.tp[j]
        self.pw_left[p.site[j]] += k * p.power[j]
        self.cap[p.cls[j]] -= k * p.load[j]
        if self.counts[j] <= 0:
            self.group_row[self.codes[j]] = -1
        self._shift_group(self.codes[j], -k)

    def cover(self, c: int, deficit: float,
              budget: float = np.inf) -> Optional[float]:
        """Greedily add class-``c`` capacity until ``deficit`` is met.

        Each step scores every candidate by what covering the whole
        remaining deficit with it *alone* would cost, then commits only
        the non-overshooting floor part (>= 1 instance) — so bulk goes
        to the best rps-per-cost column while cheaper mixes for the
        final partial chunk stay reachable. Respects GPU/power headroom
        and (when ``enforce_sct``) the one-(f,l) rule. Stops early once
        the added cost exceeds ``budget`` (the swap pass's abort
        signal). Returns the cost added, or None if the deficit could
        not be fully covered — moves performed so far stay applied.
        """
        p = self.pool
        spent = 0.0
        idx_c = p.cls_index(c)
        while deficit > 1e-9:
            if spent > budget:
                return None
            ok = ((self.gpu_left[self.gpu_key[idx_c]] >= p.tp[idx_c])
                  & (self.pw_left[p.site[idx_c]] >= p.power[idx_c] - 1e-9))
            if self.enforce_sct:
                g_act = self.group_row[self.codes[idx_c]]
                ok &= (g_act < 0) | (g_act == idx_c)
            cand = idx_c[ok]
            if len(cand) == 0:
                return None
            k_room = np.minimum(
                (self.gpu_left[self.gpu_key[cand]]
                 // p.tp[cand]).astype(int),
                (self.pw_left[p.site[cand]] / p.power[cand]
                 + 1e-9).astype(int))
            fin = np.ceil(deficit / p.load[cand])
            i = int(np.argmin(fin * self.cost[cand]))
            j = int(cand[i])
            k = int(min(k_room[i],
                        max(1.0, np.floor(deficit / p.load[j]))))
            if k <= 0:
                return None
            self.add(j, k)
            spent += k * self.cost[j]
            deficit -= k * p.load[j]
        return spent

    def cover_all(self, load: np.ndarray) -> None:
        """Cover every class's shortfall vs ``load`` (best effort)."""
        for c in range(9):
            short = load[c] - self.cap[c]
            if short > 1e-9:
                self.cover(c, short)

    def shed_overdraw(self) -> None:
        """Shed instances at sites drawing beyond their power cap.

        Removal order is power-per-rps (free the most power per rps of
        capacity lost), so a follow-up ``cover_all`` can re-provision
        the lost load at power-feasible rows — the greedy equivalent of
        downclocking under a power drop, which a plain
        heaviest-contributor shed cannot express.
        """
        p = self.pool
        ppr = p.power / np.maximum(p.load, 1e-12)
        for s in np.nonzero(self.pw_left < -1e-9)[0]:
            idx = np.nonzero((p.site == s) & (self.counts > 0))[0]
            for j in idx[np.argsort(-ppr[idx], kind="stable")]:
                if self.pw_left[s] >= -1e-9:
                    break
                k = min(int(self.counts[j]),
                        int(np.ceil(-self.pw_left[s] / p.power[j])))
                if k > 0:
                    self.remove(j, k)

    def trim(self, load: np.ndarray) -> None:
        """Remove surplus instances, most-expensive-per-rps first.

        The drain-aware sibling of ``trim_surplus``: a removal that
        would push the fleet drain total past ``r_limit`` is capped to
        the column's no-drain slack (count above the group's old live
        count) plus the remaining drain headroom.
        """
        p = self.pool
        ratio = self.cost / np.maximum(p.load, 1e-12)
        for c in range(9):
            if self.cap[c] - load[c] <= 1e-12:
                continue
            idx_c = p.cls_index(c)
            idx = idx_c[self.counts[idx_c] > 0]
            idx = idx[np.argsort(-ratio[idx], kind="stable")]
            for j in idx:
                surplus = self.cap[c] - load[c]
                if surplus <= 1e-12:
                    break
                k = min(int(self.counts[j]), int(surplus / p.load[j]))
                if k > 0 and self.old_group is not None:
                    g = self.codes[j]
                    free = max(0.0, self.group_count[g] - self.old_group[g])
                    # drain-free slack stays removable even when the
                    # incoming counts already overshoot the budget
                    # (negative headroom must not swallow it)
                    k = min(k, int(free + max(0.0, self.drain_headroom())
                                   + 1e-9))
                if k > 0:
                    self.remove(j, k)

    def _group_best(self, score: Optional[np.ndarray] = None) -> np.ndarray:
        """Per group: index of its min-``score`` column (first on ties).

        Default score is cost per rps — the right metric for picking a
        group's operating point when the restored capacity should keep
        serving load (a per-instance-cheapest choice would park groups
        at their lightest load point and strand their GPUs).

        The default-score result is a pure function of (pool, cost), so
        it is cached per state (and a caller holding a precomputed copy
        can hand it in as ``restore_best`` to skip the fleet-wide
        argsort entirely — same bytes either way).
        """
        if score is None:
            if self._gbest is not None:
                return self._gbest
            score = self.cost / np.maximum(self.pool.load, 1e-12)
            G = len(self.group_row)
            order = np.argsort(score, kind="stable")[::-1]
            best = np.full(G, -1, dtype=np.intp)
            best[self.codes[order]] = order      # last write = min score
            self._gbest = best
            return best
        G = len(self.group_row)
        order = np.argsort(score, kind="stable")[::-1]
        best = np.full(G, -1, dtype=np.intp)
        best[self.codes[order]] = order          # last write = min score
        return best

    def project_drains(self) -> bool:
        """Restore live capacity until fleet drains fit ``r_limit``.

        Independent per-site solutions can jointly overshoot the fleet
        drain budget (λ_R prices drains but does not hard-cap them).
        This projection greedily re-adds instances to drained (s, c, t)
        groups — at the group's active operating point when it has one,
        else its cheapest row — cheapest-cost first; when no drained
        group has GPU/power headroom it evicts the most expensive
        no-drain instance at a drained group's site to make room. The
        all-old-live point is drain-free and feasible (old capacity is
        power-scaled before drains are counted), so this terminates
        inside the budget in all but pathological fractional-scaling
        corners; returns whether the budget is met.

        The common (eviction-free) case runs as a single cost-ascending
        walk over the drained groups instead of the historical
        one-add-per-fleet-scan loop — bit-identical, because before any
        eviction a group's restore row (its active point, else its
        cheapest) and that row's cost never change while it stays
        drained, and adds only *consume* headroom: the scan loop would
        keep re-picking the same cheapest group until it is restored or
        out of room, which is exactly the walk. Groups that run out of
        room mid-walk are exactly the ones the scan would drop from its
        candidate set, so on walk exhaustion the state matches the scan
        at its first no-fit iteration and the eviction loop takes over.
        """
        if self.old_group is None or self.fleet_drains <= self.r_limit + 1e-9:
            return True
        cheapest = self._group_best()
        if self._project_walk(cheapest):
            return True
        return self._project_evict(cheapest)

    def _project_walk(self, cheapest: np.ndarray) -> bool:
        """Eviction-free restore walk; False = blocked, needs evictions."""
        p = self.pool
        gs = np.nonzero(self.drains > 1e-9)[0]
        js = np.where(self.group_row[gs] >= 0, self.group_row[gs],
                      cheapest[gs])
        ok = js >= 0
        gs, js = gs[ok], js[ok]
        order = np.lexsort((np.arange(len(gs)), self.cost[js]))
        blocked = False
        for i in order:
            g, j = int(gs[i]), int(js[i])
            while self.drains[g] > 1e-9:
                room = min(
                    self.gpu_left[self.gpu_key[j]] // max(p.tp[j], 1),
                    np.floor(self.pw_left[p.site[j]]
                             / max(p.power[j], 1e-12) + 1e-9))
                if room < 1:
                    blocked = True
                    break
                k = int(min(room, np.ceil(self.drains[g] - 1e-9),
                            self.fleet_drains - self.r_limit + 1))
                self.add(j, max(1, k))
                if self.fleet_drains <= self.r_limit + 1e-9:
                    return True
        return not blocked or self.fleet_drains <= self.r_limit + 1e-9

    def _project_evict(self, cheapest: np.ndarray) -> bool:
        """The historical scan loop — reached only when restores need
        room freed by evicting no-drain instances at drained sites."""
        p = self.pool
        _, g_site, _, _ = p.sct()
        for _ in range(100_000):
            if self.fleet_drains <= self.r_limit + 1e-9:
                return True
            gs = np.nonzero(self.drains > 1e-9)[0]
            if len(gs) == 0:
                return True
            # restore column per drained group: active row, else cheapest
            js = np.where(self.group_row[gs] >= 0, self.group_row[gs],
                          cheapest[gs])
            ok = js >= 0
            js, grp = js[ok], gs[ok]
            room = np.minimum(
                self.gpu_left[self.gpu_key[js]] // np.maximum(p.tp[js], 1),
                np.floor(self.pw_left[p.site[js]]
                         / np.maximum(p.power[js], 1e-12) + 1e-9))
            fit = room >= 1
            if fit.any():
                cand, cgrp = js[fit], grp[fit]
                i = int(np.argmin(self.cost[cand]))
                j, g = int(cand[i]), int(cgrp[i])
                k = int(min(room[fit][i],
                            np.ceil(self.drains[g] - 1e-9),
                            self.fleet_drains - self.r_limit + 1))
                self.add(j, max(1, k))
                continue
            # no headroom: evict the most expensive no-drain instance at
            # a drained group's site, then retry the restore
            evicted = False
            for g in gs[np.argsort(-self.drains[gs], kind="stable")]:
                s = g_site[g]
                cand = np.nonzero((p.site == s) & (self.counts > 0))[0]
                cand = cand[[self.removal_drain(int(j), 1) <= 1e-9
                             for j in cand]]
                if len(cand):
                    self.remove(int(cand[np.argmax(self.cost[cand])]), 1)
                    evicted = True
                    break
            if not evicted:
                return False            # stuck — best effort (documented)
        return self.fleet_drains <= self.r_limit + 1e-9


def trim_surplus(counts: np.ndarray, pool: ColumnPool,
                 cost: np.ndarray, load: np.ndarray) -> None:
    """Remove surplus instances, most-expensive-per-rps first (in place)."""
    cap = np.bincount(pool.cls, weights=counts * pool.load, minlength=9)
    ratio = cost / np.maximum(pool.load, 1e-12)
    for c in range(9):
        surplus = cap[c] - load[c]
        if surplus <= 1e-12:
            continue
        idx_c = pool.cls_index(c)
        idx = idx_c[counts[idx_c] > 0]
        idx = idx[np.argsort(-ratio[idx], kind="stable")]
        for j in idx:
            if surplus <= 1e-12:
                break
            k = min(int(counts[j]), int(surplus / pool.load[j]))
            if k > 0:
                counts[j] -= k
                surplus -= k * pool.load[j]


def plan_objective(plan, drop_penalty: float,
                   objective: Optional[str] = None) -> float:
    """The ILP objective value a plan achieves: cost·x + penalty·slack."""
    _, _, _, _, power, e2e = plan.column_arrays()
    cost = e2e if (objective or plan.objective) == "latency" else power
    return float((plan.counts * cost).sum()
                 + drop_penalty * plan.unserved.sum())
