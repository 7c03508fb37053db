"""Heron — the logically-centralized cross-site router (paper Fig. 9).

Ties the components together for online operation:

    Planner-L  (15 min)   TP + frequency + load assignment, sticky (R_L)
    Configurator          applies TP re-shards, freezes pending groups
    Planner-S  (~5 s)     frequency/load re-solve inside L's GPU budget
    RequestScheduler      WRR dispatch + packing heuristic

``HeronRouter.step_slot`` advances one 15-min slot; ``step_seconds``
advances Planner-S/dispatch inside the slot. The same object also exposes
the straggler mitigation used at 1000+-node scale: per-site service-
latency EWMAs deweight slow sites inside the WRR (the router is the
failure/straggler absorber — the paper's own K1 story).

RoutingPolicy
-------------
``HeronRouter`` natively implements the simulators' pluggable control-
plane interface (``repro_torch.sim.policy.RoutingPolicy``): ``plan_slot`` /
``plan_fine`` map onto the two planner cadences, ``route`` dispatches an
arbitrary (e.g. brownout-shedded) group table through the router's
Request Scheduler, ``observe`` feeds the per-site latency EWMAs with the
fleet-relative slowdown signal, and ``on_event`` consumes ScenarioEngine
control events (``site_down`` / ``site_up`` drive
``mark_site_down``/``mark_site_up``; curtailment notices need no action
here because the power forecast already reflects announced curtailment).
``simulate_week("heron", ...)`` therefore exercises *this object* —
straggler haircut and site-health replanning shape weekly results, and
the Configurator's re-shard freeze clock ticks at slot cadence (its
freeze windows bind Planner-S whenever ``plan_fine`` runs) — rather than
re-implementing the planning loop; registered under the policy names
``"heron"`` (min-latency) and ``"heron_min_power"``.

Failover contract
-----------------
Site health events (``site_down`` / full-depth ``grid_trip``) do two
things: the planner stops assigning the site (``_effective_power`` zeroes
it), and ``failover_order(site)`` tells the serving layer where the dying
site's *in-flight* work should land — surviving sites ranked by their
aggregate WRR weight under the current plan, i.e. the same dispatch-path
view of spare capacity the scheduler routes new work by. The caller
(``sim.cluster.ServingCluster``) drains the dying site's engine into
transcript snapshots and re-admits them sticky-first down this order,
spending a per-request retry budget with ``serving.engine.retry_backoff``
between attempts; a request that exhausts the budget is a permanent
failure and counts against goodput. Policies without ``failover_order``
get index-order failover — the contract is the *ordering*, preemption
safety itself lives in the engine's keyed sampling streams.

Straggler knobs (``straggler_alpha`` / ``straggler_threshold`` /
``straggler_min_haircut``) are constructor parameters — see
``_effective_power`` for the graded-haircut calibration they control.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.lookup import LookupTable
from repro_torch.core.planner_l import Method, Objective, Plan, SiteSpec, plan_l
from repro_torch.core.planner_s import plan_s
from repro_torch.core.predictor import SeriesPredictor
from repro_torch.core.scheduler import Configurator, DispatchResult, RequestScheduler

SLOT_SECONDS = 900.0            # one Planner-L slot (15 min)

# Straggler knobs calibrated against the Azure-trace latency shapes the
# streamed generator produces (``calibrate_straggler_knobs`` below, seed 0
# — pinned by tests/test_sim.py::test_router_straggler_knob_defaults_and
# _factory and the default-drift regression in tests/test_e2e.py). The
# pre-calibration defaults (2.0 / 0.25) were guesses: 2.0 left ~50% of
# headroom between the worst healthy-fleet EWMA excursion (~1.08x fleet
# median) and the trip point unused — real stragglers below 2x rode
# free — and 0.25 kept deweighting proportionally far beyond the ~2.8x
# inflation the workload's own p99/mean tail ratio can explain, i.e. it
# acted on a signal range the latency shapes say carries no information.
STRAGGLER_ALPHA = 0.2
STRAGGLER_THRESHOLD = 1.35
STRAGGLER_MIN_HAIRCUT = 0.47


def calibrate_straggler_knobs(traces=None, *, num_users: int = 1_000_000,
                              num_sites: int = 4,
                              duration_s: float = 6 * 3600.0,
                              window_s: float = 60.0,
                              alpha: float = STRAGGLER_ALPHA,
                              seed: int = 0, headroom: float = 1.25):
    """Derive ``(straggler_threshold, straggler_min_haircut)`` from the
    Azure-trace latency shapes of ``data.workload.stream_requests``.

    The straggler signal the router observes is per-site mean service
    latency relative to the fleet median. On a *healthy* fleet that ratio
    is not 1.0: sites differ in class mix (regional diurnal phase) and
    every window carries lognormal length-sampling noise, so an
    uncalibrated threshold either trips on mix noise (too low) or lets
    real stragglers ride free (too high). This replays a streamed window
    of the generator's traffic, tracks each site's EWMA of mean nominal
    service time (prefill-discounted ``lin`` + ``lout``, in token-time
    units) relative to the fleet median, and returns:

      * ``threshold``: ``headroom`` x the worst healthy fleet-relative
        EWMA excursion — mix noise can never trip the haircut, and
        everything above is genuine slowdown;
      * ``min_haircut``: ``threshold / (p99/mean of the per-request
        service proxy)`` — the haircut stays *proportional* across the
        whole inflation range the workload itself can explain (a site
        stuck on tail-heavy requests inflates its window mean toward the
        proxy's p99), and floors beyond it: deeper inflation is
        non-workload pathology where the proportional signal model no
        longer holds, and the floored residual keeps the site absorbing
        load so its EWMA can recover via ``observe``.
    """
    from repro_torch.data.workload import make_trace, stream_requests
    if traces is None:
        traces = [make_trace("coding"), make_trace("conversation")]
    S = num_sites
    ewma = np.zeros(S)
    burn_in = int(np.ceil(3.0 / alpha))        # ~95% settled
    worst_ewma = 0.0
    proxy_sum = proxy_n = 0.0
    proxy_sample: list[np.ndarray] = []
    nwin = 0
    for ch in stream_requests(traces, num_users=num_users, num_sites=S,
                              duration_s=duration_s, chunk_s=window_s,
                              seed=seed):
        if len(ch) < 2 * S:
            continue
        # nominal service proxy in token-time units: decode is one token
        # time per output token; prefill tokens batch ~an order of
        # magnitude cheaper (MFU_PREFILL vs memory-bound decode)
        proxy = ch.lin / 8.0 + ch.lout
        proxy_sum += float(proxy.sum())
        proxy_n += len(proxy)
        proxy_sample.append(proxy[:: max(len(proxy) // 256, 1)])
        mean = np.full(S, np.nan)
        for s in range(S):
            m = ch.site == s
            if m.any():
                mean[s] = proxy[m].mean()
        rel = mean / max(float(np.nanmedian(mean)), 1e-9)
        ok = np.isfinite(rel)
        ewma[ok] = (1 - alpha) * ewma[ok] + alpha * rel[ok]
        nwin += 1
        if nwin <= burn_in:
            continue
        fleet = float(np.median(ewma[ewma > 0])) if (ewma > 0).any() else 1.0
        worst_ewma = max(worst_ewma, float(np.max(ewma / max(fleet, 1e-9))))
    threshold = round(headroom * worst_ewma, 2)
    tail = np.percentile(np.concatenate(proxy_sample), 99)
    tail_ratio = float(tail) / max(proxy_sum / max(proxy_n, 1.0), 1e-9)
    min_haircut = round(min(1.0, max(0.1, threshold / tail_ratio)), 2)
    return threshold, min_haircut


@dataclass
class HeronRouter:
    table: LookupTable
    sites: list[SiteSpec]
    objective: Objective = "latency"
    r_frac: float = 0.03
    planner_s_period: float = 5.0
    packing: bool = True
    time_limit_l: float = 60.0
    time_limit_s: float = 10.0
    straggler_alpha: float = STRAGGLER_ALPHA       # EWMA coefficient
    # deweight sites slower than threshold x fleet median; floor the
    # graded haircut — both calibrated (calibrate_straggler_knobs)
    straggler_threshold: float = STRAGGLER_THRESHOLD
    straggler_min_haircut: float = STRAGGLER_MIN_HAIRCUT
    planner_method: Method = "auto"       # "monolithic" = exact reference
    planner_workers: Optional[int] = None  # site-ILP process pool size
    # event-driven Planner-L: keep a PlannerLSession across slots and
    # re-plan incrementally (dirty-site sub-solve) when knowledge-plane
    # power moved less than ``dirty_tol`` on most sites. Default off —
    # the stateless plan_l path is the pinned reference behavior.
    incremental: bool = False
    dirty_tol: float = 0.02

    _plan_l: Optional[Plan] = None
    _plan_s: Optional[Plan] = None
    _cfgtor: Configurator = field(default_factory=Configurator)
    _dispatcher: Optional[RequestScheduler] = None
    _site_latency_ewma: Optional[np.ndarray] = None
    _site_alive: Optional[np.ndarray] = None
    _now: float = 0.0
    _session = None                     # lazy PlannerLSession

    def __post_init__(self):
        S = len(self.sites)
        self._dispatcher = RequestScheduler(S, packing=self.packing)
        self._site_latency_ewma = np.zeros(S)
        self._site_alive = np.ones(S, bool)

    # ---------------- site health (fault tolerance) ----------------
    def mark_site_down(self, s: int) -> None:
        """Site lost (grid trip, fibre cut, maintenance) — replan without it."""
        self._site_alive[s] = False

    def mark_site_up(self, s: int) -> None:
        self._site_alive[s] = True

    def observe_latency(self, s: int, latency: float) -> None:
        a = self.straggler_alpha
        self._site_latency_ewma[s] = (1 - a) * self._site_latency_ewma[s] + a * latency

    def observe_latencies(self, mask: np.ndarray, latency: np.ndarray) -> None:
        """Vectorized EWMA update for all sites selected by ``mask``."""
        a = self.straggler_alpha
        ew = self._site_latency_ewma
        ew[mask] = (1 - a) * ew[mask] + a * latency[mask]

    def _effective_power(self, power_w: np.ndarray) -> np.ndarray:
        p = power_w.copy()
        p[~self._site_alive] = 0.0
        # Stragglers: fleet-relative EWMA deweighting inside the WRR is
        # expressed to the planner as a power haircut (fewer requests
        # land). Calibration follows the paper's K1 story — the router is
        # the straggler absorber, deweighting a slow site *in proportion
        # to its observed slowdown* rather than by a fixed step: a site
        # at the 2x-fleet threshold keeps its full power (continuous at
        # the boundary, so jitter near the threshold cannot flap routing
        # weights), a site 2x past it keeps half, and the haircut floors
        # at ``straggler_min_haircut`` so a pathological site still
        # absorbs some load instead of being silently evicted. As the
        # EWMA recovers the severity falls and the haircut relaxes back
        # to 1 (tests/test_sim.py::test_router_straggler_haircut_recovers).
        ew = self._site_latency_ewma
        if ew.max() > 0:
            fleet = max(np.median(ew[ew > 0]) if (ew > 0).any() else 0.0, 1e-9)
            severity = ew / (self.straggler_threshold * fleet)
            slow = severity > 1.0
            p[slow] *= np.clip(1.0 / severity[slow],
                               self.straggler_min_haircut, 1.0)
        return p

    def _site_rate(self) -> Optional[np.ndarray]:
        """Per-site price/carbon signal for the grid objectives — the
        base router has none (None threads through the planners as the
        historical cost vector). Grid-aware subclasses override."""
        return None

    # ---------------- planning ----------------
    def step_slot(self, predicted_power_w: np.ndarray,
                  predicted_load: np.ndarray) -> Plan:
        """Run Planner-L for the next 15-min slot.

        With ``incremental=True`` (and the default decomposed method) the
        slot solve goes through a persistent ``PlannerLSession``: sites
        whose effective power moved within ``dirty_tol`` keep last slot's
        accepted assignment and only the dirty sub-fleet re-solves, with
        automatic fall-back to a full re-plan on fleet-wide shifts (see
        ``PlannerLSession`` for the dirty/fallback rules).
        """
        power = self._effective_power(predicted_power_w)
        if self.incremental and self.planner_method != "monolithic":
            if self._session is None:
                from repro_torch.core.planner_l import PlannerLSession
                self._session = PlannerLSession(
                    self.table, self.sites, objective=self.objective,
                    r_frac=self.r_frac, time_limit=self.time_limit_l,
                    workers=self.planner_workers,
                    dirty_tol=self.dirty_tol)
            p = self._session.plan(power, predicted_load)
        else:
            p = plan_l(self.table, self.sites, power, predicted_load,
                       objective=self.objective, old=self._plan_l,
                       r_frac=self.r_frac, time_limit=self.time_limit_l,
                       method=self.planner_method,
                       workers=self.planner_workers,
                       site_rate=self._site_rate())
        self._cfgtor.apply(self._plan_l, p, self._now)
        self._plan_l = p
        self._plan_s = None
        return p

    def step_seconds(self, now: float, power_w: np.ndarray,
                     observed_load: np.ndarray) -> Plan:
        """Run Planner-S against near-real-time power/load."""
        assert self._plan_l is not None, "step_slot first"
        self._now = now
        frozen = self._cfgtor.frozen(now)
        p = plan_s(self.table, self.sites, self._effective_power(power_w),
                   observed_load, self._plan_l.gpu_budget_pool(),
                   objective=self.objective, frozen_sct=frozen,
                   time_limit=self.time_limit_s, warm=self._plan_s,
                   site_rate=self._site_rate())
        if p.status != "empty":
            self._plan_s = p
        return self._plan_s or self._plan_l

    # ---------------- RoutingPolicy protocol ----------------
    @property
    def name(self) -> str:
        return "heron" if self.objective == "latency" else "heron_min_power"

    def plan_slot(self, pred_power_w: np.ndarray,
                  pred_load: np.ndarray) -> Plan:
        """RoutingPolicy entry for the Planner-L cadence: advances the
        router clock one slot per call (so Configurator re-shard freezes
        tick and expire at slot cadence instead of piling up at t=0),
        then runs ``step_slot``. External callers that drive the clock
        themselves via ``step_seconds(now=...)`` should keep calling
        ``step_slot`` directly."""
        if self._plan_l is not None:
            self._now += SLOT_SECONDS
        return self.step_slot(pred_power_w, pred_load)

    def plan_fine(self, now: float, power_w: np.ndarray,
                  observed_load: np.ndarray) -> Plan:
        """RoutingPolicy alias for ``step_seconds`` (Planner-S cadence)."""
        return self.step_seconds(now, power_w, observed_load)

    def route(self, groups, arrivals_rps: np.ndarray) -> DispatchResult:
        """Dispatch ``arrivals_rps`` over an externally-realized group
        table (the week simulator routes the brownout-shedded plan, not
        the nominal one) through the router's Request Scheduler."""
        return self._dispatcher.dispatch(groups, arrivals_rps)

    def observe(self, latency: np.ndarray,
                mask: Optional[np.ndarray] = None) -> None:
        """Feed the straggler EWMAs a fleet-relative latency signal.

        The week simulator reports each site's service-latency *inflation*
        (1.0 = nominal): structural cross-site E2E differences are
        plan-intentional and must not read as straggling, while a real
        straggler pushes its signal past ``straggler_threshold`` x the
        fleet median and earns the graded haircut.
        """
        if mask is None:
            mask = np.ones(len(self.sites), dtype=bool)
        self.observe_latencies(mask, np.asarray(latency, dtype=float))

    def on_event(self, event) -> None:
        """Consume a ScenarioEngine control event (health signals).

        ``site_down``/``site_up`` are binary site-health edges. A
        ``grid_trip`` carries the trip depth in ``value`` (fraction of
        power lost): a full trip (~1.0) means the site is dark and is
        treated as down; a partial trip is a brownout the planner already
        absorbs through the power forecast, so the site stays routable.
        ``grid_restored`` clears a full trip.
        """
        kind = getattr(event, "kind", None)
        if kind == "site_down":
            self.mark_site_down(event.site)
        elif kind == "site_up":
            self.mark_site_up(event.site)
        elif kind == "grid_trip":
            if getattr(event, "value", 1.0) >= 0.999:
                self.mark_site_down(event.site)
        elif kind == "grid_restored":
            self.mark_site_up(event.site)
        # curtailment notices: the planner already sees capped power via
        # the (announced) forecast — nothing extra to freeze here.

    # ---------------- failover ----------------
    def failover_order(self, site: int) -> list[int]:
        """Preferred landing order for work drained off a dying ``site``.

        The failover contract (honored by ``sim.cluster.ServingCluster``):
        when a site dies, its preempted transcripts are re-routed to the
        surviving sites in this order — sticky (first choice absorbs until
        it rejects), with the caller applying the per-request retry budget
        and ``serving.engine.retry_backoff`` between attempts.

        Ranking reuses the existing dispatch path's view of the world:
        surviving sites ordered by their aggregate WRR weight under the
        current plan (most provisioned spare serving capacity first), so
        failover lands where the planner already wanted load. Falls back
        to alive-sites-by-index when no plan has been solved yet.

        The aggregation runs columnar off ``plan.column_arrays()`` — a
        trip at fleet scale used to walk ``wrr_weights()``'s per-group
        python lists (every active column, dict-of-tuples) just to sum
        per-site weights the arrays give in one ``bincount``.
        """
        S = len(self.sites)
        alive = self._site_alive.copy()
        alive[site] = False
        idx = np.nonzero(alive)[0]
        plan = self._plan_s or self._plan_l
        if plan is None:
            return idx.tolist()
        c_site, c_cls, _, c_load, _, _ = plan.column_arrays()
        counts = np.asarray(plan.counts, float)
        cap = plan.capacity()
        w = counts * c_load / np.maximum(cap[c_cls], 1e-300)
        w[cap[c_cls] <= 0] = 0.0
        agg = np.bincount(c_site, weights=w, minlength=S)
        # descending weight, index ascending on ties (lexsort: last key
        # is primary) — same order the sorted(key=(-agg, s)) walk gave
        return idx[np.lexsort((idx, -agg[idx]))].tolist()

    # ---------------- dispatch ----------------
    def dispatch(self, arrivals_rps: np.ndarray) -> DispatchResult:
        plan = self._plan_s or self._plan_l
        assert plan is not None
        table = plan.group_table()            # cached columnar fast path
        res = self._dispatcher.dispatch(table, arrivals_rps)
        # feed the straggler EWMA: per-site mean group e2e (stats cached
        # on the table — they only depend on the plan)
        loaded = (res.per_site_load > 0) & (table.site_groups > 0)
        mean_e2e = table.site_e2e_sum / np.maximum(table.site_groups, 1)
        self.observe_latencies(loaded, mean_e2e)
        return res


# ------------------------------------------------------------------
# grid-interactive policies
# ------------------------------------------------------------------
@dataclass
class DRHeronPolicy(HeronRouter):
    """Heron + demand response: *acts on* the grid control signals.

    The base router treats ``CURTAILMENT`` as informational (the power
    forecast already carries the cap) and ignores price/carbon notices
    entirely. This subclass turns them into a per-site demand-response
    haircut applied on top of ``_effective_power``:

      * ``CURTAILMENT``(frac) — pre-drain to ``dr_curtail_frac`` of the
        already-capped forecast. Routing *under* the cap leaves wind
        surplus on the curtailed site, which the co-simulated
        ``BatteryBank`` charge step banks for the next trip/spike
        instead of wasting (the ROADMAP's "absorb curtailment" story);
        cleared by ``CURTAILMENT_LIFTED``.
      * ``PRICE_SPIKE``(m) / ``CARBON_RAMP``(m) — shed the site toward
        ``1/m`` of its forecast (floored at ``dr_min_keep``): a 3x price
        spike keeps a third of the load; the planner re-covers the rest
        on cheap/clean sites. Cleared by ``PRICE_NORMAL`` /
        ``CARBON_NORMAL``.

    Haircuts from concurrent signals multiply (a curtailed site in a
    price spike sheds for both); ``site == -1`` applies fleet-wide.
    """
    dr_curtail_frac: float = 0.8        # keep-fraction under curtailment
    dr_min_keep: float = 0.25           # spike-shed floor

    def __post_init__(self):
        super().__post_init__()
        S = len(self.sites)
        self._dr_curtail = np.ones(S)
        self._dr_price = np.ones(S)
        self._dr_carbon = np.ones(S)

    @property
    def name(self) -> str:
        return "dr_heron"

    def _rows(self, site: int) -> slice | int:
        return slice(None) if site < 0 else site

    def on_event(self, event) -> None:
        kind = getattr(event, "kind", None)
        rows = self._rows(getattr(event, "site", -1))
        if kind == "curtailment":
            self._dr_curtail[rows] = self.dr_curtail_frac
        elif kind == "curtailment_lifted":
            self._dr_curtail[rows] = 1.0
        elif kind == "price_spike":
            m = max(float(getattr(event, "value", 1.0)), 1.0)
            self._dr_price[rows] = max(1.0 / m, self.dr_min_keep)
        elif kind == "price_normal":
            self._dr_price[rows] = 1.0
        elif kind == "carbon_ramp":
            m = max(float(getattr(event, "value", 1.0)), 1.0)
            self._dr_carbon[rows] = max(1.0 / m, self.dr_min_keep)
        elif kind == "carbon_normal":
            self._dr_carbon[rows] = 1.0
        else:
            super().on_event(event)

    def _effective_power(self, power_w: np.ndarray) -> np.ndarray:
        p = super()._effective_power(power_w)
        return p * np.minimum(self._dr_curtail,
                              self._dr_price * self._dr_carbon)


@dataclass
class XWindPolicy(HeronRouter):
    """XWind-style cross-site price router.

    Plans under the grid ``"cost"`` objective: each site's power cost is
    scaled by the relative electricity price the control stream
    announces (``PRICE_SPIKE``/``PRICE_NORMAL``), so Planner-L/S shift
    load toward cheap sites *while still serving it* — no shedding,
    pure cross-site arbitrage. The rate vector is mean-normalized
    (``_site_rate``), so a fleet-wide spike changes nothing and only
    price *skew* moves the plan.
    """
    objective: Objective = "cost"

    def __post_init__(self):
        super().__post_init__()
        self._price = np.ones(len(self.sites))

    @property
    def name(self) -> str:
        return "xwind"

    def _site_rate(self) -> Optional[np.ndarray]:
        return self._price / max(float(self._price.mean()), 1e-9)

    def on_event(self, event) -> None:
        kind = getattr(event, "kind", None)
        site = getattr(event, "site", -1)
        rows = slice(None) if site < 0 else site
        if kind == "price_spike":
            self._price[rows] = max(float(getattr(event, "value", 1.0)),
                                    1e-3)
        elif kind == "price_normal":
            self._price[rows] = 1.0
        else:
            super().on_event(event)
