"""Million-user week co-sim — streamed trace replay driving live engines.

This is the layer that makes the rate-plane numbers mean "tokens a user
received on time": ``data.workload.stream_requests`` streams an
Azure-shaped request population (millions of users, diurnal/regional
structure, never materialized), and ``FleetServingSim`` — a
``ServingCluster`` with a *live fleet control plane* — runs one
``ServingEngine`` per site on the shared virtual clock while the
``RoutingPolicy``'s plan drives admission capacity and brownout:

  * every planning window the policy re-plans
    (``plan_slot``/``plan_fine``) on the knowledge-plane power, and the
    plan is confronted with truth-plane power via
    ``apply_power_reality`` — the power truth plane becomes per-site
    token budgets (``admit_token_budget``) and graceful-degradation
    brownout fractions (``set_brownout``) on the live engines;
  * per-request routing follows the plan's per-class WRR weights
    (deterministic credit counters, home-affinity sticky), i.e. the same
    dispatch-path view of capacity the rate simulators score;
  * scenario events hit *live* engines: a ``FaultInjector`` derived from
    the scenario's truth plane kills/restores engines (failover carries
    real transcripts down ``policy.failover_order``), control events
    reach the policy, and straggler ``latency_factor`` feeds
    ``policy.observe``.

Goodput is *SLO-attributed served tokens*: a completed request's tokens
count only when its TTFT and mean TBT (virtual-clock ticks — one tick is
one nominal token time) meet the per-class deadlines derived from the
lookup table's isolated references (``LookupTable.slos``;
``ClassSLO.ttft_deadline_ticks`` / ``tbt_deadline_ticks``). The result
also reports raw served tokens and user-visible p50/p99 TTFT/TBT/E2E
tails, and the delivery ledger's duplicated-token proof rides along from
``ServingCluster``.

Units note: the rate simulators' goodput (dispatched rps x slots) is an
*upper bound* on what this layer can attribute — the rate plane assumes
every dispatched request is served to completion, while live engines
lose in-flight work to trips and pay failover/backoff tails. The co-sim
smoke (tests/test_e2e.py) pins ``dispatched fraction >= served
fraction``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.baselines import apply_power_reality
from repro_torch.core.lookup import SLO_MULTIPLIER, LookupTable
from repro_torch.core.planner_l import SiteSpec
from repro_torch.core.router import SLOT_SECONDS
from repro_torch.data.workload import RequestChunk, WorkloadTrace, stream_requests
from repro_torch.power.grid import GridSignals
from repro_torch.serving.engine import Request
from repro_torch.sim.cluster import ServingCluster
from repro_torch.sim.faults import FaultInjector
from repro_torch.sim.scenarios import ScenarioEngine
from repro_torch.stats import finite_or, percentile


# token-length compression: streamed Azure lengths (hundreds..thousands)
# map onto smoke-engine budgets (max_seq ~ 64) by fixed divisors — the
# *shape* (class mix, tails) survives; absolute scale is the engine's
PROMPT_DIVISOR = 256.0
OUTPUT_DIVISOR = 64.0


@dataclass
class E2EResult:
    """Served-token scorecard of one fleet co-sim run."""
    name: str
    ticks: int
    offered_requests: int
    offered_tokens: int         # requested output tokens (engine scale)
    completed: int
    rejected: int
    timed_out: int
    failed: int                 # failover retry budget exhausted
    served_tokens: int          # unique delivered tokens (ledger hwm)
    slo_served_tokens: int      # ... of which met the class SLO deadlines
    slo_hits: int
    slo_misses: int
    duplicated_tokens: int      # MUST be 0
    lost_tokens: int
    preemptions: int
    resumes: int
    p50_ttft: float
    p99_ttft: float
    p50_tbt: float
    p99_tbt: float
    p50_e2e: float
    p99_e2e: float
    # grid-interactive counters: $ and gCO2 billed on the
    # realized window draws under the scenario's price/carbon planes
    cost_usd: float = 0.0
    carbon_g: float = 0.0
    # rate-plane comparison hook (filled by benchmarks): served fraction
    # of simulate_week's dispatched rps over the same scenario
    dispatched_fraction: Optional[float] = None
    faults: dict = field(default_factory=dict)
    # per-window Planner-L cost counters (solve_s / mode / dirty_sites),
    # mirroring WeekResult.planner — filled by simulate_fleet_serving
    planner: dict = field(default_factory=dict)

    @property
    def goodput_fraction(self) -> float:
        """Unique delivered tokens / requested tokens."""
        return self.served_tokens / max(self.offered_tokens, 1)

    @property
    def slo_goodput_fraction(self) -> float:
        """SLO-attributed delivered tokens / requested tokens — the
        paper-faithful 'tokens a user received on time' fraction."""
        return self.slo_served_tokens / max(self.offered_tokens, 1)

    def to_json(self) -> dict:
        d = {k: getattr(self, k) for k in (
            "name", "ticks", "offered_requests", "offered_tokens",
            "completed", "rejected", "timed_out", "failed",
            "served_tokens", "slo_served_tokens", "slo_hits", "slo_misses",
            "duplicated_tokens", "lost_tokens", "preemptions", "resumes")}
        for k in ("p50_ttft", "p99_ttft", "p50_tbt", "p99_tbt",
                  "p50_e2e", "p99_e2e"):
            d[k] = finite_or(getattr(self, k), -1.0)   # strict-JSON safe
        for k in ("cost_usd", "carbon_g"):
            d[k] = finite_or(getattr(self, k), 0.0)
        d["kind"] = "e2e"
        d["goodput_fraction"] = self.goodput_fraction
        d["slo_goodput_fraction"] = self.slo_goodput_fraction
        if self.dispatched_fraction is not None:
            d["dispatched_fraction"] = float(self.dispatched_fraction)
        d["faults"] = dict(self.faults)
        if self.planner:
            d["planner"] = dict(self.planner)
        return d


def slo_deadline_ticks(table: LookupTable) -> tuple[np.ndarray, np.ndarray]:
    """Per-class (ttft, tbt) deadlines in virtual-clock ticks.

    One engine tick is one nominal token time, so the wall-clock SLOs
    rescale by the class's isolated TBT reference (``ClassSLO``). Tables
    built before the SLO refs existed fall back to a uniform
    ``SLO_MULTIPLIER`` on both axes.
    """
    if table.slos:
        ttft = np.array([s.ttft_deadline_ticks() for s in table.slos])
        tbt = np.array([s.tbt_deadline_ticks() for s in table.slos])
    else:
        ttft = np.full(9, SLO_MULTIPLIER)
        tbt = np.full(9, SLO_MULTIPLIER)
    return ttft, tbt


class FleetServingSim(ServingCluster):
    """``ServingCluster`` + the live fleet control plane.

    Adds to the base cluster: per-class WRR routing from the current
    plan, plan-driven admission budgets/brownout, and per-request SLO
    attribution against the lookup table's class deadlines. The base
    class keeps owning failover, the delivery ledger (duplicated-token
    proof), and engine lifecycle.
    """

    def __init__(self, num_sites: int, make_engine, table: LookupTable, *,
                 policy=None, failover: bool = True, retry_budget: int = 3,
                 tick_seconds: float = 1.0):
        super().__init__(num_sites, make_engine, policy=policy,
                         failover=failover, retry_budget=retry_budget,
                         tick_seconds=tick_seconds)
        self.table = table
        self._slo_ttft, self._slo_tbt = slo_deadline_ticks(table)
        self._rid_cls: dict[int, int] = {}
        self._wrr_w = np.zeros((9, num_sites))     # class x site weights
        self._wrr_credit = np.zeros((9, num_sites))
        self.completed_tbt: list[float] = []
        self.slo_hits = 0
        self.slo_misses = 0
        self.slo_served_tokens = 0

    # ------------------------------------------------------- control plane
    def apply_plan(self, plan, realized, nominal_budget: int) -> None:
        """Push a planning window's (plan, power-realized plan) onto the
        live engines: per-class WRR weights from the realized plan's
        dispatch view, per-site brownout = realized/planned capacity, and
        admission token budgets scaled by the realized share."""
        S = self.num_sites
        planned = np.zeros(S)
        real_cap = np.zeros(S)
        for p, acc in ((plan, planned), (realized, real_cap)):
            site, _cls, _tp, load, _pow, _ = p.column_arrays()
            counts = np.asarray(p.counts, float)
            np.add.at(acc, site[: len(counts)], counts * load[: len(counts)])
        self._wrr_w[:] = 0.0
        for c, rows in realized.wrr_weights().items():
            for s, _row, w in rows:
                if s < S:
                    self._wrr_w[c, s] += w
        self._wrr_credit[:] = 0.0
        for s in range(S):
            eng = self.engines[s]
            if eng is None:
                continue
            frac = (real_cap[s] / planned[s]) if planned[s] > 1e-12 else 1.0
            eng.set_brownout(min(frac, 1.0))
            eng.admit_token_budget = max(
                1, int(round(nominal_budget * min(frac, 1.0))))

    def route_site(self, cls: int, home: int) -> int:
        """Pick the landing site for a class-``cls`` request from region
        ``home``: sticky to the home site while the plan provisions it,
        else deterministic weighted-round-robin over the plan's per-class
        weights (alive sites only), else any alive site."""
        w = self._wrr_w[cls] * self.alive
        if self.alive[home] and w[home] > 0:
            return home
        tot = float(w.sum())
        if tot <= 0:
            # plan places none of this class (or all its sites died):
            # home if alive, else first alive site
            if self.alive[home]:
                return home
            alive = np.flatnonzero(self.alive)
            return int(alive[0]) if len(alive) else home
        self._wrr_credit[cls] += w
        pick = int(np.argmax(self._wrr_credit[cls]))
        self._wrr_credit[cls, pick] -= tot
        return pick

    def submit_classed(self, req: Request, cls: int, home: int) -> bool:
        self._rid_cls[req.rid] = int(cls)
        return self.submit(req, self.route_site(cls, home))

    # ---------------------------------------------------- SLO attribution
    def _harvest(self, site: int) -> None:
        eng = self.engines[site]
        if eng is None:
            return
        done = eng.metrics.completed
        fresh = done[self._ncons[site]:]
        super()._harvest(site)
        for req in fresh:
            tbt = req.tbt
            if tbt is not None:
                self.completed_tbt.append(tbt)
            cls = self._rid_cls.get(req.rid)
            if cls is None:
                continue
            ok = True
            if req.ttft is not None and req.ttft > self._slo_ttft[cls]:
                ok = False
            if tbt is not None and tbt > self._slo_tbt[cls]:
                ok = False
            if ok:
                self.slo_hits += 1
                self.slo_served_tokens += self._hwm.get(req.rid, 0)
            else:
                self.slo_misses += 1

    # -------------------------------------------------------------- result
    def e2e_result(self, name: str, ticks: int, *, offered_requests: int,
                   offered_tokens: int,
                   faults_record: Optional[dict] = None) -> E2EResult:
        base = self.result(name, ticks, faults_record=faults_record)
        return E2EResult(
            name=name, ticks=ticks,
            offered_requests=offered_requests,
            offered_tokens=offered_tokens,
            completed=base.completed, rejected=base.rejected,
            timed_out=base.timed_out, failed=base.failed,
            served_tokens=base.served_tokens,
            slo_served_tokens=self.slo_served_tokens,
            slo_hits=self.slo_hits, slo_misses=self.slo_misses,
            duplicated_tokens=base.duplicated_tokens,
            lost_tokens=base.lost_tokens,
            preemptions=base.preemptions, resumes=base.resumes,
            p50_ttft=base.p50_ttft, p99_ttft=base.p99_ttft,
            p50_tbt=percentile(self.completed_tbt, 50),
            p99_tbt=percentile(self.completed_tbt, 99),
            p50_e2e=base.p50_e2e, p99_e2e=base.p99_e2e,
            faults=base.faults)


def _chunk_requests(ch: RequestChunk, vocab: int, max_prompt: int,
                    max_new: int, rng: np.random.Generator):
    """Materialize a streamed chunk as engine ``Request``s (token ids are
    synthetic — the smoke models are untrained; lengths carry the signal)."""
    out = []
    np_len = np.clip(np.round(ch.lin / PROMPT_DIVISOR), 1, max_prompt
                     ).astype(int)
    nt_len = np.clip(np.round(ch.lout / OUTPUT_DIVISOR), 1, max_new
                     ).astype(int)
    for i in range(len(ch)):
        prompt = rng.integers(1, vocab, size=int(np_len[i])).astype(np.int32)
        out.append((int(ch.rid[i]), int(ch.site[i]), int(ch.cls[i]),
                    Request(rid=int(ch.rid[i]), prompt=prompt,
                            max_new_tokens=int(np_len[i] + nt_len[i]),
                            temperature=0.8 if ch.rid[i] % 2 else 0.0)))
    return out


def simulate_fleet_serving(
        policy, table: LookupTable, sites: list[SiteSpec],
        power_mw: np.ndarray, make_engine, *,
        traces: Union[WorkloadTrace, Sequence[WorkloadTrace]],
        num_users: int, ticks: int, tick_seconds: float = 1.0,
        window_ticks: int = 60, plan_load_scale: float = 1.0,
        scenario: Optional[ScenarioEngine] = None, seed: int = 0,
        name: str = "e2e", failover: bool = True, retry_budget: int = 3,
        fine_ticks: int = 15,
        vocab: int = 256, max_prompt: int = 16, max_new: int = 16,
        nominal_budget: int = 64, drain_ticks: int = 512,
        power_col: int = 200, return_fleet: bool = False):
    """Drive the streamed workload through live per-site engines under
    the live fleet plan. See the module docstring for the architecture.

    ``power_mw``: [S, T] slot-granularity generation (the paper grid);
    each planning window reads column ``power_col + window`` (wrapping),
    scaled by the scenario's knowledge/truth factors at that tick.
    ``plan_load_scale`` maps the stream's observed rps into the regime
    the lookup table is calibrated for (the plan's *relative* geometry —
    WRR weights, brownout fractions — is what the engines consume, so
    the scale only needs to keep the planner away from degenerate
    all-slack or all-surplus corners).

    ``fine_ticks``: Planner-S cadence in ticks. Between slot plans the
    policy's ``plan_fine`` re-solves on the *current* knowledge-plane
    power (warm-started for Heron; the WRR baseline returns its stale
    slot plan) and the fleet re-applies weights/brownout/budgets — this
    is what lets a health-aware policy route around a mid-window trip
    instead of waiting for the next slot boundary. 0 disables.
    """
    S = len(sites)
    engine = scenario if scenario is not None else ScenarioEngine(seed=seed)
    sc = engine.compile(S, ticks)
    injector = FaultInjector.from_scenario(sc, seed=seed)
    fleet = FleetServingSim(S, make_engine, table, policy=policy,
                            failover=failover, retry_budget=retry_budget,
                            tick_seconds=tick_seconds)
    rng = np.random.default_rng(seed)
    T = power_mw.shape[1]

    duration_s = ticks * tick_seconds
    chunks = stream_requests(
        traces, num_users=num_users, num_sites=S, duration_s=duration_s,
        chunk_s=window_ticks * tick_seconds, seed=seed)

    offered_requests = 0
    offered_tokens = 0
    rates = GridSignals.flat(S, ticks)
    cost_usd = carbon_g = 0.0
    win_h = window_ticks * tick_seconds / 3600.0
    pl_solve: list = []      # per-window Planner-L wall seconds
    pl_mode: list = []       # session mode ("incremental"/"full"/"stateless")
    pl_dirty: list = []      # dirty-set size (-1 when not incremental)
    nwin = int(np.ceil(ticks / window_ticks))
    tick = 0
    for w in range(nwin):
        ch = next(chunks)
        reqs = _chunk_requests(ch, vocab, max_prompt, max_new, rng)
        offered_requests += len(reqs)
        offered_tokens += int(sum(r.max_new_tokens for *_k, r in reqs))
        # by-tick arrival buckets relative to this window
        by_tick: dict[int, list] = {}
        rel = ((ch.arrival_s - ch.start_s) // tick_seconds).astype(int)
        for i, (_rid, home, cls, req) in enumerate(reqs):
            by_tick.setdefault(int(rel[i]), []).append((home, cls, req))

        # --- plan the window on the knowledge plane ---
        col = (power_col + w) % T
        kf = sc.known_power_factor[:, min(tick, ticks - 1)]
        pred_w = power_mw[:, col] * kf * 1e6
        # observed per-class load (stream truth at this window, scaled
        # into the table's calibrated regime)
        cls_counts = np.bincount(ch.cls, minlength=9).astype(float)
        win_s = max(ch.end_s - ch.start_s, 1e-9)
        plan_load = cls_counts / win_s * plan_load_scale
        plan = policy.plan_slot(pred_w, plan_load)
        me = getattr(plan, "meta", None) or {}
        pl_solve.append(float(plan.solve_seconds))
        pl_mode.append(str(me.get("mode", "stateless")))
        pl_dirty.append(int(me.get("dirty_sites", -1)))
        actual_w = power_mw[:, col] * sc.power_factor[:, min(tick, ticks - 1)] * 1e6
        realized = apply_power_reality(plan, actual_w)
        fleet.apply_plan(plan, realized, nominal_budget)
        # bill the window's realized draw under the grid plane (flat
        # default rates x the scenario's price/carbon factors)
        t_bill = min(tick, ticks - 1)
        energy_mwh = realized.power_used() / 1e6 * win_h
        cost_usd += rates.slot_cost_usd(energy_mwh, t_bill,
                                        sc.price_factor[:, t_bill])
        carbon_g += rates.slot_carbon_g(energy_mwh, t_bill,
                                        sc.carbon_factor[:, t_bill])
        # straggler signal for next window's plan
        policy.observe(sc.latency_factor[:, min(tick, ticks - 1)])

        # --- run the window's ticks ---
        # the router's slot clock advanced SLOT_SECONDS at plan_slot;
        # fine replans ride monotonically inside that slot
        plan_base = (w + 1) * SLOT_SECONDS
        w_end = min((w + 1) * window_ticks, ticks)
        while tick < w_end:
            rel_t = tick - w * window_ticks
            for ev in sc.controls_at(tick):
                # non-health events (curtailment notices etc.) still reach
                # the policy; kill/restore edges also arrive via the
                # injector -> cluster path (idempotent on the policy side)
                policy.on_event(ev)
            if fine_ticks and rel_t and rel_t % fine_ticks == 0:
                t_idx = min(tick, ticks - 1)
                fine = policy.plan_fine(
                    plan_base + rel_t * tick_seconds,
                    power_mw[:, col] * sc.known_power_factor[:, t_idx] * 1e6,
                    plan_load)
                fine_real = apply_power_reality(
                    fine,
                    power_mw[:, col] * sc.power_factor[:, t_idx] * 1e6)
                fleet.apply_plan(fine, fine_real, nominal_budget)
            arrivals = []
            for home, cls, req in by_tick.get(rel_t, ()):
                fleet._rid_cls[req.rid] = int(cls)
                arrivals.append((fleet.route_site(cls, home), req))
            fleet.step_tick(faults=injector.faults_at(tick),
                            arrivals=arrivals)
            tick += 1

    for _ in range(drain_ticks):
        if fleet.drained():
            break
        fleet.step_tick()
    res = fleet.e2e_result(
        name, ticks, offered_requests=offered_requests,
        offered_tokens=offered_tokens,
        faults_record=injector.to_json())
    res.planner = {"solve_s": pl_solve, "mode": pl_mode,
                   "dirty_sites": pl_dirty}
    res.cost_usd = float(cost_usd)
    res.carbon_g = float(carbon_g)
    return (res, fleet) if return_fleet else res
