"""Week-long cross-site serving simulation (paper §5.2/§5.3).

Two granularities, matching the paper's evaluation methodology:

  * ``simulate_week``      — 15-min slots over 672 slots: a pluggable
    ``RoutingPolicy`` (see ``repro_torch.sim.policy``) plans each slot; goodput
    / drops / latency / power are accounted per slot. Baselines are
    power-variability agnostic, so their plans are confronted with
    reality via ``apply_power_reality`` (whole-instance brownout
    shedding) — reproducing Fig. 8/14/15.

  * ``simulate_slot_fine`` — 1-s steps inside one slot: per-second power
    and Poisson arrivals fluctuate around the slot values; Planner-S re-
    solves (f, l) every few seconds inside Planner-L's GPU budget, and the
    Request Scheduler's packing heuristic absorbs transient per-class
    overloads — reproducing Fig. 17 and the §5.3 elasticity test.

Control plane
-------------
The driver is policy/scenario-driven rather than an inlined planning
loop:

  * ``simulate_week(name_or_policy, ...)`` resolves a ``RoutingPolicy``
    through the name->factory registry (``"heron"``,
    ``"heron_min_power"``, ``"wrr_dynamollm"``, ``"greedy_min_latency"``,
    or anything added via ``register_policy``) and drives its
    plan_slot / route / observe / on_event lifecycle. For the Heron
    names this is the *actual* ``HeronRouter`` object — straggler EWMA
    haircuts and ``mark_site_down`` health replanning shape weekly
    results (the paper's K1 story), and the Configurator's re-shard
    freeze clock ticks at slot cadence (its freeze windows bind
    Planner-S via ``plan_fine``) — instead of being bypassed by a
    parallel if/elif loop. A policy *instance* is driven as configured
    (e.g. a hand-built ``HeronRouter`` keeps its ``packing=True``
    dispatch default); use the registry names for the week scoring
    convention (no packing, matching ``simulate_week_reference``).
  * disturbances come from a seeded ``ScenarioEngine``
    (``repro_torch.sim.scenarios``): site failures & recoveries, grid-trip
    power cliffs, curtailment orders, demand surges/diurnal swell,
    predictor-error regimes, straggler onset — compiled once into
    per-tick truth/knowledge factors and control events, consumed
    uniformly here and in ``simulate_slot_fine``. The default
    (event-free) scenario perturbs nothing, and the legacy scheduler
    names stay bit-identical to the pre-refactor driver (kept as
    ``simulate_week_reference``; pinned by tests/test_scenarios.py).

Fluid-flow semantics: requests are rps flows per class; queueing beyond
rated capacity accrues in a per-class fluid backlog whose Little's-law
wait adds to the table E2E. 'Goodput' is served rps (the paper's "requests
being actually served").

Fast path
---------
Both simulators run on the columnar dispatch engine (``GroupTable``):

  * the AR(1) power wiggle is generated for all sites at once with a
    first-order ``scipy.signal.lfilter`` (bit-identical to the scalar
    recursion — same draws, same order, same arithmetic);
  * ``simulate_slot_fine`` batches the seconds between two Planner-S
    re-solves: the plan — and hence the shed geometry — is constant
    inside a segment, so brownout shedding for the whole segment is one
    vectorized ``shed_counts_batch`` call and each second's dispatch is
    a cheap ``GroupTable.with_counts`` + vector dispatch (the per-second
    Python loop only threads the fluid backlog, which is inherently
    sequential);
  * each Planner-S re-solve is warm-started from the previous one
    (status ``"warm"``; ``FineResult.warm_hits`` counts them, and
    ``warm_start=False`` restores cold solves for A/B benchmarks).

Run records: ``WeekResult``/``FineResult`` round-trip through
``to_json``/``from_json``; pass ``record=`` to persist a run under
``artifacts/sim/`` (benchmarks reload records via ``load_week_result``
instead of re-simulating).
"""
from __future__ import annotations

import hashlib
import os
from collections import deque
from dataclasses import dataclass, field
from typing import Literal, Optional, Union

import numpy as np
from scipy.signal import lfilter

from repro_torch.core.baselines import (apply_power_reality,
                                  baseline_greedy_min_latency,
                                  baseline_wrr_dynamollm, shed_counts_batch)
from repro_torch.core.lookup import LookupTable
from repro_torch.core.planner_l import Method, Plan, SiteSpec, plan_l
from repro_torch.core.planner_s import plan_s
from repro_torch.core.predictor import SeriesPredictor
from repro_torch.core.scheduler import Configurator, GroupTable, RequestScheduler
from repro_torch.power.grid import BatteryBank, GridSignals
from repro_torch.stats import finite_or, percentile
from repro_torch.sim.record import load_record, write_record
from repro_torch.sim.scenarios import ScenarioEngine

SchedulerName = Literal["heron", "heron_min_power", "wrr_dynamollm",
                        "greedy_min_latency"]


@dataclass
class SlotMetrics:
    served: np.ndarray
    dropped: np.ndarray
    mean_e2e: float
    power_w: float
    solve_s: float
    reconfigs: int
    # grid-interactive counters: $ and gCO2 for the slot's
    # realized energy draw under the scenario's price/carbon planes —
    # 0.0 on pre-grid records
    cost_usd: float = 0.0
    carbon_g: float = 0.0

    @property
    def total_served(self) -> float:
        return float(self.served.sum())

    @property
    def total_dropped(self) -> float:
        return float(self.dropped.sum())

    def to_json(self) -> dict:
        return {"served": self.served.tolist(),
                "dropped": self.dropped.tolist(),
                "mean_e2e": float(self.mean_e2e),
                "power_w": float(self.power_w),
                "solve_s": float(self.solve_s),
                "reconfigs": int(self.reconfigs),
                "cost_usd": finite_or(self.cost_usd, 0.0),
                "carbon_g": finite_or(self.carbon_g, 0.0)}

    @classmethod
    def from_json(cls, d: dict) -> "SlotMetrics":
        return cls(served=np.asarray(d["served"], float),
                   dropped=np.asarray(d["dropped"], float),
                   mean_e2e=float(d["mean_e2e"]),
                   power_w=float(d["power_w"]),
                   solve_s=float(d["solve_s"]),
                   reconfigs=int(d["reconfigs"]),
                   cost_usd=float(d.get("cost_usd", 0.0)),
                   carbon_g=float(d.get("carbon_g", 0.0)))


@dataclass
class WeekResult:
    name: str
    slots: list[SlotMetrics]
    # fault/chaos counters attached by chaos-aware drivers (empty for a
    # plain week run) — round-trips through to_json/from_json
    faults: dict = field(default_factory=dict)
    # per-slot Planner-L cost counters ({"solve_s": [...], "mode": [...],
    # "dirty_sites": [...]}) so bench/co-sim runs expose planner cost
    # without a profiler; "stateless" mode / dirty -1 = plain plan_l
    planner: dict = field(default_factory=dict)

    def goodput(self) -> np.ndarray:
        return np.array([s.total_served for s in self.slots])

    def drops(self) -> np.ndarray:
        return np.array([s.total_dropped for s in self.slots])

    def slots_with_drops(self, eps: float = 1e-6) -> int:
        return int((self.drops() > eps).sum())

    def mean_e2e(self) -> np.ndarray:
        return np.array([s.mean_e2e for s in self.slots])

    def power(self) -> np.ndarray:
        return np.array([s.power_w for s in self.slots])

    def cost_usd(self) -> np.ndarray:
        return np.array([s.cost_usd for s in self.slots])

    def carbon_g(self) -> np.ndarray:
        return np.array([s.carbon_g for s in self.slots])

    def to_json(self) -> dict:
        out = {"kind": "week", "name": self.name,
               "slots": [s.to_json() for s in self.slots]}
        if self.faults:
            out["faults"] = dict(self.faults)
        if self.planner:
            out["planner"] = dict(self.planner)
        return out

    @classmethod
    def from_json(cls, d: dict) -> "WeekResult":
        return cls(name=d["name"],
                   slots=[SlotMetrics.from_json(s) for s in d["slots"]],
                   faults=dict(d.get("faults", {})),
                   planner=dict(d.get("planner", {})))


def goodput_improvement(heron: WeekResult, baseline: WeekResult) -> np.ndarray:
    """Per-slot goodput ratio (Fig. 14 middle / Fig. 15): Heron / baseline."""
    g_h, g_b = heron.goodput(), baseline.goodput()
    return g_h / np.maximum(g_b, 1e-9)


# repo root (src/repro/sim/cluster.py -> 4 levels up): record=True must
# land in the same artifacts/sim/ tree the benchmarks read regardless of
# the launch directory
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def _record_path(record: Union[str, bool], name: str, S: int, T: int,
                 seed: Optional[int], engine: ScenarioEngine,
                 power_mw: np.ndarray, arrivals_rps: np.ndarray,
                 predictor_kind: str, planner_knobs: tuple) -> str:
    if record is True:
        record = os.path.join(_REPO_ROOT, "artifacts", "sim")
    if str(record).endswith(".json"):
        return str(record)
    # distinct runs must not overwrite each other's records: the auto
    # name keys on the workload inputs (power/arrival windows, predictor,
    # planner knobs) and, when events are present, the scenario stack
    h = hashlib.md5()
    h.update(np.ascontiguousarray(power_mw).tobytes())
    h.update(np.ascontiguousarray(arrivals_rps).tobytes())
    h.update(repr((predictor_kind, planner_knobs)).encode())
    tag = f"_w{h.hexdigest()[:8]}"
    if seed is not None:
        tag += f"_seed{seed}"
    if engine.events:
        sc_digest = hashlib.md5(
            repr((engine.seed, engine.events)).encode()).hexdigest()[:8]
        tag += f"_sc{sc_digest}"
    return os.path.join(str(record), f"week_{name}_{S}sites_{T}slots{tag}.json")


def load_week_result(path: str) -> WeekResult:
    """Reload a recorded ``simulate_week`` run (see the ``record=`` knob)."""
    d = load_record(path)
    return WeekResult.from_json(d.get("result", d))


def simulate_week(scheduler, table: LookupTable,
                  sites: list[SiteSpec], power_mw: np.ndarray,
                  arrivals_rps: np.ndarray, *,
                  predictor_kind: str = "oracle", r_frac: float = 0.03,
                  time_limit: float = 20.0,
                  slots: Optional[int] = None,
                  planner_method: Method = "auto",
                  planner_workers: Optional[int] = None,
                  incremental: bool = False, dirty_tol: float = 0.02,
                  scenario: Optional[ScenarioEngine] = None,
                  seed: Optional[int] = None,
                  grid: Optional[GridSignals] = None,
                  battery: Optional[BatteryBank] = None,
                  record: Union[str, bool, None] = None) -> WeekResult:
    """Slot-level week simulation, driven by a pluggable RoutingPolicy.

    ``scheduler``: a registered policy name (see
    ``repro_torch.sim.policy.list_policies``) or a ``RoutingPolicy`` instance.
    ``power_mw``: [S, T] available generation per site; arrivals_rps:
    [9, T]. The site's usable power is min(generation, provisioned
    demand) — the provisioned hardware cap is already expressed by the
    GPU constraint. ``planner_method``/``planner_workers`` select the
    Planner-L solve path for the Heron policies ("auto" = the
    drain-priced decomposition at every fleet size; "monolithic" = the
    exact reference) and the site-ILP pool size.
    ``incremental``/``dirty_tol`` route Heron slot re-plans through a
    persistent ``PlannerLSession`` (dirty-site incremental path).

    ``scenario`` perturbs per-slot truth and emits control events
    (``repro_torch.sim.scenarios``); ``seed`` makes the whole run reproducible
    (it seeds the default scenario — pass an explicitly-seeded engine to
    combine both). ``record`` persists the result as a JSON run record:
    ``True`` -> artifacts/sim/, a directory, or a full ``.json`` path.

    Grid plane: ``grid`` supplies per-site price/carbon base
    curves (defaults to flat wind-node rates) and every slot's realized
    energy draw is billed into ``SlotMetrics.cost_usd``/``carbon_g``
    under the scenario's price/carbon factors. ``battery`` co-simulates
    a per-site ``BatteryBank``: surplus wind (generation beyond the
    realized plan draw) charges it; when truth power falls short of the
    planned draw it discharges to ride through, and the *knowledge*
    plane credits each site's sustainable ride-through power on top of
    the forecast so the planner keeps assigning a battery-backed site
    through a trip. The bank passed in is copied (a run never mutates
    the caller's state) and follows the scenario's ``battery_health``
    derating trace.
    """
    S, T = power_mw.shape
    T = min(T, arrivals_rps.shape[1]) if slots is None else min(slots, T)

    engine = scenario if scenario is not None else ScenarioEngine(seed=seed)
    sc = engine.compile(S, T)

    if isinstance(scheduler, str):
        from repro_torch.sim.policy import make_policy
        policy = make_policy(scheduler, table, sites, r_frac=r_frac,
                             time_limit=time_limit,
                             planner_method=planner_method,
                             planner_workers=planner_workers,
                             incremental=incremental, dirty_tol=dirty_tol)
        name = scheduler
    else:
        policy = scheduler
        name = getattr(scheduler, "name", type(scheduler).__name__)

    # knowledge plane: the forecast pipeline's view of the power series
    # (full-length so predictor clamping sees the same range as truth)
    known_power = power_mw.astype(float).copy()
    known_power[:, :T] *= sc.known_power_factor
    predictors = [SeriesPredictor(known_power[s], kind=predictor_kind)
                  for s in range(S)]

    old: Optional[Plan] = None
    cfgtor = Configurator()
    out: list[SlotMetrics] = []
    pl_solve: list[float] = []
    pl_mode: list[str] = []
    pl_dirty: list[int] = []
    # grid plane: flat default rates when no curves are supplied, so
    # cost/carbon counters are always populated (uniform rates cannot
    # change any plan — they only meter it)
    rates = grid if grid is not None else GridSignals.flat(S, T)
    bank = battery.copy() if battery is not None else None
    prev_draw_w = np.zeros(S)
    dt_h = 0.25                     # one 15-min slot in hours
    for t in range(T):
        for ev in sc.controls_at(t):
            policy.on_event(ev)
        actual_w = power_mw[:, t] * sc.power_factor[:, t] * 1e6
        pred_w = np.array([p.predict(t) for p in predictors]) * 1e6
        noise = sc.pred_noise[:, t]
        if (noise != 1.0).any():
            pred_w = pred_w * noise
        if bank is not None:
            # knowledge plane: the BMS knows its state of charge — the
            # forecast credits each site with the ride-through power the
            # bank can sustain toward holding the previous draw level
            bank.set_health(sc.battery_health[:, t])
            ride_w = bank.ride_through_mw(dt_h) * 1e6
            pred_w = pred_w + np.minimum(
                ride_w, np.maximum(prev_draw_w - pred_w, 0.0))
        loads_known = arrivals_rps[:, t] * sc.known_arrival_factor[:, t]
        loads_true = arrivals_rps[:, t] * sc.arrival_factor[:, t]

        p = policy.plan_slot(pred_w, loads_known)
        me = getattr(p, "meta", None) or {}
        pl_solve.append(float(p.solve_seconds))
        pl_mode.append(str(me.get("mode", "stateless")))
        pl_dirty.append(int(me.get("dirty_sites", -1)))
        reconfigs = cfgtor.reconfig_count(old, p)
        old = p
        # reality: any plan drawing beyond actual generation browns out
        # — unless the site's battery bridges the deficit (and surplus
        # wind the plan leaves unused charges it)
        avail_w = actual_w
        if bank is not None:
            delivered_mw = bank.step(actual_w / 1e6,
                                     p.power_used() / 1e6, dt_h)
            avail_w = actual_w + delivered_mw * 1e6
        real = apply_power_reality(p, avail_w)
        gtable = real.group_table()
        res = policy.route(gtable, loads_true)
        # observed service latency: per-site inflation (1.0 = nominal) —
        # the straggler signal; feeds the policy for the *next* slot
        lat = sc.latency_factor[:, t]
        mean_e2e = res.aggregate_e2e()
        if (lat != 1.0).any():
            w = res.per_site_load
            tot = float(w.sum())
            if tot > 0:
                mean_e2e *= float((w * lat).sum() / tot)
        policy.observe(lat)
        # bill the slot's realized per-site draw under the scenario's
        # price/carbon factors (truth plane)
        site_draw_w = real.power_used()
        energy_mwh = site_draw_w / 1e6 * dt_h
        prev_draw_w = site_draw_w
        out.append(SlotMetrics(served=res.served, dropped=res.dropped,
                               mean_e2e=mean_e2e,
                               power_w=gtable.total_power(),
                               solve_s=p.solve_seconds, reconfigs=reconfigs,
                               cost_usd=rates.slot_cost_usd(
                                   energy_mwh, t, sc.price_factor[:, t]),
                               carbon_g=rates.slot_carbon_g(
                                   energy_mwh, t, sc.carbon_factor[:, t])))
    # flush controls scheduled at/beyond the horizon (e.g. a recovery
    # landing exactly on the boundary) so a reused policy ends consistent
    for ev in sc.controls_after(T):
        policy.on_event(ev)
    wk = WeekResult(name=name, slots=out,
                    planner={"solve_s": pl_solve, "mode": pl_mode,
                             "dirty_sites": pl_dirty})
    if record:
        # the seed kwarg is inoperative when an explicit scenario is
        # passed (the engine carries its own) — keep it out of the auto
        # filename so identical runs map to one record
        tag_seed = seed if scenario is None else None
        knobs = (r_frac, time_limit, planner_method, planner_workers)
        if grid is not None or battery is not None:
            # grid-plane runs key their own records; plain runs keep the
            # historical knob tuple (existing records stay addressable)
            knobs = knobs + ("grid", grid is not None, battery is not None)
        write_record(_record_path(record, name, S, T, tag_seed, engine,
                                  power_mw[:, :T], arrivals_rps[:, :T],
                                  predictor_kind, knobs),
                     {"policy": name, "seed": engine.seed,
                      "scenario": repr(engine),
                      "predictor_kind": predictor_kind,
                      "result": wk.to_json()})
    return wk


def simulate_week_reference(scheduler: SchedulerName, table: LookupTable,
                            sites: list[SiteSpec], power_mw: np.ndarray,
                            arrivals_rps: np.ndarray, *,
                            predictor_kind: str = "oracle",
                            r_frac: float = 0.03,
                            time_limit: float = 20.0,
                            slots: Optional[int] = None,
                            planner_method: Method = "auto",
                            planner_workers: Optional[int] = None) -> WeekResult:
    """Pre-refactor inlined driver, kept verbatim as the equivalence
    oracle: the policy-driven ``simulate_week`` must reproduce it
    bit-identically for the four legacy scheduler names under the
    default (event-free) scenario (tests/test_scenarios.py)."""
    S, T = power_mw.shape
    T = min(T, arrivals_rps.shape[1]) if slots is None else min(slots, T)
    dispatcher = RequestScheduler(S, packing=False)
    predictors = [SeriesPredictor(power_mw[s], kind=predictor_kind)
                  for s in range(S)]
    old: Optional[Plan] = None
    cfgtor = Configurator()
    out: list[SlotMetrics] = []
    for t in range(T):
        actual_w = power_mw[:, t] * 1e6
        pred_w = np.array([p.predict(t) for p in predictors]) * 1e6
        loads = arrivals_rps[:, t]
        if scheduler == "heron":
            p = plan_l(table, sites, pred_w, loads, objective="latency",
                       old=old, r_frac=r_frac, time_limit=time_limit,
                       method=planner_method, workers=planner_workers)
        elif scheduler == "heron_min_power":
            p = plan_l(table, sites, pred_w, loads, objective="power",
                       old=old, r_frac=r_frac, time_limit=time_limit,
                       method=planner_method, workers=planner_workers)
        elif scheduler == "wrr_dynamollm":
            p = baseline_wrr_dynamollm(table, sites, loads,
                                       time_limit=time_limit)
        elif scheduler == "greedy_min_latency":
            p = baseline_greedy_min_latency(table, sites, loads)
        else:
            raise ValueError(scheduler)
        reconfigs = cfgtor.reconfig_count(old, p)
        old = p
        real = apply_power_reality(p, actual_w)
        gtable = real.group_table()
        res = dispatcher.dispatch(gtable, loads)
        out.append(SlotMetrics(served=res.served, dropped=res.dropped,
                               mean_e2e=res.aggregate_e2e(),
                               power_w=gtable.total_power(),
                               solve_s=p.solve_seconds, reconfigs=reconfigs))
    return WeekResult(name=scheduler, slots=out)


def ar1_wiggle(rng: np.random.Generator, num_sites: int, seconds: int,
               noise: float, phi: float = 0.995) -> np.ndarray:
    """[S, seconds] AR(1) log-wiggle, variance-matched to ``noise``.

    Vectorized over sites and time with a first-order linear filter;
    draws (and results) are identical to the scalar recursion
    ``w[t] = phi*w[t-1] + sig*eps[t]`` with row-major eps draws.
    """
    wig = np.zeros((num_sites, seconds))
    if seconds > 1:
        sig = noise * np.sqrt(1 - phi * phi)
        eps = rng.standard_normal((num_sites, seconds - 1))
        wig[:, 1:] = lfilter([sig], [1.0, -phi], eps, axis=1)
    return wig


# ------------------------------------------------------------------
# fine-grained (1 s) slot simulation — Planner-S + packing (Fig. 17)
# ------------------------------------------------------------------
@dataclass
class FineResult:
    e2e_per_second: dict[str, np.ndarray]       # variant -> [seconds]
    dropped: dict[str, float]                   # variant -> total dropped rps
    class_e2e: dict[str, np.ndarray]            # variant -> [9] mean e2e
    planner_s_solves: list[float] = field(default_factory=list)
    planner_s_status: list[str] = field(default_factory=list)
    # fault/chaos counters (empty for an undisturbed run)
    faults: dict = field(default_factory=dict)

    @property
    def warm_hits(self) -> int:
        """How many Planner-S re-solves the warm path absorbed."""
        return sum(1 for s in self.planner_s_status if s == "warm")

    def to_json(self) -> dict:
        out = {"kind": "fine",
               "e2e_per_second": {k: v.tolist()
                                  for k, v in self.e2e_per_second.items()},
               "dropped": {k: float(v) for k, v in self.dropped.items()},
               "class_e2e": {k: v.tolist()
                             for k, v in self.class_e2e.items()},
               "planner_s_solves": [float(s) for s in self.planner_s_solves],
               "planner_s_status": list(self.planner_s_status)}
        if self.faults:
            out["faults"] = dict(self.faults)
        return out

    @classmethod
    def from_json(cls, d: dict) -> "FineResult":
        return cls(e2e_per_second={k: np.asarray(v, float)
                                   for k, v in d["e2e_per_second"].items()},
                   dropped={k: float(v) for k, v in d["dropped"].items()},
                   class_e2e={k: np.asarray(v, float)
                              for k, v in d["class_e2e"].items()},
                   planner_s_solves=list(d.get("planner_s_solves", [])),
                   planner_s_status=list(d.get("planner_s_status", [])),
                   faults=dict(d.get("faults", {})))


def simulate_slot_fine(table: LookupTable, sites: list[SiteSpec],
                       base_plan: Plan, power_w_slot: np.ndarray,
                       arrivals_rps: np.ndarray, *, seconds: int = 900,
                       planner_s_period: float = 5.0,
                       power_noise: float = 0.04,
                       power_scale: float = 1.0,
                       variants=("L", "L+S", "L+S+pack"),
                       seed: int = 0, warm_start: bool = True,
                       scenario: Optional[ScenarioEngine] = None) -> FineResult:
    """Second-level simulation of one 15-min slot.

    Power per second follows an AR(1) wiggle (±power_noise) around
    ``power_scale`` × the slot value; arrivals are Poisson per second.
    Variants: 'L' follows Planner-L blindly; 'L+S' re-solves (f, l) every
    ``planner_s_period`` s at observed load/power; '+pack' adds the
    Request Scheduler packing heuristic.

    ``scenario`` injects second-granularity disturbances through the
    same engine the week simulator uses (tick = 1 s here): grid trips /
    curtailment scale per-second power, demand surges scale the Poisson
    intensities, and a ``PowerWiggle`` event overrides the AR(1)
    parameters. The default (no scenario) path is bit-identical to the
    historical hardcoded AR(1)-only disturbance model.

    Scenarios thread BOTH planes at second granularity: Planner-S plans
    on the *knowledge* power (``known_power_factor`` — a surprise
    ``GridTrip`` is invisible to the re-solve until its detection lag
    elapses) with sites zeroed once the scenario's control stream marks
    them down (``site_down`` / full-depth ``grid_trip``), while brownout
    shedding always confronts the plan with *truth* power. Per-site
    ``latency_factor`` inflates the service component of E2E (not the
    queueing wait) weighted by where the dispatch actually landed load —
    so a mid-slot trip shows second-granularity detection dynamics and a
    straggler site drags exactly the seconds it serves.

    The Planner-L GPU grant is pulled once as a columnar ``GpuBudget``
    and each Planner-S re-solve is warm-started from the previous one
    (``warm_start=False`` restores cold solves — the knob
    benchmarks/bench_planning.py measures).
    """
    rng = np.random.default_rng(seed)
    S = len(sites)
    gpu_budget = base_plan.gpu_budget_pool()
    period = max(float(planner_s_period), 1.0)
    # per-second power: AR(1) multiplicative wiggle (vectorized)
    wig_ev = scenario.fine_wiggle() if scenario is not None else None
    if wig_ev is not None:
        wig = ar1_wiggle(rng, S, seconds, wig_ev.noise, wig_ev.phi)
    else:
        wig = ar1_wiggle(rng, S, seconds, power_noise)
    pw = power_w_slot[:, None] * power_scale * np.exp(wig)
    lam = np.maximum(arrivals_rps, 0)[:, None]
    known_pw = pw                   # knowledge plane == truth by default
    lat_f = None                    # [S, seconds] latency inflation
    sc = None
    if scenario is not None:
        sc = scenario.compile(S, seconds)
        if not sc.is_trivial:       # trivial scenario keeps the exact
            known_pw = pw * sc.known_power_factor
            pw = pw * sc.power_factor   # historical arrays (bit-compat)
            lam = lam * sc.arrival_factor
            if (sc.latency_factor != 1.0).any():
                lat_f = sc.latency_factor
        else:
            sc = None
    arr = rng.poisson(lam, size=(9, seconds)).astype(float)
    # ticks where a control RESTORES a site: event-driven Planner-S
    # re-solve points. Without these, a site coming back mid-segment sits
    # idle until the cadence's next multiple-of-period solve — the L+S
    # recovery lag the goodput regression pins.
    restore_ticks: list[int] = []
    if sc is not None:
        restore_ticks = sorted(
            tk for tk, evs in sc.controls.items()
            if any(e.kind in ("site_up", "grid_restored") for e in evs))

    def _apply_controls(alive: np.ndarray, tick: int) -> None:
        """Second-granularity site-health edges for the Planner-S view
        (mirrors HeronRouter.on_event's health semantics)."""
        for ev in sc.controls_at(tick):
            if ev.kind == "site_down" or (
                    ev.kind == "grid_trip" and ev.value >= 0.999):
                alive[ev.site] = False
            elif ev.kind in ("site_up", "grid_restored"):
                alive[ev.site] = True

    results_e2e = {}
    results_drop = {}
    results_cls = {}
    solves = []
    statuses = []
    for variant in variants:
        packing = variant.endswith("pack")
        use_s = variant != "L"
        dispatcher = RequestScheduler(S, packing=packing)
        backlog = np.zeros(9)
        e2e_series = np.zeros(seconds)
        cls_num = np.zeros(9)
        cls_den = np.zeros(9)
        dropped_total = 0.0
        plan = base_plan
        prev_s: Optional[Plan] = None
        alive = np.ones(S, bool)    # control-stream site health (per variant)
        t = 0
        while t < seconds:
            if sc is not None:
                _apply_controls(alive, t)
            if use_s:
                obs_load = arr[:, max(0, t - 5): t + 1].mean(axis=1)
                # plan on the KNOWLEDGE plane: what telemetry/forecasts
                # can see at second t, with control-confirmed dead sites
                # zeroed — truth hits via shedding below
                plan_pw = known_pw[:, t]
                if not alive.all():
                    plan_pw = plan_pw * alive
                # plan for a small headroom over observed load
                p = plan_s(table, sites, plan_pw, obs_load * 1.1,
                           gpu_budget, objective=base_plan.objective,
                           warm=prev_s if warm_start else None)
                if p.status != "empty":
                    plan = p
                    prev_s = p
                    solves.append(p.solve_seconds)
                    statuses.append(p.status)
                # next re-solve at the next multiple of the period — or at
                # the next restore edge, whichever lands first: the next
                # iteration then re-solves AT the restore with ``alive``
                # freshly updated instead of waiting out the cadence
                next_solve = (np.floor(t / period) + 1) * period
                t_end = min(seconds, int(np.ceil(next_solve)))
                for rt in restore_ticks:
                    if t < rt < t_end:
                        t_end = rt
                        break
            else:
                t_end = seconds
            # ---- segment [t, t_end): the plan (and shed geometry) is
            # constant, so brown out the whole segment in one shot ----
            seg_counts = shed_counts_batch(plan, pw[:, t:t_end])
            gtable = GroupTable.from_plan(plan, active_only=False)
            for tt in range(t, t_end):
                if sc is not None and tt > t:
                    # mid-segment control edges update health for the
                    # NEXT re-solve (detection → next Planner-S pass)
                    _apply_controls(alive, tt)
                tbl = gtable.with_counts(seg_counts[:, tt - t])
                demand = arr[:, tt] + backlog
                res = dispatcher.dispatch(tbl, demand)
                cap = np.bincount(tbl.cls, weights=tbl.capacity, minlength=9)
                # fluid backlog: what was neither served nor dropped waits
                backlog = np.maximum(demand - res.served - res.dropped, 0.0)
                # cap the queue at 2x/s of capacity; beyond that it drops
                overflow = np.maximum(backlog - 2.0 * cap, 0.0)
                backlog -= overflow
                drop = res.dropped + overflow
                dropped_total += float(drop.sum())
                wait = np.where(cap > 0, backlog / np.maximum(cap, 1e-9), 0.0)
                svc = res.mean_e2e
                if lat_f is not None and (lat_f[:, tt] != 1.0).any():
                    # stragglers inflate SERVICE time (not queueing),
                    # weighted by where this second's load actually went
                    w_site = res.per_site_load
                    tot = float(w_site.sum())
                    if tot > 0:
                        svc = svc * float(
                            (w_site * lat_f[:, tt]).sum() / tot)
                e2e_c = svc + wait
                m = res.served > 0
                e2e_series[tt] = (float((e2e_c[m] * res.served[m]).sum()
                                        / res.served[m].sum()) if m.any() else 0.0)
                cls_num += e2e_c * res.served
                cls_den += res.served
            t = t_end
        results_e2e[variant] = e2e_series
        results_drop[variant] = dropped_total
        results_cls[variant] = cls_num / np.maximum(cls_den, 1e-9)
    return FineResult(e2e_per_second=results_e2e, dropped=results_drop,
                      class_e2e=results_cls, planner_s_solves=solves,
                      planner_s_status=statuses)


# ------------------------------------------------------------------
# engine-level chaos: live ServingEngines under a FaultInjector
# ------------------------------------------------------------------
# shared percentile helper (core.stats): empty samples report NaN so a
# site that served nothing during a trip cannot fake a perfect tail
_pctl = percentile


@dataclass
class ChaosResult:
    """Outcome of a ``simulate_serving_chaos`` run — the resilience
    scorecard ``benchmarks/bench_resilience.py`` compares variants on."""
    name: str
    ticks: int
    completed: int
    failed: int                 # permanent failures (retry budget spent)
    timed_out: int
    rejected: int
    preemptions: int
    resumes: int
    served_tokens: int          # unique delivered tokens over completed rids
    recovered_tokens: int       # tokens carried across preempt->resume
    lost_tokens: int            # tokens generated but never delivered
    duplicated_tokens: int      # MUST be 0 — resume behind the stream
    p50_ttft: float
    p99_ttft: float
    p50_e2e: float
    p99_e2e: float
    faults: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        d = {k: getattr(self, k) for k in (
            "name", "ticks", "completed", "failed", "timed_out", "rejected",
            "preemptions", "resumes", "served_tokens", "recovered_tokens",
            "lost_tokens", "duplicated_tokens",
            "p50_ttft", "p99_ttft", "p50_e2e", "p99_e2e")}
        d["kind"] = "chaos"
        d["faults"] = dict(self.faults)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ChaosResult":
        kw = {k: d[k] for k in (
            "name", "ticks", "completed", "failed", "timed_out", "rejected",
            "preemptions", "resumes", "served_tokens", "recovered_tokens",
            "lost_tokens", "duplicated_tokens",
            "p50_ttft", "p99_ttft", "p50_e2e", "p99_e2e")}
        return cls(faults=dict(d.get("faults", {})), **kw)


class ServingCluster:
    """Live ``ServingEngine``s at every site + the cross-site failover
    layer — where the control plane's fault story meets real tokens.

    ``make_engine(site, clock) -> ServingEngine`` builds a site's engine
    on the cluster's shared *virtual* clock (one tick = ``tick_seconds``),
    so TTFT/E2E are deterministic simulated seconds, not wall time.

    Failover contract (see ``core.router`` docstring): on a ``kill``
    fault the dying site's engine is drained into transcript snapshots;
    with ``failover=True`` each snapshot is re-admitted sticky-first down
    ``policy.failover_order(site)`` (alive-sites-by-index without a
    policy), spending a per-snapshot retry budget with
    ``serving.engine.retry_backoff`` pacing re-attempts; a snapshot that
    exhausts the budget is a permanent failure. With ``failover=False``
    (the blind baseline) drained work is simply lost. New arrivals
    redirect off dead sites in both modes, so a resilience A/B isolates
    exactly the in-flight recovery path.

    Delivery ledger: per-rid high-water marks of tokens already streamed
    to the user catch *duplicated* tokens — a resume that restarts behind
    its own stream re-emits tokens, which the keyed sampling scheme makes
    impossible by construction; the ledger is the run-time proof.
    """

    def __init__(self, num_sites: int, make_engine, *, policy=None,
                 failover: bool = True, retry_budget: int = 3,
                 tick_seconds: float = 1.0):
        self.num_sites = num_sites
        self.policy = policy
        self.failover = failover
        self.retry_budget = retry_budget
        self.tick_seconds = float(tick_seconds)
        self.now = 0.0
        self._make_engine = make_engine
        self.engines = [make_engine(s, self._clock) for s in range(num_sites)]
        self.alive = np.ones(num_sites, bool)
        self.read_power = np.ones(num_sites)   # corruptible telemetry
        self._delayed: set = set()             # sites stalled this tick
        self._dropping: set = set()            # sites not admitting this tick
        self._ncons = [0] * num_sites          # completed-harvest cursors
        self._graveyard: list = []             # metrics of replaced engines
        self._hwm: dict[int, int] = {}         # rid -> delivered high-water
        self._done_rids: set = set()
        self.pending: list = []                # [snap, next_try_s] awaiting slot
        self.failed: list = []                 # permanently failed snapshots
        self.completed_ttft: list = []
        self.completed_e2e: list = []
        self.duplicated_tokens = 0
        self.lost_tokens = 0                   # cluster-level (failed snaps)
        self.fault_counts: dict[str, int] = {}

    def _clock(self) -> float:
        return self.now

    # ------------------------------------------------------------ routing
    def _order_from(self, site: int) -> list[int]:
        """Failover landing order off ``site`` — the policy's view when it
        has one (``failover_order``), else alive sites by index."""
        fo = getattr(self.policy, "failover_order", None)
        if fo is not None:
            order = [s for s in fo(site)
                     if s < self.num_sites and self.alive[s]]
            # policy may not know about every dead/alive edge we've seen
            rest = [s for s in range(self.num_sites)
                    if self.alive[s] and s != site and s not in order]
            return order + rest
        return [s for s in range(self.num_sites)
                if self.alive[s] and s != site]

    def submit(self, req, site: int) -> bool:
        """Submit a fresh request to ``site``, redirecting down the
        failover order when the site is dead or its watermark rejects."""
        candidates = ([site] if self.alive[site] else []) \
            + self._order_from(site)
        for s in candidates:
            if self.engines[s] is not None and self.engines[s].submit(req):
                return True
        return False

    # ------------------------------------------------------------- faults
    def apply_fault(self, f) -> None:
        from repro_torch.sim import faults as F
        self.fault_counts[f.kind] = self.fault_counts.get(f.kind, 0) + 1
        if f.kind == F.KILL:
            self.kill(f.site)
        elif f.kind == F.RESTORE:
            self.restore(f.site)
        elif f.kind == F.DELAY:
            self._delayed.add(f.site)
        elif f.kind == F.DROP_ADMISSION:
            self._dropping.add(f.site)
        elif f.kind == F.CORRUPT_POWER:
            self.read_power[f.site] = f.value
        else:
            raise ValueError(f"unknown fault kind {f.kind!r}")

    def kill(self, site: int) -> None:
        """Site loses power mid-decode: drain the engine, hand the
        transcripts to failover (or lose them, blind mode)."""
        if not self.alive[site] or self.engines[site] is None:
            return
        eng = self.engines[site]
        self._harvest(site)
        snaps = eng.drain()
        self.alive[site] = False
        if self.policy is not None:
            from repro_torch.sim.scenarios import ControlEvent
            self.policy.on_event(ControlEvent(kind="site_down", site=site))
        self._graveyard.append(eng.metrics)
        self.engines[site] = None
        self._ncons[site] = 0
        if self.failover:
            for snap in snaps:
                self._place(snap, from_site=site)
        else:
            for snap in snaps:
                self.lost_tokens += len(snap.tokens)
                self.failed.append(snap)

    def restore(self, site: int) -> None:
        if self.alive[site]:
            return
        self.engines[site] = self._make_engine(site, self._clock)
        self.alive[site] = True
        self.read_power[site] = 1.0
        if self.policy is not None:
            from repro_torch.sim.scenarios import ControlEvent
            self.policy.on_event(ControlEvent(kind="site_up", site=site))

    # ----------------------------------------------------------- failover
    def _place(self, snap, from_site: int) -> None:
        """Sticky re-route: first surviving site in the failover order
        that accepts wins; a snapshot nobody accepts waits out a capped
        exponential backoff before the next attempt; the retry budget
        bounds total attempts, after which the request permanently fails
        (and its generated-but-undelivered tokens count as lost)."""
        from repro_torch.serving.engine import retry_backoff
        snap.attempts += 1
        if snap.attempts > self.retry_budget:
            self.lost_tokens += len(snap.tokens)
            self.failed.append(snap)
            return
        for s in self._order_from(from_site):
            eng = self.engines[s]
            if eng is None:
                continue
            # duplicated-token check BEFORE resuming: resuming below the
            # delivered high-water mark would re-emit tokens
            hwm = self._hwm.get(snap.rid, 0)
            req = eng.resume(
                snap, not_before_s=self.now + retry_backoff(snap.attempts))
            if req is not None:
                self.duplicated_tokens += max(0, hwm - len(snap.tokens))
                return
        # nowhere to land right now — retry after backoff
        self.pending.append([snap, self.now + retry_backoff(snap.attempts)])

    def _retry_pending(self) -> None:
        due = [p for p in self.pending if p[1] <= self.now]
        if not due:
            return
        self.pending = [p for p in self.pending if p[1] > self.now]
        for snap, _ in due:
            self._place(snap, from_site=-1)

    # ------------------------------------------------------------ stepping
    def _harvest(self, site: int) -> None:
        """Pull newly-completed requests into the delivery ledger."""
        eng = self.engines[site]
        if eng is None:
            return
        done = eng.metrics.completed
        for req in done[self._ncons[site]:]:
            n = len(req.tokens)
            hwm = self._hwm.get(req.rid, 0)
            self._hwm[req.rid] = max(hwm, n)
            self._done_rids.add(req.rid)
            if req.ttft is not None:
                self.completed_ttft.append(req.ttft)
            if req.e2e is not None:
                self.completed_e2e.append(req.e2e)
        self._ncons[site] = len(done)

    def step_tick(self, faults=(), arrivals=()) -> None:
        """One cluster tick: faults land, pending failovers retry, this
        tick's arrivals submit, every live site steps once (unless
        delayed), the delivery ledger harvests completions, the virtual
        clock advances."""
        self._delayed.clear()
        self._dropping.clear()
        for f in faults:
            self.apply_fault(f)
        self._retry_pending()
        for site, req in arrivals:
            req.arrival_s = self.now
            self.submit(req, site)
        for s in range(self.num_sites):
            eng = self.engines[s]
            if eng is None or s in self._delayed:
                continue                     # stalled: live requests wait
            if s in self._dropping:
                held = eng.waiting           # admission frozen this tick
                eng.waiting = deque()
                try:
                    eng.step()
                finally:
                    # held requests keep their queue position; anything an
                    # error path requeued lands behind them
                    leftover = eng.waiting
                    eng.waiting = held
                    eng.waiting.extend(leftover)
            else:
                eng.step()
            self._harvest(s)
        self.now += self.tick_seconds

    def drained(self) -> bool:
        return (not self.pending
                and all(e is None or (not e.waiting
                                      and not any(e.active))
                        for e in self.engines))

    # ------------------------------------------------------------- result
    def result(self, name: str, ticks: int,
               faults_record: Optional[dict] = None) -> ChaosResult:
        for s in range(self.num_sites):
            self._harvest(s)
        metrics = list(self._graveyard) + [e.metrics for e in self.engines
                                           if e is not None]
        agg = lambda attr: int(sum(getattr(m, attr) for m in metrics))
        served = int(sum(self._hwm[r] for r in self._done_rids))
        rec = {"counts": dict(self.fault_counts)}
        if faults_record:
            rec.update(faults_record)
        return ChaosResult(
            name=name, ticks=ticks,
            completed=len(self._done_rids),
            failed=len(self.failed),
            timed_out=int(sum(len(m.timed_out) for m in metrics)),
            rejected=int(sum(len(m.rejected) for m in metrics)),
            preemptions=agg("preemptions"),
            resumes=agg("resumed"),
            served_tokens=served,
            recovered_tokens=agg("recovered_tokens"),
            lost_tokens=self.lost_tokens + agg("lost_tokens"),
            duplicated_tokens=self.duplicated_tokens
            + agg("duplicated_tokens"),
            p50_ttft=_pctl(self.completed_ttft, 50),
            p99_ttft=_pctl(self.completed_ttft, 99),
            p50_e2e=_pctl(self.completed_e2e, 50),
            p99_e2e=_pctl(self.completed_e2e, 99),
            faults=rec)


def simulate_serving_chaos(num_sites: int, make_engine, requests,
                           injector=None, *, name: str = "chaos",
                           policy=None, failover: bool = True,
                           retry_budget: int = 3, ticks: int = 64,
                           drain_ticks: int = 512,
                           tick_seconds: float = 1.0) -> ChaosResult:
    """Drive live engines through a faulted request timeline.

    ``requests``: [(tick, site, Request)] arrivals; ``injector``: a
    ``sim.faults.FaultInjector`` (None = fault-free). After ``ticks``
    scripted ticks the cluster keeps stepping (fault-free) up to
    ``drain_ticks`` more to let surviving work finish — goodput then
    reflects what the fleet actually delivered, not where the horizon
    happened to fall.
    """
    cluster = ServingCluster(num_sites, make_engine, policy=policy,
                             failover=failover, retry_budget=retry_budget,
                             tick_seconds=tick_seconds)
    by_tick: dict[int, list] = {}
    for tick, site, req in requests:
        by_tick.setdefault(int(tick), []).append((site, req))
    for t in range(ticks):
        faults = injector.faults_at(t) if injector is not None else ()
        cluster.step_tick(faults=faults, arrivals=by_tick.get(t, ()))
    for _ in range(drain_ticks):
        if cluster.drained():
            break
        cluster.step_tick()
    return cluster.result(
        name, ticks,
        faults_record=(injector.to_json() if injector is not None else None))
