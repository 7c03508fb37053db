"""ScenarioEngine — composable, seeded disturbance events for the simulators.

The paper evaluates Heron against power variability that is *already in
the wind traces*; everything beyond that (site failures, grid trips,
curtailment orders, demand surges, straggler onset, predictor error) used
to be out of reach because ``simulate_week`` hardcoded its disturbance
model. This module makes the disturbance model a value: a scenario is a
list of declarative events, compiled once (seeded) into per-tick
perturbation arrays plus a control-event stream, and consumed uniformly
by ``simulate_week`` (tick = 15-min slot) and ``simulate_slot_fine``
(tick = 1 s).

Two planes, mirroring a real fleet:

  * the **data plane** — what actually happens: realized power
    (``power_factor``), realized arrivals (``arrival_factor``), and
    observed per-site service-latency inflation (``latency_factor``,
    1.0 = nominal; the straggler signal the router's EWMA consumes);
  * the **knowledge plane** — what the forecast pipeline can see:
    ``known_power_factor`` / ``known_arrival_factor`` (surprise events
    lag here by their detection delay) and ``pred_noise`` (predictor
    error regimes), plus discrete ``ControlEvent``s (site down/up,
    curtailment orders) delivered to the ``RoutingPolicy`` — the hook
    that exercises ``HeronRouter.mark_site_down`` / site recovery.

The default (event-free) scenario compiles to all-ones factors and an
empty control stream, so scenario-aware drivers are bit-identical to
their pre-scenario behavior — the equivalence guarantee
tests/test_scenarios.py pins.

Events draw randomness only from substreams spawned off the engine seed
(one ``SeedSequence`` child per event), so a scenario is reproducible
end-to-end and insensitive to how many *other* events draw.

Grid-interactive plane: the same two-plane split extends to
electricity **price** and grid-**carbon** signals (``price_factor`` /
``carbon_factor`` with ``known_*`` knowledge mirrors multiplying the
``power.grid.GridSignals`` base curves) plus a per-site battery-health
trace (``battery_health``, deratting ``power.grid.BatteryBank``
capacity). ``PriceSpike`` / ``CarbonRamp`` follow the ``GridTrip``
detection-lag idiom — the truth plane moves at ``start`` but the
knowledge plane and the ``PRICE_SPIKE`` / ``CARBON_RAMP`` control only
after ``detect_ticks`` — so a price-aware policy reacts with exactly the
announcement latency the scenario grants it. ``BatteryDegradation`` is
announced (``BATTERY_DEGRADED`` fires at window start).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

# Control-event kinds delivered to RoutingPolicy.on_event
SITE_DOWN = "site_down"
SITE_UP = "site_up"
CURTAILMENT = "curtailment"
CURTAILMENT_LIFTED = "curtailment_lifted"
GRID_TRIP = "grid_trip"             # value = trip depth (fraction lost)
GRID_RESTORED = "grid_restored"
PRICE_SPIKE = "price_spike"         # value = price multiplier
PRICE_NORMAL = "price_normal"
CARBON_RAMP = "carbon_ramp"         # value = carbon-intensity multiplier
CARBON_NORMAL = "carbon_normal"
BATTERY_DEGRADED = "battery_degraded"   # value = remaining health fraction


@dataclass(frozen=True)
class ControlEvent:
    """Discrete notification to the control plane (policy), not the truth."""
    kind: str
    site: int = -1          # -1 = fleet-wide
    value: float = 0.0
    tick: int = 0


@dataclass
class CompiledScenario:
    """Per-tick perturbation arrays (multiplicative factors) + controls.

    ``S`` sites x ``T`` ticks; arrivals are per the 9 request classes.
    All factors default to 1.0 — an empty scenario perturbs nothing.
    """
    num_sites: int
    ticks: int
    power_factor: np.ndarray            # [S, T] realized / base power
    known_power_factor: np.ndarray      # [S, T] what forecasts can see
    pred_noise: np.ndarray              # [S, T] predictor-error multiplier
    arrival_factor: np.ndarray          # [9, T] realized / base arrivals
    known_arrival_factor: np.ndarray    # [9, T] what load planning sees
    latency_factor: np.ndarray          # [S, T] service-latency inflation
    price_factor: np.ndarray = None         # [S, T] realized price mult
    known_price_factor: np.ndarray = None   # [S, T] what planning sees
    carbon_factor: np.ndarray = None        # [S, T] realized carbon mult
    known_carbon_factor: np.ndarray = None  # [S, T] what planning sees
    battery_health: np.ndarray = None       # [S, T] battery capacity derate
    controls: dict[int, list[ControlEvent]] = field(default_factory=dict)

    def __post_init__(self):
        shape = (self.num_sites, self.ticks)
        for name in ("price_factor", "known_price_factor", "carbon_factor",
                     "known_carbon_factor", "battery_health"):
            if getattr(self, name) is None:
                setattr(self, name, np.ones(shape))

    def add_control(self, tick: int, kind: str, site: int = -1,
                    value: float = 0.0) -> None:
        """Schedule a control. Ticks at/beyond the horizon are kept —
        the driver flushes them when the run ends (``controls_after``)
        so a reused policy is not left e.g. permanently site-down by a
        recovery that lands exactly on the horizon boundary."""
        if tick >= 0:
            self.controls.setdefault(tick, []).append(
                ControlEvent(kind=kind, site=site, value=value, tick=tick))

    def controls_at(self, tick: int) -> list[ControlEvent]:
        return self.controls.get(tick, [])

    def controls_after(self, horizon: int) -> list[ControlEvent]:
        """Controls scheduled at/beyond ``horizon``, in tick order —
        delivered by the driver after its last simulated tick."""
        return [ev for tk in sorted(k for k in self.controls
                                    if k >= horizon)
                for ev in self.controls[tk]]

    @property
    def is_trivial(self) -> bool:
        """True when nothing is perturbed (the bit-identical fast path)."""
        return (not self.controls
                and (self.power_factor == 1.0).all()
                and (self.known_power_factor == 1.0).all()
                and (self.pred_noise == 1.0).all()
                and (self.arrival_factor == 1.0).all()
                and (self.known_arrival_factor == 1.0).all()
                and (self.latency_factor == 1.0).all()
                and (self.price_factor == 1.0).all()
                and (self.known_price_factor == 1.0).all()
                and (self.carbon_factor == 1.0).all()
                and (self.known_carbon_factor == 1.0).all()
                and (self.battery_health == 1.0).all())

    # ---- serialization: a compiled scenario is a record (chaos runs
    # archive the exact disturbance they replayed) ----
    def to_json(self) -> dict:
        return {"num_sites": int(self.num_sites),
                "ticks": int(self.ticks),
                "power_factor": self.power_factor.tolist(),
                "known_power_factor": self.known_power_factor.tolist(),
                "pred_noise": self.pred_noise.tolist(),
                "arrival_factor": self.arrival_factor.tolist(),
                "known_arrival_factor": self.known_arrival_factor.tolist(),
                "latency_factor": self.latency_factor.tolist(),
                "price_factor": self.price_factor.tolist(),
                "known_price_factor": self.known_price_factor.tolist(),
                "carbon_factor": self.carbon_factor.tolist(),
                "known_carbon_factor": self.known_carbon_factor.tolist(),
                "battery_health": self.battery_health.tolist(),
                "controls": [{"kind": ev.kind, "site": ev.site,
                              "value": ev.value, "tick": ev.tick}
                             for tk in sorted(self.controls)
                             for ev in self.controls[tk]]}

    @classmethod
    def from_json(cls, d: dict) -> "CompiledScenario":
        c = cls(num_sites=int(d["num_sites"]), ticks=int(d["ticks"]),
                power_factor=np.asarray(d["power_factor"], float),
                known_power_factor=np.asarray(d["known_power_factor"], float),
                pred_noise=np.asarray(d["pred_noise"], float),
                arrival_factor=np.asarray(d["arrival_factor"], float),
                known_arrival_factor=np.asarray(d["known_arrival_factor"],
                                                float),
                latency_factor=np.asarray(d["latency_factor"], float))
        # grid planes: absent in pre-grid records -> default all-ones
        for name in ("price_factor", "known_price_factor", "carbon_factor",
                     "known_carbon_factor", "battery_health"):
            if name in d:
                setattr(c, name, np.asarray(d[name], float))
        for ev in d.get("controls", []):
            c.add_control(int(ev["tick"]), ev["kind"], int(ev["site"]),
                          float(ev["value"]))
        return c


def _window(start: int, duration: Optional[int], T: int) -> slice:
    a = max(int(start), 0)
    b = T if duration is None else min(int(start + duration), T)
    return slice(min(a, T), max(b, min(a, T)))


# ------------------------------------------------------------------
# event types
# ------------------------------------------------------------------
@dataclass(frozen=True)
class SiteFailure:
    """Site lost to a non-power fault (fibre cut, fire, hardware).

    Truth power goes to zero (the site cannot serve) but the *power
    forecast* pipeline is untouched — only the health signal knows:
    ``SITE_DOWN`` fires after ``detect_ticks`` and ``SITE_UP`` at
    recovery, exercising the router's site-health replanning while
    power-agnostic baselines keep placing load on the dead site.
    """
    site: int
    start: int
    duration: int
    detect_ticks: int = 0

    def apply(self, c: CompiledScenario, rng: np.random.Generator) -> None:
        w = _window(self.start, self.duration, c.ticks)
        if w.stop <= w.start:
            return                      # outage entirely outside the horizon
        c.power_factor[self.site, w] = 0.0
        # detection clamped into [0, recovery): an outage already in
        # progress at tick 0 is detected immediately, and one whose
        # detection lag outlives the outage is never detected at all
        # (no SITE_DOWN), so down/up can never arrive out of order
        detect = max(self.start + self.detect_ticks, 0)
        if detect < w.stop:
            c.add_control(detect, SITE_DOWN, self.site)
            c.add_control(w.stop, SITE_UP, self.site)


@dataclass(frozen=True)
class GridTrip:
    """Sudden power cliff at a site (grid/turbine trip), optionally a
    partial ``depth`` < 1. A *surprise*: forecasts only reflect it after
    ``detect_ticks`` (the first affected tick(s) hit the plan via
    brownout shedding — the Fig. 8 C1 failure mode, now injectable)."""
    site: int
    start: int
    duration: int = 2
    depth: float = 1.0
    detect_ticks: int = 1

    def apply(self, c: CompiledScenario, rng: np.random.Generator) -> None:
        w = _window(self.start, self.duration, c.ticks)
        if w.stop <= w.start:
            return                  # trip entirely outside the horizon
        keep = 1.0 - float(self.depth)
        c.power_factor[self.site, w] *= keep
        wk = _window(self.start + self.detect_ticks,
                     max(self.duration - self.detect_ticks, 0), c.ticks)
        c.known_power_factor[self.site, wk] *= keep
        # the health signal fires when the trip is *detected* (same lag
        # as the forecast pipeline) and clears at restoration; the policy
        # decides whether depth means "site dark" (HeronRouter treats
        # depth >= 0.999 as down) or a brownout it already absorbs
        detect = max(self.start + self.detect_ticks, 0)
        if detect < w.stop:
            c.add_control(detect, GRID_TRIP, self.site, float(self.depth))
            c.add_control(w.stop, GRID_RESTORED, self.site)


@dataclass(frozen=True)
class Curtailment:
    """Grid-operator curtailment order: usable power capped at ``frac``
    of available. Announced — forecasts see it immediately, and the
    policy gets a ``CURTAILMENT`` control (demand-response hook)."""
    frac: float
    start: int
    duration: int
    sites: Optional[tuple[int, ...]] = None

    def apply(self, c: CompiledScenario, rng: np.random.Generator) -> None:
        w = _window(self.start, self.duration, c.ticks)
        if w.stop <= w.start:
            return                  # order entirely outside the horizon
        rows = slice(None) if self.sites is None else list(self.sites)
        c.power_factor[rows, w] *= self.frac
        c.known_power_factor[rows, w] *= self.frac
        # announcement clamped to tick 0 for orders already in force at
        # window start, so CURTAILMENT/CURTAILMENT_LIFTED always pair up
        announce = max(self.start, 0)
        for s in ([-1] if self.sites is None else self.sites):
            c.add_control(announce, CURTAILMENT, s, self.frac)
            c.add_control(w.stop, CURTAILMENT_LIFTED, s)


@dataclass(frozen=True)
class PriceSpike:
    """Electricity price spikes to ``magnitude``x over a window
    (scarcity pricing, a congested interconnect). Truth price moves at
    ``start``; the knowledge plane and the ``PRICE_SPIKE`` control lag
    by ``detect_ticks`` (the ``GridTrip`` surprise idiom — a day-ahead
    announced spike is just ``detect_ticks=0``). ``PRICE_NORMAL`` fires
    at the window end."""
    magnitude: float
    start: int
    duration: int
    sites: Optional[tuple[int, ...]] = None
    detect_ticks: int = 0

    def apply(self, c: CompiledScenario, rng: np.random.Generator) -> None:
        w = _window(self.start, self.duration, c.ticks)
        if w.stop <= w.start:
            return                  # spike entirely outside the horizon
        rows = slice(None) if self.sites is None else list(self.sites)
        c.price_factor[rows, w] *= self.magnitude
        wk = _window(self.start + self.detect_ticks,
                     max(self.duration - self.detect_ticks, 0), c.ticks)
        c.known_price_factor[rows, wk] *= self.magnitude
        detect = max(self.start + self.detect_ticks, 0)
        if detect < w.stop:
            for s in ([-1] if self.sites is None else self.sites):
                c.add_control(detect, PRICE_SPIKE, s, float(self.magnitude))
                c.add_control(w.stop, PRICE_NORMAL, s, 1.0)


@dataclass(frozen=True)
class CarbonRamp:
    """Grid carbon intensity ramps to ``magnitude``x over a window (the
    marginal generator switches from wind to gas/coal). Same detection
    semantics as ``PriceSpike``: truth at ``start``, knowledge and the
    ``CARBON_RAMP`` control after ``detect_ticks``, ``CARBON_NORMAL``
    at the window end."""
    magnitude: float
    start: int
    duration: int
    sites: Optional[tuple[int, ...]] = None
    detect_ticks: int = 0

    def apply(self, c: CompiledScenario, rng: np.random.Generator) -> None:
        w = _window(self.start, self.duration, c.ticks)
        if w.stop <= w.start:
            return                  # ramp entirely outside the horizon
        rows = slice(None) if self.sites is None else list(self.sites)
        c.carbon_factor[rows, w] *= self.magnitude
        wk = _window(self.start + self.detect_ticks,
                     max(self.duration - self.detect_ticks, 0), c.ticks)
        c.known_carbon_factor[rows, wk] *= self.magnitude
        detect = max(self.start + self.detect_ticks, 0)
        if detect < w.stop:
            for s in ([-1] if self.sites is None else self.sites):
                c.add_control(detect, CARBON_RAMP, s, float(self.magnitude))
                c.add_control(w.stop, CARBON_NORMAL, s, 1.0)


@dataclass(frozen=True)
class BatteryDegradation:
    """A site's battery bank loses capacity (cell aging, thermal
    derating, a failed string): usable capacity multiplies by ``factor``
    over the window (or permanently when ``duration`` is None).
    Announced — the BMS knows its own health — so ``BATTERY_DEGRADED``
    fires at the window start with the remaining health fraction."""
    site: int
    start: int
    factor: float
    duration: Optional[int] = None

    def apply(self, c: CompiledScenario, rng: np.random.Generator) -> None:
        w = _window(self.start, self.duration, c.ticks)
        if w.stop <= w.start:
            return                  # entirely outside the horizon
        c.battery_health[self.site, w] *= self.factor
        c.add_control(max(self.start, 0), BATTERY_DEGRADED, self.site,
                      float(self.factor))


@dataclass(frozen=True)
class DemandSurge:
    """Arrival-rate surge (x ``magnitude``) over a window, optionally on
    a subset of classes. ``surprise=True`` hides it from load planning
    (plans are sized for base load; the surge hits dispatch only)."""
    magnitude: float
    start: int
    duration: int
    classes: Optional[tuple[int, ...]] = None
    surprise: bool = False

    def apply(self, c: CompiledScenario, rng: np.random.Generator) -> None:
        w = _window(self.start, self.duration, c.ticks)
        rows = slice(None) if self.classes is None else list(self.classes)
        c.arrival_factor[rows, w] *= self.magnitude
        if not self.surprise:
            c.known_arrival_factor[rows, w] *= self.magnitude


@dataclass(frozen=True)
class DiurnalSwell:
    """Deterministic sinusoidal arrival swell (amplitude around 1.0) —
    models a marketing-launch week / seasonal load breathing on top of
    the trace's own diurnal pattern. Fully predictable."""
    amplitude: float
    period: int = 96            # ticks per cycle (96 slots = 1 day)
    phase: float = 0.0

    def apply(self, c: CompiledScenario, rng: np.random.Generator) -> None:
        t = np.arange(c.ticks)
        f = np.maximum(1.0 + self.amplitude
                       * np.sin(2 * np.pi * (t - self.phase) / self.period),
                       0.0)
        c.arrival_factor *= f
        c.known_arrival_factor *= f


@dataclass(frozen=True)
class PredictorError:
    """Multiplicative log-normal error on power predictions over a
    window (regime of bad forecasts): pred *= exp(bias + sigma * eps),
    eps drawn from this event's seeded substream."""
    sigma: float
    bias: float = 0.0
    start: int = 0
    duration: Optional[int] = None

    def apply(self, c: CompiledScenario, rng: np.random.Generator) -> None:
        w = _window(self.start, self.duration, c.ticks)
        n = w.stop - w.start
        if n <= 0:
            return
        eps = rng.standard_normal((c.num_sites, n))
        c.pred_noise[:, w] *= np.exp(self.bias + self.sigma * eps)


@dataclass(frozen=True)
class StragglerOnset:
    """A site starts serving ``slowdown``x slower (thermal throttling,
    failing NIC — the paper's K1 story). Pure latency signal: the
    router's EWMA observes it and deweights the site; power-agnostic
    baselines keep routing into it and eat the inflated E2E."""
    site: int
    start: int
    duration: int
    slowdown: float
    ramp: int = 0               # ticks to ramp up to full slowdown

    def apply(self, c: CompiledScenario, rng: np.random.Generator) -> None:
        w = _window(self.start, self.duration, c.ticks)
        n = w.stop - w.start
        if n <= 0:
            return
        prof = np.full(n, float(self.slowdown))
        r = min(int(self.ramp), n)
        if r > 0:
            prof[:r] = np.linspace(1.0, self.slowdown, r + 1)[1:]
        c.latency_factor[self.site, w] = np.maximum(
            c.latency_factor[self.site, w], prof)


@dataclass(frozen=True)
class PowerWiggle:
    """Second-granularity AR(1) power wiggle parameters for
    ``simulate_slot_fine`` (its historical hardcoded disturbance, now an
    event like any other). At slot granularity this is a no-op — the
    wind traces already carry slot-level variability."""
    noise: float = 0.04
    phi: float = 0.995

    def apply(self, c: CompiledScenario, rng: np.random.Generator) -> None:
        pass                    # consumed by simulate_slot_fine directly


# ------------------------------------------------------------------
# engine
# ------------------------------------------------------------------
class ScenarioEngine:
    """Composable seeded event stream; compile() -> per-tick arrays.

    ``tick`` is whatever the consuming simulator steps by: 15-min slots
    for ``simulate_week``, seconds for ``simulate_slot_fine`` — event
    ``start``/``duration`` are in the consumer's ticks.
    """

    def __init__(self, events: Sequence = (), seed: Optional[int] = None):
        self.events = list(events)
        self.seed = 0 if seed is None else int(seed)

    def __repr__(self) -> str:
        return (f"ScenarioEngine(seed={self.seed}, "
                f"events=[{', '.join(type(e).__name__ for e in self.events)}])")

    def compile(self, num_sites: int, ticks: int) -> CompiledScenario:
        c = CompiledScenario(
            num_sites=num_sites, ticks=ticks,
            power_factor=np.ones((num_sites, ticks)),
            known_power_factor=np.ones((num_sites, ticks)),
            pred_noise=np.ones((num_sites, ticks)),
            arrival_factor=np.ones((9, ticks)),
            known_arrival_factor=np.ones((9, ticks)),
            latency_factor=np.ones((num_sites, ticks)))
        # grid planes filled by __post_init__ (all-ones defaults)
        if self.events:
            streams = np.random.SeedSequence(self.seed).spawn(len(self.events))
            for ev, ss in zip(self.events, streams):
                ev.apply(c, np.random.default_rng(ss))
        return c

    def fine_wiggle(self) -> Optional[PowerWiggle]:
        """The (first) PowerWiggle event, if any — simulate_slot_fine's
        AR(1) parameters when a scenario overrides its defaults."""
        for ev in self.events:
            if isinstance(ev, PowerWiggle):
                return ev
        return None


def default_scenario(seed: Optional[int] = None) -> ScenarioEngine:
    """The event-free scenario — compiles to all-ones factors."""
    return ScenarioEngine((), seed=seed)
