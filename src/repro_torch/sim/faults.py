"""FaultInjector — deterministic chaos against live serving engines.

The week/fine simulators perturb *rates*; this module perturbs the
*serving path itself*: site kills and restores, admission drops, step
delays, and corrupted power telemetry, injected into a
``sim.cluster.ServingCluster`` mid-decode. Two sources compose:

  * an **explicit schedule** — a list of ``Fault`` records (tick, kind,
    site, value), e.g. derived from a ``CompiledScenario`` via
    ``from_scenario`` so the same scenario definition drives the week
    sim and an engine-level chaos run;
  * a **seeded random plane** — per-tick Bernoulli draws for the noisy
    fault kinds (``delay`` / ``drop_admission`` / ``corrupt_power``),
    keyed by ``SeedSequence((seed, tick))`` so tick ``t``'s faults are
    identical no matter how many ticks ran before it or what any other
    tick drew (replayable, resumable).

Determinism is the point: a chaos run is a *test*, and the pinned
stream-identity anchors only mean something if the exact same kills land
at the exact same ticks every run.

Fault kinds
-----------
``kill``            site's engine dies: drain() -> transcript snapshots
                    (handed to the failover layer), site unroutable;
``restore``         site returns (empty engine, routable again);
``delay``           site's step stalls this tick (latency inflation on
                    live requests — no tokens sampled);
``drop_admission``  site's engine admits nothing this tick (queue holds);
``corrupt_power``   the *telemetry* the router weighs sites by is
                    multiplied by ``value`` this tick — truth power is
                    untouched (a sensor fault, not a grid fault).

Scenario derivation (``from_scenario``) reads the **truth plane**:
kills/restores fire where ``power_factor`` crosses to/from ~zero — the
engines die when the power actually drops, while the scenario's control
stream (detection-lagged) is what the *policy* sees, preserving the
two-plane split.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.sim.scenarios import CompiledScenario

KILL = "kill"
RESTORE = "restore"
DELAY = "delay"
DROP_ADMISSION = "drop_admission"
CORRUPT_POWER = "corrupt_power"

_RANDOM_KINDS = (DELAY, DROP_ADMISSION, CORRUPT_POWER)


@dataclass(frozen=True)
class Fault:
    """One scheduled fault at ``tick`` against ``site``."""
    tick: int
    kind: str
    site: int
    value: float = 0.0

    def to_json(self) -> dict:
        return {"tick": int(self.tick), "kind": self.kind,
                "site": int(self.site), "value": float(self.value)}

    @classmethod
    def from_json(cls, d: dict) -> "Fault":
        return cls(tick=int(d["tick"]), kind=d["kind"],
                   site=int(d["site"]), value=float(d.get("value", 0.0)))


@dataclass
class FaultInjector:
    """Deterministic (seeded) fault source for ``ServingCluster``.

    ``schedule``: explicit Fault records. ``p_delay`` / ``p_drop`` /
    ``p_corrupt``: per-(site, tick) probabilities for the random plane
    (0 disables a kind). ``corrupt_range``: the multiplier a corrupted
    power reading is drawn from (uniform).
    """
    num_sites: int
    seed: int = 0
    schedule: Sequence[Fault] = ()
    p_delay: float = 0.0
    p_drop: float = 0.0
    p_corrupt: float = 0.0
    corrupt_range: tuple = (0.0, 2.0)

    _by_tick: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        for f in self.schedule:
            self._by_tick.setdefault(int(f.tick), []).append(f)

    # ------------------------------------------------------------- build
    @classmethod
    def from_scenario(cls, sc: CompiledScenario, *, seed: int = 0,
                      dead_below: float = 1e-9, **kw) -> "FaultInjector":
        """Derive kill/restore faults from a compiled scenario's TRUTH
        power plane: a site whose ``power_factor`` falls to ~zero is
        killed at that tick and restored when it rises again. Detection
        lag stays in the scenario's control stream (the policy's plane);
        the engines die on truth — exactly the asymmetry a surprise
        ``GridTrip`` is about."""
        sched = list(kw.pop("schedule", ()))
        dead = sc.power_factor <= dead_below          # [S, T]
        for s in range(sc.num_sites):
            prev = False
            for t in range(sc.ticks):
                if dead[s, t] and not prev:
                    sched.append(Fault(t, KILL, s))
                elif prev and not dead[s, t]:
                    sched.append(Fault(t, RESTORE, s))
                prev = dead[s, t]
        return cls(num_sites=sc.num_sites, seed=seed, schedule=sched, **kw)

    # ------------------------------------------------------------- query
    def _rng(self, tick: int) -> np.random.Generator:
        """Per-tick substream: draws at tick t never depend on other
        ticks (schedule edits / resume cannot shift the random plane)."""
        return np.random.default_rng(
            np.random.SeedSequence((int(self.seed), int(tick))))

    def faults_at(self, tick: int) -> list[Fault]:
        """All faults firing at ``tick``: the explicit schedule plus the
        seeded random plane, in a deterministic order (schedule first,
        then random kinds by site then kind)."""
        out = list(self._by_tick.get(int(tick), []))
        if self.p_delay or self.p_drop or self.p_corrupt:
            rng = self._rng(tick)
            # one draw matrix per call: [S, 3] uniforms + [S] corrupt
            # multipliers, consumed in a fixed order
            u = rng.random((self.num_sites, len(_RANDOM_KINDS)))
            lo, hi = self.corrupt_range
            mult = lo + (hi - lo) * rng.random(self.num_sites)
            probs = (self.p_delay, self.p_drop, self.p_corrupt)
            for s in range(self.num_sites):
                for k, (kind, p) in enumerate(zip(_RANDOM_KINDS, probs)):
                    if p > 0.0 and u[s, k] < p:
                        val = float(mult[s]) if kind == CORRUPT_POWER else 0.0
                        out.append(Fault(int(tick), kind, s, val))
        return out

    def to_json(self) -> dict:
        return {"num_sites": int(self.num_sites), "seed": int(self.seed),
                "schedule": [f.to_json() for f in self.schedule],
                "p_delay": float(self.p_delay),
                "p_drop": float(self.p_drop),
                "p_corrupt": float(self.p_corrupt),
                "corrupt_range": list(self.corrupt_range)}

    @classmethod
    def from_json(cls, d: dict) -> "FaultInjector":
        return cls(num_sites=int(d["num_sites"]), seed=int(d["seed"]),
                   schedule=[Fault.from_json(f) for f in d["schedule"]],
                   p_delay=float(d.get("p_delay", 0.0)),
                   p_drop=float(d.get("p_drop", 0.0)),
                   p_corrupt=float(d.get("p_corrupt", 0.0)),
                   corrupt_range=tuple(d.get("corrupt_range", (0.0, 2.0))))
