"""RoutingPolicy — the pluggable control-plane interface of the simulators.

A routing policy is anything that can run the paper's control loop:

    plan_slot(pred_power_w, pred_load) -> Plan     Planner-L cadence (15 min)
    plan_fine(now, power_w, observed_load) -> Plan Planner-S cadence (~5 s)
    route(groups, arrivals) -> DispatchResult      Request Scheduler dispatch
    observe(latency, mask=None)                    per-site health feedback
    on_event(event)                                ScenarioEngine controls

``HeronRouter`` implements it natively (both objectives) — so
``simulate_week("heron", ...)`` now drives the *actual* router object,
straggler EWMA, site up/down marking and Configurator freeze windows
included, instead of a parallel inlined planning loop. The two paper
baselines are wrapped by ``WrrDynamoLLMPolicy`` / ``GreedyMinLatencyPolicy``
(power-variability agnostic: they ignore power predictions, health
feedback, and control events — which is exactly why scenarios hurt them).

The name->factory registry keeps the legacy string API working
(``simulate_week("wrr_dynamollm", ...)``) and is the extension point for
new baselines: ``register_policy("mine", my_factory)`` and every driver,
benchmark, and example picks it up. Factories receive
``(table, sites, **kwargs)`` where kwargs are the driver's standard knobs
(``r_frac``, ``time_limit``, ``planner_method``, ``planner_workers``,
``packing``, the Heron straggler knobs ``straggler_alpha`` /
``straggler_threshold`` / ``straggler_min_haircut``, and the
event-driven Planner-L knobs ``incremental`` / ``dirty_tol`` routing
slot solves through a persistent ``PlannerLSession``) — ignore what
does not apply.

Failover (optional extension): a policy may additionally expose
``failover_order(site) -> list[int]`` — the preferred landing order for
in-flight work drained off a dying ``site``. ``sim.cluster.
ServingCluster`` consults it when carrying preempted transcripts to
surviving sites; policies without it (both baselines) get
alive-sites-by-index failover. It is deliberately NOT part of the
Protocol body: the contract's required surface stays the five lifecycle
methods above, and ``isinstance`` checks keep working for minimal
policies.
"""
from __future__ import annotations

from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.baselines import (GreedyMinLatencyPolicy, WrrDynamoLLMPolicy)
from repro_torch.core.lookup import LookupTable
from repro_torch.core.planner_l import Plan, SiteSpec
from repro_torch.core.router import (STRAGGLER_ALPHA, STRAGGLER_MIN_HAIRCUT,
                               STRAGGLER_THRESHOLD, DRHeronPolicy,
                               HeronRouter, XWindPolicy)
from repro_torch.core.scheduler import DispatchResult


@runtime_checkable
class RoutingPolicy(Protocol):
    """Structural interface — see module docstring for the lifecycle."""
    name: str

    def plan_slot(self, pred_power_w: np.ndarray,
                  pred_load: np.ndarray) -> Plan: ...

    def plan_fine(self, now: float, power_w: np.ndarray,
                  observed_load: np.ndarray) -> Plan: ...

    def route(self, groups, arrivals: np.ndarray) -> DispatchResult: ...

    def observe(self, latency: np.ndarray,
                mask: Optional[np.ndarray] = None) -> None: ...

    def on_event(self, event) -> None: ...


PolicyFactory = Callable[..., RoutingPolicy]

_REGISTRY: dict[str, PolicyFactory] = {}


def register_policy(name: str, factory: PolicyFactory) -> None:
    """Register a policy factory under ``name`` (later wins)."""
    _REGISTRY[name] = factory


def list_policies() -> list[str]:
    """Registered policy names, sorted."""
    return sorted(_REGISTRY)


def make_policy(name: str, table: LookupTable, sites: list[SiteSpec],
                **kwargs) -> RoutingPolicy:
    """Instantiate a registered policy; unknown names list what exists."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown routing policy {name!r}; registered policies: "
            f"{', '.join(list_policies())}")
    return _REGISTRY[name](table, sites, **kwargs)


# ------------------------------------------------------------------
# built-in policies
# ------------------------------------------------------------------
def _heron_factory(objective: str) -> PolicyFactory:
    def make(table: LookupTable, sites: list[SiteSpec], *,
             r_frac: float = 0.03, time_limit: float = 20.0,
             planner_method: str = "auto",
             planner_workers: Optional[int] = None,
             packing: bool = False,
             straggler_alpha: float = STRAGGLER_ALPHA,
             straggler_threshold: float = STRAGGLER_THRESHOLD,
             straggler_min_haircut: float = STRAGGLER_MIN_HAIRCUT,
             incremental: bool = False, dirty_tol: float = 0.02,
             **_ignored) -> HeronRouter:
        return HeronRouter(table=table, sites=sites, objective=objective,
                           r_frac=r_frac, time_limit_l=time_limit,
                           planner_method=planner_method,
                           planner_workers=planner_workers, packing=packing,
                           straggler_alpha=straggler_alpha,
                           straggler_threshold=straggler_threshold,
                           straggler_min_haircut=straggler_min_haircut,
                           incremental=incremental, dirty_tol=dirty_tol)
    return make


def _wrr_factory(table: LookupTable, sites: list[SiteSpec], *,
                 time_limit: float = 20.0, **_ignored) -> WrrDynamoLLMPolicy:
    return WrrDynamoLLMPolicy(table=table, sites=sites,
                              time_limit=time_limit)


def _greedy_factory(table: LookupTable, sites: list[SiteSpec],
                    **_ignored) -> GreedyMinLatencyPolicy:
    return GreedyMinLatencyPolicy(table=table, sites=sites)


def _dr_heron_factory(table: LookupTable, sites: list[SiteSpec], *,
                      r_frac: float = 0.03, time_limit: float = 20.0,
                      planner_method: str = "auto",
                      planner_workers: Optional[int] = None,
                      packing: bool = False,
                      dr_curtail_frac: float = 0.8,
                      dr_min_keep: float = 0.25,
                      incremental: bool = False, dirty_tol: float = 0.02,
                      **_ignored) -> DRHeronPolicy:
    """Heron + demand response: sheds into curtailment orders and
    price/carbon spikes (``core.router.DRHeronPolicy``)."""
    return DRHeronPolicy(table=table, sites=sites, objective="latency",
                         r_frac=r_frac, time_limit_l=time_limit,
                         planner_method=planner_method,
                         planner_workers=planner_workers, packing=packing,
                         dr_curtail_frac=dr_curtail_frac,
                         dr_min_keep=dr_min_keep,
                         incremental=incremental, dirty_tol=dirty_tol)


def _xwind_factory(table: LookupTable, sites: list[SiteSpec], *,
                   r_frac: float = 0.03, time_limit: float = 20.0,
                   planner_method: str = "auto",
                   planner_workers: Optional[int] = None,
                   packing: bool = False,
                   **_ignored) -> XWindPolicy:
    """XWind-style cross-site price router: plans under the ``"cost"``
    objective with announced per-site prices as the site-rate signal
    (``core.router.XWindPolicy``)."""
    return XWindPolicy(table=table, sites=sites,
                       r_frac=r_frac, time_limit_l=time_limit,
                       planner_method=planner_method,
                       planner_workers=planner_workers, packing=packing)


register_policy("heron", _heron_factory("latency"))
register_policy("heron_min_power", _heron_factory("power"))
register_policy("wrr_dynamollm", _wrr_factory)
register_policy("greedy_min_latency", _greedy_factory)
register_policy("dr_heron", _dr_heron_factory)
register_policy("xwind", _xwind_factory)
