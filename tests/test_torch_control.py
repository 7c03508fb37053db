"""The port's copy of Heron's control plane against the original.

``repro_torch`` keeps its own copies of the reference's numpy/scipy
modules (lookup tables, planners, scheduler, router, wind and workload
traces, grid signals, scenarios and the week simulator), so that it
imports nothing of ``repro``. Each copy is held equal to its original on
the same inputs, at small sizes: the same arithmetic in the same order
gives the same bits, so arrays are compared exactly.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

from repro.configs import PAPER_MODEL as REF_PAPER_MODEL
from repro.core import lookup as ref_lookup
from repro.core import planner_l as ref_planner_l_mod
from repro.core.planner_l import plan_l as ref_plan_l
from repro.core.scheduler import RequestScheduler as RefScheduler
from repro.data.workload import make_trace as ref_make_trace
from repro.data.workload import stream_requests as ref_stream_requests
from repro.power import grid as ref_grid
from repro.power.model import H100_DGX as REF_H100
from repro.sim import scenarios as ref_scenarios
from repro.sim.cluster import simulate_week_reference as ref_week
from repro.sim.testbed import paper_grid as ref_paper_grid
from repro_torch.configs import PAPER_MODEL
from repro_torch.core import lookup
from repro_torch.core import planner_l as planner_l_mod
from repro_torch.core.planner_l import PlannerLSession, plan_l
from repro_torch.core.scheduler import RequestScheduler
from repro_torch.data.workload import make_trace, stream_requests
from repro_torch.power import grid
from repro_torch.power.model import H100_DGX
from repro_torch.sim import scenarios
from repro_torch.sim.cluster import simulate_week, simulate_week_reference
from repro_torch.sim.testbed import paper_grid

WEEK_FIELDS = ("served", "dropped", "mean_e2e", "power_w", "reconfigs",
               "cost_usd", "carbon_g")


def _rows(table) -> np.ndarray:
    return np.array([dataclasses.astuple(r) for r in table.rows], float)


def _slos(table) -> np.ndarray:
    return np.array([dataclasses.astuple(s) for s in table.slos], float)


@pytest.fixture(scope="module")
def grids():
    return paper_grid("coding"), ref_paper_grid("coding")


def test_paper_grid_equals_reference(grids):
    g, r = grids
    np.testing.assert_array_equal(g.power_mw, r.power_mw)
    np.testing.assert_array_equal(g.arrivals_rps, r.arrivals_rps)
    assert [(s.name, s.num_gpus) for s in g.sites] == [
        (s.name, s.num_gpus) for s in r.sites]
    np.testing.assert_array_equal(_rows(g.table), _rows(r.table))
    np.testing.assert_array_equal(_slos(g.table), _slos(r.table))


def test_build_table_arrays_equal_reference():
    """The paper model's full table (every TP, frequency and load of the
    H100 profile) and the same config fields."""
    assert dataclasses.asdict(PAPER_MODEL) == dataclasses.asdict(
        REF_PAPER_MODEL)
    assert dataclasses.asdict(H100_DGX) == dataclasses.asdict(REF_H100)
    got = lookup.build_table(PAPER_MODEL, make_trace("conversation"),
                             H100_DGX)
    want = ref_lookup.build_table(REF_PAPER_MODEL,
                                  ref_make_trace("conversation"), REF_H100)
    assert len(got.rows) > 500
    np.testing.assert_array_equal(_rows(got), _rows(want))
    np.testing.assert_array_equal(_slos(got), _slos(want))


@pytest.fixture(scope="module")
def plans(grids):
    """One slot of the 4-site paper grid, planned by both packages, and
    the port's cold session on the same inputs."""
    g, r = grids
    power = g.power_mw[:4, 200] * 1e6
    load = g.arrivals_rps[:, 200]
    got = plan_l(g.table, g.sites[:4], power, load)
    want = ref_plan_l(r.table, r.sites[:4], power, load)
    cold = PlannerLSession(g.table, g.sites[:4]).plan(power, load,
                                                      mode="cold")
    return got, want, cold, load


def test_plan_l_and_cold_session_equal_reference(plans):
    got, want, cold, _ = plans
    assert got.counts.sum() > 0
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.unserved, want.unserved)
    np.testing.assert_array_equal(cold.counts, got.counts)
    np.testing.assert_allclose(cold.unserved, got.unserved)


@pytest.mark.parametrize("packing", [False, True])
def test_dispatch_matches_its_reference_and_the_original(plans, packing):
    got_plan, want_plan, _, load = plans
    for scale in (0.5, 3.0):               # under and over capacity
        arr = load * scale
        sched = RequestScheduler(4, packing=packing)
        got = sched.dispatch(got_plan.group_table(), arr)
        loop = sched.dispatch_reference(sched.groups_from_plan(got_plan), arr)
        want = RefScheduler(4, packing=packing).dispatch(
            want_plan.group_table(), arr)
        for f in ("served", "dropped", "mean_e2e", "packed",
                  "per_site_load"):
            np.testing.assert_allclose(getattr(got, f), getattr(loop, f),
                                       rtol=1e-9, atol=1e-9, err_msg=f)
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)


def test_stream_requests_chunks_equal_reference():
    kw = dict(num_users=40_000, num_sites=4, duration_s=900.0, chunk_s=60.0,
              seed=3)
    got = list(stream_requests([make_trace("coding"),
                                make_trace("conversation")], **kw))
    want = list(ref_stream_requests([ref_make_trace("coding"),
                                     ref_make_trace("conversation")], **kw))
    assert len(got) == len(want) == 15
    assert sum(len(c) for c in got) > 100
    for a, b in zip(got, want):
        for f in ("rid", "arrival_s", "site", "lin", "lout", "cls", "kind"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        assert (a.start_s, a.end_s) == (b.start_s, b.end_s)


def _solve_to_the_end(solve):
    """``solve`` (a ``solve_milp``) with a time limit that cannot bind."""
    def run(*args, **kw):
        return solve(*args, **{**kw, "time_limit": math.inf})
    return run


def test_simulate_week_reference_equals_original(grids, monkeypatch):
    """Three drought-window slots of four sites at 256x the grid's
    arrivals (power-reality shedding drops requests): the port's copy of
    the reference week loop equals the original's, and its policy-driven
    ``simulate_week`` equals the loop. Planner-L caps each site ILP at a
    wall-clock budget, so on a loaded machine the two planners could stop
    their branch and cut at different points: here both solve every site
    ILP to the end."""
    for mod in (ref_planner_l_mod, planner_l_mod):
        monkeypatch.setattr(mod, "solve_milp",
                            _solve_to_the_end(mod.solve_milp))
    g, r = grids
    sl = slice(500, 503)
    got = simulate_week_reference("heron", g.table, g.sites[:4],
                                  g.power_mw[:4, sl],
                                  g.arrivals_rps[:, sl] * 256.0)
    want = ref_week("heron", r.table, r.sites[:4], r.power_mw[:4, sl],
                    r.arrivals_rps[:, sl] * 256.0)
    new = simulate_week("heron", g.table, g.sites[:4], g.power_mw[:4, sl],
                        g.arrivals_rps[:, sl] * 256.0)
    assert len(got.slots) == len(want.slots) == len(new.slots) == 3
    for a, b, c in zip(got.slots, want.slots, new.slots):
        for f in WEEK_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        for f in WEEK_FIELDS[:5]:           # the loop bills no cost/carbon
            np.testing.assert_array_equal(getattr(c, f), getattr(a, f),
                                          err_msg=f)
    assert sum(s.total_dropped for s in got.slots) > 0


def test_battery_bank_step_equals_reference():
    kw = dict(capacity_mwh=2.0, charge_rate_mw=3.0, discharge_rate_mw=2.5,
              efficiency=0.9, soc_frac=0.4)
    bank = grid.BatteryBank.sized(3, **kw)
    ref = ref_grid.BatteryBank.sized(3, **kw)
    rng = np.random.default_rng(5)
    for t in range(60):
        avail, demand = rng.uniform(0, 5, 3), rng.uniform(0, 5, 3)
        if t == 30:
            bank.set_health([1.0, 0.6, 0.3])
            ref.set_health([1.0, 0.6, 0.3])
        np.testing.assert_array_equal(bank.step(avail, demand, dt_h=0.25),
                                      ref.step(avail, demand, dt_h=0.25))
        np.testing.assert_array_equal(bank.soc_mwh, ref.soc_mwh)
    np.testing.assert_array_equal(bank.ride_through_mw(0.25),
                                  ref.ride_through_mw(0.25))


def _events(m):
    return [m.SiteFailure(site=1, start=3, duration=5, detect_ticks=1),
            m.GridTrip(site=0, start=6, duration=4, depth=0.7,
                       detect_ticks=2),
            m.Curtailment(frac=0.5, start=2, duration=6, sites=(2,)),
            m.PriceSpike(magnitude=3.0, start=4, duration=3, sites=(1,),
                         detect_ticks=1),
            m.CarbonRamp(magnitude=2.0, start=1, duration=8),
            m.BatteryDegradation(site=2, start=5, factor=0.5),
            m.DemandSurge(magnitude=1.8, start=2, duration=5),
            m.DiurnalSwell(amplitude=0.2, period=8),
            m.PredictorError(sigma=0.1),
            m.StragglerOnset(site=1, start=7, duration=6, slowdown=2.0,
                             ramp=2),
            m.PowerWiggle(noise=0.05)]


def test_scenario_compile_equals_reference():
    got = scenarios.ScenarioEngine(_events(scenarios), seed=4).compile(3, 16)
    want = ref_scenarios.ScenarioEngine(_events(ref_scenarios),
                                        seed=4).compile(3, 16)
    d, e = got.to_json(), want.to_json()
    assert d == e
    for f in ("power_factor", "known_power_factor", "pred_noise",
              "arrival_factor", "known_arrival_factor", "latency_factor",
              "price_factor", "carbon_factor", "battery_health"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert not got.is_trivial
