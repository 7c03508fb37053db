"""Heron's co-sim on the port's engines against the co-sim on JAX engines.

The reference launcher (``repro.launch.cosim``) and the port's
``run_cosim`` run the same 40-tick fleet: 4 sites, 150,000 users, Heron
planning, and a grid trip that darkens site 0 for the middle third, so
its in-flight requests are drained, carried to other sites and resumed.
The engines run on the fleet's virtual clock with no end token, so every
counter of the ``E2EResult`` depends on request lengths and the plan
alone: the port's run, dense or paged, must give the counters of the
reference's run over JAX engines with the same cache (planner timings
aside), with no duplicated token.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from repro.configs import smoke_config
from repro.data.workload import make_trace
from repro.launch.cosim import _build_scenario
from repro.launch.cosim import main as ref_main
from repro.models.api import build
from repro.serving.engine import ServingEngine
from repro.sim.e2e import simulate_fleet_serving
from repro.sim.policy import make_policy
from repro.sim.testbed import paper_grid
from repro_torch.configs import llama32_1b, reduced
from repro_torch.launch.cosim import main, run_cosim

ARGS = dict(scenario="grid_trip", site=0, depth=1.0, ticks=40)


def _record(result) -> dict:
    d = result.to_json()
    d.pop("planner")
    return d


def _reference_paged() -> dict:
    """The reference launcher's run (``repro/launch/cosim.py:79-103``),
    with paged engines, which its command line does not offer."""
    g = paper_grid("coding", multiplier=60.0)
    model = build(smoke_config("llama3.2-1b"))
    params = model.init_params(jax.random.key(0))
    pshare = g.power_mw[:4, 200:212].mean(axis=1)
    batches = np.maximum(2, np.round(16 * pshare / pshare.sum())).astype(int)

    def make_engine(site, clock):
        return ServingEngine(model, params, max_batch=int(batches[site]),
                             max_seq=64, seed=site, clock=clock, paged=True)

    res = simulate_fleet_serving(
        make_policy("heron", g.table, g.sites[:4], time_limit=20), g.table,
        g.sites[:4], g.power_mw[:4], make_engine,
        traces=[make_trace("coding"), make_trace("conversation")],
        num_users=150_000, ticks=40, plan_load_scale=30.0,
        scenario=_build_scenario("grid_trip", 0, 40, 1.0, 0), seed=0,
        name="cosim_heron_grid_trip")
    return _record(res)


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "paged"])
def runs(request, tmp_path_factory):
    """(paged, the reference's record, the port's run)."""
    paged = request.param
    if paged:
        want = _reference_paged()
    else:
        out = tmp_path_factory.mktemp("cosim") / "ref.json"
        assert ref_main(["--scenario", "grid_trip", "--site", "0",
                         "--depth", "1.0", "--ticks", "40", "--out",
                         str(out)]) == 0
        want = json.loads(out.read_text())
        want.pop("planner")
    cfg = reduced(llama32_1b, num_layers=1, dtype="float32")
    return paged, want, run_cosim(cfg, device="cpu", paged=paged, **ARGS)


def test_counters_equal_the_jax_engines_run(runs):
    _paged, want, run = runs
    assert _record(run.result) == want
    assert run.result.duplicated_tokens == 0
    # the trip drained live work and the fleet carried it elsewhere
    assert run.result.preemptions > 0 and run.result.resumes > 0
    assert run.result.completed == run.result.offered_requests > 0


def test_engines_balance_and_give_back_their_pages(runs):
    paged, _want, run = runs
    live = [e for e in run.fleet.engines if e is not None]
    assert len(live) == 4                   # site 0 came back
    for eng in live:
        assert eng.reconcile()["balanced"], eng.reconcile()
        assert eng.paged == paged
        if paged:
            assert len(eng._free_pages) == eng.num_pages
    c = run.counts
    assert c["engines"] == 5                # the killed engine too
    assert c["decode_steps"] == c["engine_steps"] > 0
    assert c["prefills"] > 0 and c["extend_chunks"] > 0
    assert run.wall_seconds > 0


def test_cli_writes_the_record(tmp_path, capsys):
    out = tmp_path / "cosim.json"
    assert main(["--device", "cpu", "--layers", "1", "--scenario", "none",
                 "--ticks", "6", "--users", "20000", "--out",
                 str(out)]) == 0
    d = json.loads(out.read_text())
    assert d["kind"] == "e2e" and d["ticks"] == 6
    assert np.isfinite(d["cost_usd"]) and d["duplicated_tokens"] == 0
    assert "engine steps" in capsys.readouterr().out
