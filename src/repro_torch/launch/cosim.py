"""Co-sim launcher: streamed million-user trace replay on live engines.

Port of ``repro/launch/cosim.py``, over the port's engines. The streamed
Azure-shaped request population (``data.workload``) drives one live
``ServingEngine`` per site under a fleet ``RoutingPolicy``'s plan (power
truth plane -> admission budgets + brownout), with scenario disturbances
hitting the live engines (``sim.e2e.simulate_fleet_serving``). Prints the
SLO-attributed served-token goodput summary and optionally writes the
full ``E2EResult`` JSON.

  PYTHONPATH=src python -m repro_torch.launch.cosim --device cpu --ticks 40
  PYTHONPATH=src python -m repro_torch.launch.cosim \\
      --policy heron --scenario grid_trip --ticks 120 \\
      [--users 150000] [--sites 4] [--arch llama3.2-1b] [--layers N] \\
      [--paged] [--depth 0.7] [--seed 0] [--out artifacts/cosim.json]

``--scenario none`` runs a healthy fleet; ``site_failure`` kills the
target site for the middle third of the run; ``grid_trip`` sheds
``--depth`` of its power instead (a partial trip is a brownout, not a
kill). Any registered policy name works; see
``repro_torch.sim.policy.list_policies``.

The engines run on a virtual clock (one tick per fleet step) with no end
token, so the result's counters depend on request lengths and the plan
alone, not on the model's weights, depth or device: a full-width run on
the card gives the counters of a 1-layer run on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.workload import make_trace
from repro_torch.device import resolve_device
from repro_torch.models.api import build
from repro_torch.serving.engine import ServingEngine
from repro_torch.sim.e2e import E2EResult, simulate_fleet_serving
from repro_torch.sim.policy import make_policy
from repro_torch.sim.scenarios import GridTrip, ScenarioEngine, SiteFailure
from repro_torch.sim.testbed import paper_grid

SCENARIOS = ("none", "site_failure", "grid_trip")


def build_scenario(kind: str, site: int, ticks: int, depth: float,
                   seed: int) -> ScenarioEngine:
    """The CLI's scenarios: the event covers the middle third of the run."""
    q = ticks // 3
    if kind == "none":
        return ScenarioEngine(seed=seed)
    if kind == "site_failure":
        return ScenarioEngine([SiteFailure(site=site, start=q, duration=q)],
                              seed=seed)
    if kind == "grid_trip":
        return ScenarioEngine([GridTrip(site=site, start=q, duration=q,
                                        depth=depth, detect_ticks=2)],
                              seed=seed)
    raise ValueError(f"unknown scenario {kind!r} "
                     f"(choose {'|'.join(SCENARIOS)})")


class CosimRun(NamedTuple):
    result: E2EResult
    fleet: object            # the sim.e2e.FleetServingSim after its drain
    counts: dict             # engine counters summed over every engine
    wall_seconds: float


def engine_counts(fleet) -> dict:
    """Model calls of every engine the run built, replaced ones included:
    bucket prefills (``prefill_calls`` without the extend chunks), extend
    chunks and decode steps, the counts a kernel's launches follow."""
    metrics = list(fleet._graveyard) + [e.metrics for e in fleet.engines
                                        if e is not None]
    return {"prefills": sum(m.prefill_calls - m.extend_chunks
                            for m in metrics),
            "extend_chunks": sum(m.extend_chunks for m in metrics),
            "decode_steps": sum(m.decode_steps for m in metrics),
            "engine_steps": sum(m.steps for m in metrics),
            "engines": len(metrics)}


def run_cosim(cfg: Optional[ModelConfig] = None, *, device=None,
              policy: str = "heron", scenario: str = "grid_trip",
              site: int = 1, depth: float = 0.7, ticks: int = 120,
              users: int = 150_000, sites: int = 4, seed: int = 0,
              paged: bool = False, plan_load_scale: float = 30.0
              ) -> CosimRun:
    """One policy x scenario co-sim over port engines on ``device``.

    Engines are built as the reference's launcher builds them: each
    site's ``max_batch`` from its share of the grid's power, ``max_seq``
    64, ``seed`` = site, the fleet's virtual clock, and one shared set of
    weights drawn from ``seed``. ``cfg=None`` serves the llama3.2-1b
    smoke config; ``paged`` gives every engine a paged KV cache of the
    dense capacity.
    """
    cfg = cfg or smoke_config("llama3.2-1b")
    dev = resolve_device(device)
    g = paper_grid("coding", multiplier=60.0)
    model = build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))

    # per-site decode slots follow the site's power share
    pshare = g.power_mw[:sites, 200:212].mean(axis=1)
    pshare = pshare / pshare.sum()
    batches = np.maximum(2, np.round(16 * pshare)).astype(int)

    def make_engine(s, clock):
        return ServingEngine(model, params, max_batch=int(batches[s]),
                             max_seq=64, seed=s, clock=clock, paged=paged)

    pol = make_policy(policy, g.table, g.sites[:sites], time_limit=20)
    t0 = time.perf_counter()
    with torch.no_grad():
        res, fleet = simulate_fleet_serving(
            pol, g.table, g.sites[:sites], g.power_mw[:sites], make_engine,
            traces=[make_trace("coding"), make_trace("conversation")],
            num_users=users, ticks=ticks, plan_load_scale=plan_load_scale,
            scenario=build_scenario(scenario, site, ticks, depth, seed),
            seed=seed, name=f"cosim_{policy}_{scenario}", return_fleet=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return CosimRun(res, fleet, engine_counts(fleet),
                    time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="million-user co-sim: streamed trace replay on live "
                    "per-site serving engines")
    ap.add_argument("--policy", default="heron")
    ap.add_argument("--scenario", default="grid_trip", choices=SCENARIOS)
    ap.add_argument("--site", type=int, default=1,
                    help="scenario target site")
    ap.add_argument("--depth", type=float, default=0.7,
                    help="grid trip power-loss fraction (1.0 = dark)")
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--users", type=int, default=150_000)
    ap.add_argument("--sites", type=int, default=4)
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS),
                    help="architecture whose smoke config is served")
    ap.add_argument("--layers", type=int, default=None,
                    help="number of layers (default: the smoke config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--paged", action="store_true",
                    help="serve from paged KV caches")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan-load-scale", type=float, default=30.0)
    ap.add_argument("--out", default="",
                    help="write full E2EResult JSON here")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    run = run_cosim(cfg, device=args.device, policy=args.policy,
                    scenario=args.scenario, site=args.site, depth=args.depth,
                    ticks=args.ticks, users=args.users, sites=args.sites,
                    seed=args.seed, paged=args.paged,
                    plan_load_scale=args.plan_load_scale)
    d = run.result.to_json()
    print(f"{d['name']}: offered {d['offered_requests']} reqs "
          f"({d['offered_tokens']} tok), completed {d['completed']}, "
          f"slo-goodput {d['slo_goodput_fraction']:.3f} "
          f"(raw {d['goodput_fraction']:.3f}), "
          f"p99 ttft {d['p99_ttft']:.0f} / tbt {d['p99_tbt']:.2f} ticks, "
          f"dup {d['duplicated_tokens']}, "
          f"preempt {d['preemptions']} resume {d['resumes']}; "
          f"{run.counts['engine_steps']} engine steps in "
          f"{run.wall_seconds:.2f} s on {resolve_device(args.device)}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(d, f, indent=1, sort_keys=True)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
