"""Serving entry point: one serving engine per site, requests spread by site weight.

Port of ``repro/launch/serve.py``. The engines share one copy of the
weights on the device. Heron's site weights come, as in the reference,
from ``HeronRouter`` planning one slot over a lookup table of the served
model on H100 DGX hardware and the wind fleet's first slot of power
(``heron_site_weights``); a caller may pass its own ``site_weights``.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --sites 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch rwkv6-1.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch seamless-m4t-medium --admit-mode async --admit-budget 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch paligemma-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch deepseek-v2-236b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch zamba2-7b

The command line serves an arch's reduced smoke config on the CPU and
its published width (``full_width_config``, as ``chip_smoke.py`` and
``launch/profile.py`` serve it) on the card, whose kernels take only the
published head dims; ``--layers`` overrides the depth (phi3.5-moe needs 8
and deepseek-v2-236b 6 on one 80 GB card).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.lookup import build_table
from repro_torch.core.planner_l import SiteSpec
from repro_torch.core.router import HeronRouter
from repro_torch.data.wind import make_default_fleet
from repro_torch.data.workload import make_trace
from repro_torch.device import resolve_device
from repro_torch.models.api import build
from repro_torch.power.model import H100_DGX
from repro_torch.serving.engine import Request, ServingEngine

# the lookup table's grid: the paper grid's two H100 frequencies
# (sim/testbed.py) over three loads
LOAD_GRID = (0.25, 1.0, 4.0)
FREQ_GRID = (1.2, 2.0)


def full_width_config(arch: str, layers: Optional[int] = None
                      ) -> ModelConfig:
    """``arch`` at its published width, at ``layers`` layers (default: its
    published depth). A depth cut is the caller's, with its reason."""
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)


def heron_site_weights(cfg: ModelConfig, num_sites: int,
                       seed: int = 0) -> np.ndarray:
    """Heron's dispatch weight of each site, summed over the classes of
    one planned slot: ``HeronRouter`` plans over ``cfg``'s lookup table on
    H100 DGX hardware, sites of 64 GPUs and the wind fleet's first slot of
    power, under a conversation trace's first-slot load. Uniform when the
    plan places nothing."""
    trace = make_trace("conversation", base_rps=1.0, seed=seed)
    table = build_table(cfg, trace, H100_DGX, load_grid=LOAD_GRID,
                        freq_grid=FREQ_GRID)
    fleet = make_default_fleet(seed=seed)
    sites = [SiteSpec(s.name, num_gpus=64) for s in fleet.sites[:num_sites]]
    power_w = np.array([s.series_mw[0]
                        for s in fleet.sites[:num_sites]]) * 1e6
    load = trace.class_arrivals()[:, 0] / (15 * 60)
    plan = HeronRouter(table=table, sites=sites).step_slot(power_w, load)
    agg = np.zeros(num_sites)
    for rows in plan.wrr_weights().values():
        for s, _row, w in rows:
            agg[s] += w
    if agg.sum() <= 0:
        agg[:] = 1.0
    return agg / agg.sum()


def demo_requests(cfg: ModelConfig, *, num_requests: int, num_sites: int,
                  site_weights: Optional[Sequence[float]] = None,
                  seed: int = 0, prompt_len: tuple = (4, 24),
                  new_tokens: tuple = (2, 10)) -> list:
    """[(site, Request)]: prompt lengths and ``max_new_tokens`` drawn
    uniformly from the half-open ranges, sites by ``site_weights``."""
    w = np.ones(num_sites) if site_weights is None else np.asarray(
        site_weights, float)
    w = w / w.sum()
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num_requests):
        site = int(rng.choice(num_sites, p=w))
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(*prompt_len))
                              ).astype(np.int32)
        out.append((site, Request(rid=i, prompt=prompt,
                                  max_new_tokens=int(rng.integers(
                                      *new_tokens)))))
    return out


def serve_demo(cfg: Optional[ModelConfig] = None, *, num_requests: int = 32,
               num_sites: int = 2, max_batch: int = 4, max_seq: int = 128,
               seed: int = 0, device=None,
               site_weights: Optional[Sequence[float]] = None,
               prompt_len: tuple = (4, 24), new_tokens: tuple = (2, 10),
               paged: bool = False, page_size: int = 16,
               num_pages: Optional[int] = None,
               admit_mode: str = "batched",
               admit_token_budget: Optional[int] = None,
               params: Optional[dict] = None, reference: bool = False,
               verbose: bool = True) -> dict:
    """Serve ``num_requests`` over ``num_sites`` engines and return the
    summary: completed/submitted counts, wall time, each site's
    ``EngineMetrics.summary()``, the site weights and each completed
    request's tokens by request id. ``cfg=None`` serves
    the llama3.2-1b smoke config; weights are ``params`` (on ``device``)
    or random, drawn from ``seed``. ``reference`` serves through the
    kernels' plain versions (``build(cfg, reference=True)``).
    ``site_weights=None`` takes Heron's (``heron_site_weights``).
    ``paged``: every site serves from a paged KV cache of ``num_pages``
    pages (default the dense capacity) of ``page_size`` tokens (families
    without a paged layout, such as ssm, stay dense). ``admit_mode`` and
    ``admit_token_budget`` go to every engine (``ServingEngine``).
    """
    cfg = cfg or smoke_config("llama3.2-1b")
    dev = resolve_device(device)
    model = build(cfg, reference=reference)
    if params is None:
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(seed))
    engines = [ServingEngine(model, params, max_batch=max_batch,
                             max_seq=max_seq, seed=seed + i, paged=paged,
                             page_size=page_size, num_pages=num_pages,
                             admit_mode=admit_mode,
                             admit_token_budget=admit_token_budget)
               for i in range(num_sites)]
    w = (heron_site_weights(cfg, num_sites, seed) if site_weights is None
         else np.asarray(site_weights, float) / np.sum(site_weights))
    reqs = demo_requests(cfg, num_requests=num_requests, num_sites=num_sites,
                         site_weights=w, seed=seed, prompt_len=prompt_len,
                         new_tokens=new_tokens)

    t0 = time.perf_counter()
    for site, req in reqs:
        req.arrival_s = time.perf_counter()
        engines[site].submit(req)
    metrics = [e.run() for e in engines]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    per_site = [m.summary() for m in metrics]
    done = sum(s["num_completed"] for s in per_site)
    out = {"completed": done, "submitted": num_requests,
           "wall_seconds": dt, "per_site": per_site,
           "site_weights": w.tolist(),
           "tokens": {r.rid: list(r.tokens) for m in metrics
                      for r in m.completed}}
    if engines[0].paged:
        out["free_pages"] = [len(e._free_pages) for e in engines]
        out["num_pages"] = [e.num_pages for e in engines]
    if verbose:
        print(f"[serve] {done}/{num_requests} requests served across "
              f"{num_sites} sites in {dt:.2f}s on {dev}")
        for i, s in enumerate(per_site):
            print(f"  site {i}: {s['num_completed']} done, "
                  f"TTFT mean {s['mean_ttft']*1e3:.1f} / "
                  f"p99 {s['p99_ttft']*1e3:.1f} ms, "
                  f"mean E2E {s['mean_e2e']*1e3:.1f} ms, "
                  f"{s['prefill_calls']} admission calls")
    return out


def build_parser(description: str = __doc__) -> argparse.ArgumentParser:
    """The serving command line, shared by ``launch.serve_multisite``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS),
                    help="architecture served: its smoke config on the "
                         "CPU, its published width on the card")
    ap.add_argument("--layers", type=int, default=None,
                    help="number of layers (default: the served config's)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--sites", type=int, default=2)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--paged", action="store_true",
                    help="serve from a paged KV cache")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pages per site (default: the dense capacity)")
    ap.add_argument("--admit-mode", choices=("batched", "serial", "async"),
                    default="batched", help="the engines' admission path")
    ap.add_argument("--admit-budget", type=int, default=None,
                    help="max prompt tokens admitted per engine step")
    return ap


def serve_from_args(args: argparse.Namespace) -> dict:
    """``serve_demo`` on the config the parsed flags name: the arch's
    smoke config on the CPU, its published width on the card."""
    if resolve_device(args.device).type == "cpu":
        cfg = smoke_config(args.arch)
    else:
        cfg = full_width_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return serve_demo(cfg, num_requests=args.requests, num_sites=args.sites,
                      max_batch=args.max_batch, device=args.device,
                      paged=args.paged, page_size=args.page_size,
                      num_pages=args.num_pages, admit_mode=args.admit_mode,
                      admit_token_budget=args.admit_budget)


def main(argv=None) -> int:
    out = serve_from_args(build_parser().parse_args(argv))
    return 0 if out["completed"] == out["submitted"] else 1

if __name__ == "__main__":
    raise SystemExit(main())
