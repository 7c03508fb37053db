"""Port serving entry point on the CPU, and the port's import boundary."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.launch import serve, serve_multisite
from repro_torch.launch.serve import (FREQ_GRID, LOAD_GRID, full_width_config,
                                      heron_site_weights, main, serve_demo)

SRC = Path(__file__).resolve().parents[1] / "src"


def test_serve_demo_completes_every_request():
    out = serve_demo(device="cpu", num_requests=6, num_sites=2, max_batch=2,
                     max_seq=64, seed=1, verbose=False)
    assert out["completed"] == out["submitted"] == 6
    assert sum(s["num_completed"] for s in out["per_site"]) == 6
    assert all(s["rejected"] == 0 for s in out["per_site"])
    assert out["site_weights"] == heron_site_weights(
        smoke_config("llama3.2-1b"), 2, seed=1).tolist()
    uniform = serve_demo(device="cpu", num_requests=2, num_sites=2,
                         max_batch=2, max_seq=64, site_weights=[3, 3],
                         verbose=False)
    assert uniform["site_weights"] == [0.5, 0.5]


def test_heron_site_weights_match_the_reference_modules():
    """The reference's ``serve_demo`` planning, on the reference's own
    numpy modules with the H100 DGX profile and the port's grid: the same
    site weights."""
    from repro.configs import smoke_config as ref_smoke_config
    from repro.core.lookup import build_table
    from repro.core.planner_l import SiteSpec
    from repro.core.router import HeronRouter
    from repro.data.wind import make_default_fleet
    from repro.data.workload import make_trace
    from repro.power.model import H100_DGX

    for num_sites, seed in ((2, 0), (3, 1)):
        trace = make_trace("conversation", base_rps=1.0, seed=seed)
        table = build_table(ref_smoke_config("llama3.2-1b"), trace,
                            H100_DGX, load_grid=LOAD_GRID,
                            freq_grid=FREQ_GRID)
        fleet = make_default_fleet(seed=seed)
        sites = [SiteSpec(s.name, num_gpus=64)
                 for s in fleet.sites[:num_sites]]
        power_w = np.array([s.series_mw[0]
                            for s in fleet.sites[:num_sites]]) * 1e6
        plan = HeronRouter(table=table, sites=sites).step_slot(
            power_w, trace.class_arrivals()[:, 0] / (15 * 60))
        want = np.zeros(num_sites)
        for rows in plan.wrr_weights().values():
            for s, _row, w in rows:
                want[s] += w
        want = want / want.sum()
        got = heron_site_weights(smoke_config("llama3.2-1b"), num_sites,
                                 seed)
        np.testing.assert_array_equal(got, want)
        assert got.max() < 1.0


def test_serve_demo_paged_returns_every_page():
    out = serve_demo(device="cpu", num_requests=6, num_sites=2, max_batch=2,
                     max_seq=64, seed=1, paged=True, num_pages=4,
                     verbose=False)
    assert out["completed"] == out["submitted"] == 6
    assert out["free_pages"] == out["num_pages"] == [4, 4]


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "rwkv6-1.6b",
                                  "qwen3-14b", "seamless-m4t-medium",
                                  "zamba2-7b"])
def test_serve_demo_new_families(arch):
    """The smoke configs of the moe, ssm, qk-norm dense, encdec and hybrid
    families through the entry point; the command line's
    ``--arch``/``--layers`` reach it."""
    out = serve_demo(smoke_config(arch), device="cpu", num_requests=6,
                     num_sites=2, max_batch=2, max_seq=64, seed=1,
                     verbose=False)
    assert out["completed"] == out["submitted"] == 6
    assert main(["--device", "cpu", "--arch", arch, "--layers", "1",
                 "--requests", "3", "--max-batch", "2"]) == 0


@pytest.mark.parametrize("mode", ["batched", "serial", "async"])
def test_serve_multisite_completes_every_request(mode, capsys):
    """The reference example's run on the port: every request of the burst
    completes, each site's p99 TTFT is at least its p50."""
    assert serve_multisite.main(["--device", "cpu", "--requests", "8",
                                 "--admit-mode", mode,
                                 "--admit-budget", "16"]) == 0
    assert "8/8 requests served" in capsys.readouterr().out


def test_serve_demo_async_returns_every_page():
    out = serve_demo(device="cpu", num_requests=6, num_sites=2, max_batch=2,
                     max_seq=64, seed=1, paged=True, num_pages=4,
                     admit_mode="async", admit_token_budget=8,
                     verbose=False)
    assert out["completed"] == out["submitted"] == 6
    assert out["free_pages"] == out["num_pages"] == [4, 4]
    sync = serve_demo(device="cpu", num_requests=6, num_sites=2,
                      max_batch=2, max_seq=64, seed=1, verbose=False)
    assert out["tokens"] == sync["tokens"]


def test_full_width_config_takes_depth_from_caller():
    phi = full_width_config("phi3.5-moe-42b-a6.6b")
    assert (phi.num_layers, phi.d_model, phi.num_experts) == (32, 4096, 16)
    assert full_width_config("rwkv6-1.6b").num_layers == 24
    cut = full_width_config("phi3.5-moe-42b-a6.6b", 8)
    assert (cut.num_layers, cut.d_model, cut.moe_d_ff) == (8, 4096, 6400)


def test_command_line_serves_published_width_on_the_card(monkeypatch):
    """The smoke configs' head dim 16 is none the kernels take, so on the
    card the command line serves the published width (``--layers`` still
    sets the depth); on the CPU the smoke config."""
    got = []
    monkeypatch.setattr(serve, "serve_demo",
                        lambda cfg, **kw: got.append((cfg, kw)) or {})
    monkeypatch.setattr(serve, "resolve_device",
                        lambda d: torch.device(d or "cuda"))
    args = serve.build_parser().parse_args(["--arch", "zamba2-7b",
                                            "--layers", "7"])
    serve.serve_from_args(args)
    args.device = "cpu"
    serve.serve_from_args(args)
    (card, card_kw), (cpu, _) = got
    assert card == full_width_config("zamba2-7b", 7)
    assert card.head_dim == 112 and card_kw["device"] is None
    assert cpu == dataclasses.replace(smoke_config("zamba2-7b"),
                                      num_layers=7)


def test_default_device_is_the_card(monkeypatch):
    """No silent drop to the CPU: the default device is CUDA, and asking
    for it without a card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.models.convert\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.kernels.paged_decode_attention\n"
        "import repro_torch.kernels.paged_extend_attention\n"
        "import repro_torch.kernels.decode_attention_int8\n"
        "import repro_torch.kernels.expert_matmul, repro_torch.kernels.wkv6\n"
        "import repro_torch.models.moe, repro_torch.models.rwkv6\n"
        "import repro_torch.models.mamba2\n"
        "import repro_torch.launch.profile, repro_torch.configs\n"
        "import repro_torch.models.transformer, repro_torch.serving.engine\n"
        "import repro_torch.launch.cosim, repro_torch.sim.e2e\n"
        "import repro_torch.core.router, repro_torch.checkpoint.store\n"
        "import repro_torch.launch.serve_multisite\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
