"""The 4-site paper grid — the §5 evaluation testbed, built once.

Benchmarks, tests, and examples all evaluate on the same construction:
the paper trace, the lookup table on the 4-point load grid, the default
wind fleet right-sized at the 20th-percentile threshold
(pods = P20 // SuperPOD peak), and generation clipped to that threshold.
This helper is the single copy; change the grid here and every consumer
moves together (the equivalence suite pins results on this grid).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs import PAPER_MODEL
from repro_torch.core.lookup import LookupTable, build_table
from repro_torch.core.planner_l import SiteSpec
from repro_torch.data.wind import make_default_fleet
from repro_torch.data.workload import make_trace
from repro_torch.power.model import H100_DGX, SUPERPOD_GPUS, SUPERPOD_PEAK_MW

GRID = dict(load_grid=(0.25, 1.0, 4.0, 16.0), freq_grid=(1.2, 2.0))


@dataclass
class PaperGrid:
    trace: object
    table: LookupTable
    sites: list[SiteSpec]
    power_mw: np.ndarray        # [S, 672] generation clipped at P20
    arrivals_rps: np.ndarray    # [9, 672] at the requested multiplier

    def arrivals_at(self, multiplier: float) -> np.ndarray:
        """Per-class rps at another volume multiplier."""
        return self.trace.class_arrivals(multiplier=multiplier) / (15 * 60)


def paper_grid(trace_name: str = "coding", *, multiplier: float = 60.0,
               trace_seed: int = 11, fleet_seed: int = 7) -> PaperGrid:
    trace = make_trace(trace_name, base_rps=1.0, seed=trace_seed)
    table = build_table(PAPER_MODEL, trace, H100_DGX, **GRID)
    fleet = make_default_fleet(seed=fleet_seed)
    sites, thr = [], []
    for s in fleet.sites:
        pods = int(s.percentile_mw(20.0) // SUPERPOD_PEAK_MW)
        sites.append(SiteSpec(s.name, pods * SUPERPOD_GPUS))
        thr.append(s.percentile_mw(20.0))
    power = np.minimum(fleet.week(), np.array(thr)[:, None])
    arrivals = trace.class_arrivals(multiplier=multiplier) / (15 * 60)
    return PaperGrid(trace=trace, table=table, sites=sites,
                     power_mw=power, arrivals_rps=arrivals)
