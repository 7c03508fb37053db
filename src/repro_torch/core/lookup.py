"""Profiling lookup tables — paper K2 / §5.1.

The paper runs a deep power-profiling benchmark (H100 DGX + vLLM + DCGM,
Llama-3.1-70B) and distills it into two functions consumed by the planners:

    e2e(c, f, t, l)    end-to-end latency of class-c requests at load l
                       on a TP-t instance at frequency f
    power(c, f, t, l)  peak instance power at that operating point

The tables are *derived* from an analytical roofline model: per-class
prefill/decode latencies from FLOPs / HBM bytes / TP-collective bytes at
the chosen hardware profile, continuous-batching steady state via Little's
law, M/G/1 queueing inflation, and the DVFS power model. The table
*interface* is identical to the paper's (~2,000 rows after SLO filtering;
rows violating TTFT/TBT SLOs are excluded, like the grey cells of Fig 13).

Replicated paper behaviours (validated in tests/test_lookup.py):
  * higher TP or higher frequency → lower latency, higher power;
  * higher load → latency and power both inflate;
  * smallest TP cannot sustain high load for mid/large classes (SLO cut);
  * coding (longer inputs) sustains lower loads than conversation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.workload import CLASSES, WorkloadTrace
from repro_torch.power.model import (HardwareModel, H100_DGX, NODE_MULTIPLIER,
                               accelerator_power)

BYTES = 2                      # bf16 weights/activations
SLO_MULTIPLIER = 5.0           # paper: 5x isolated TTFT/TBT at TP_max, f_max
LOAD_GRID = (0.015625, 0.03125, 0.0625, 0.125, 0.25, 0.5, 1.0, 2.0, 4.0,
             8.0, 16.0, 32.0)
MAX_UTIL = 0.95                # queueing stability bound
MFU_PREFILL = 0.55
MFU_DECODE = 0.35


@dataclass(frozen=True)
class ClassProfile:
    name: str
    mean_in: float
    mean_out: float


@dataclass(frozen=True)
class Row:
    cls: int                   # index into CLASSES
    tp: int
    freq: float
    load: float                # requests/s
    ttft: float                # s (queue included)
    tbt: float                 # s/token at steady-state batch
    e2e: float                 # s
    power: float               # instance peak power [W]
    util: float
    batch: float               # steady-state decode batch


@dataclass(frozen=True)
class ClassSLO:
    """Per-class deadline references (isolated run at TP_max / f_max).

    ``slo_ttft``/``slo_tbt`` are the absolute wall-clock deadlines the
    paper uses to filter table rows (5x the isolated reference). The raw
    references (``t_ref``, ``tbt_ref``) are kept so a consumer on a
    *virtual* clock — where one engine tick is one nominal token time —
    can rescale: ttft_deadline_ticks = SLO_MULTIPLIER * t_ref / tbt_ref,
    tbt_deadline_ticks = SLO_MULTIPLIER.
    """
    t_ref: float               # isolated prefill time [s]
    tbt_ref: float             # isolated per-token decode time [s]
    slo_ttft: float            # = SLO_MULTIPLIER * t_ref
    slo_tbt: float             # = SLO_MULTIPLIER * tbt_ref

    def ttft_deadline_ticks(self, tick_tokens: float = 1.0) -> float:
        """TTFT deadline in virtual-clock ticks (1 tick ≡ ``tick_tokens``
        nominal token times at the isolated reference)."""
        return SLO_MULTIPLIER * self.t_ref / (self.tbt_ref * tick_tokens)

    def tbt_deadline_ticks(self, tick_tokens: float = 1.0) -> float:
        return SLO_MULTIPLIER / tick_tokens


class LookupTable:
    """Dense-keyed lookup with the paper's (c, f, t, l) accessors."""

    def __init__(self, arch: str, hw: HardwareModel, classes, rows,
                 slos: Optional[list["ClassSLO"]] = None):
        self.arch = arch
        self.hw = hw
        self.classes: list[ClassProfile] = classes
        self.rows: list[Row] = rows
        # per-class SLO references; absent only for hand-built tables
        self.slos: list[ClassSLO] = slos or []
        self._by_key = {(r.cls, r.freq, r.tp, r.load): r for r in rows}
        self._by_class: dict[int, list[Row]] = {}
        for r in rows:
            self._by_class.setdefault(r.cls, []).append(r)

    def e2e(self, c: int, f: float, t: int, l: float) -> float:
        return self._by_key[(c, f, t, l)].e2e

    def power(self, c: int, f: float, t: int, l: float) -> float:
        return self._by_key[(c, f, t, l)].power

    def get(self, c, f, t, l) -> Optional[Row]:
        return self._by_key.get((c, f, t, l))

    def valid_rows(self, c: int) -> list[Row]:
        return self._by_class.get(c, [])

    def __len__(self):
        return len(self.rows)


# ------------------------------------------------------------------
# analytical serving model
# ------------------------------------------------------------------
def _prefill_time(cfg: ModelConfig, hw: HardwareModel, L_in: float, tp: int,
                  rel_f: float) -> float:
    """One prompt through the model on a TP-``tp`` instance."""
    flops = cfg.flops_per_token(L_in, "prefill") * L_in
    t_compute = flops / (tp * hw.peak_flops * rel_f * MFU_PREFILL)
    weight_bytes = cfg.active_param_count() * BYTES / tp
    t_mem = weight_bytes / hw.hbm_bw
    # TP collectives: 2 all-reduces of [L_in, d] per layer, ring 2(t-1)/t
    coll = (cfg.num_layers * 2 * 2 * (tp - 1) / tp
            * L_in * cfg.d_model * BYTES / hw.link_bw) if tp > 1 else 0.0
    return max(t_compute, t_mem) + coll


def _tbt_coeffs(cfg: ModelConfig, hw: HardwareModel, ctx: float, tp: int,
                rel_f: float) -> tuple[float, float]:
    """TBT(batch n) = W + K·n (weight read + per-sequence cost)."""
    W = cfg.active_param_count() * BYTES / (tp * hw.hbm_bw)
    if tp > 1:
        W += cfg.num_layers * 2 * 2 * (tp - 1) / tp * cfg.d_model * BYTES / hw.link_bw
    kv = cfg.kv_bytes_per_token() * ctx / (tp * hw.hbm_bw)
    comp = cfg.flops_per_token(ctx, "decode") / (tp * hw.peak_flops * rel_f * MFU_DECODE)
    K = kv + comp
    return W, K


def _row(cfg, hw, c_idx, cp: ClassProfile, tp, freq, load) -> Optional[Row]:
    rel_f = freq / hw.f_max
    L_in, L_out = cp.mean_in, cp.mean_out
    ctx = L_in + L_out / 2
    t_pref = _prefill_time(cfg, hw, L_in, tp, rel_f)
    W, K = _tbt_coeffs(cfg, hw, ctx, tp, rel_f)
    # steady-state decode batch: n = load * L_out * TBT(n)  (Little's law)
    denom = 1.0 - load * L_out * K
    if denom <= 1e-6:
        return None                       # token throughput cap exceeded
    n = load * L_out * W / denom
    tbt = W + K * n
    # utilization: each request exclusively costs prefill + L_out*K seconds
    rho = load * (t_pref + L_out * K)
    if rho >= MAX_UTIL:
        return None
    service = t_pref + L_out * tbt
    wait = rho / (1.0 - rho) * service / 2.0        # M/G/1-ish inflation
    ttft = wait + t_pref
    e2e = wait + service
    # power: compute-rate utilisation (decode is memory-bound -> low util)
    flops_rate = load * (cfg.flops_per_token(L_in, "prefill") * L_in
                         + cfg.flops_per_token(ctx, "decode") * L_out)
    util = min(1.0, flops_rate / (tp * hw.peak_flops * rel_f * MFU_PREFILL))
    util_peak = min(1.0, 0.25 + util * 1.25)        # transient headroom
    power = tp * accelerator_power(hw, util_peak, freq) * NODE_MULTIPLIER
    return Row(cls=c_idx, tp=tp, freq=freq, load=load, ttft=ttft, tbt=tbt,
               e2e=e2e, power=power, util=util, batch=n)


def class_profiles(trace: WorkloadTrace) -> list[ClassProfile]:
    return [ClassProfile(CLASSES[i], mi, mo)
            for i, (mi, mo) in enumerate(trace.mean_lengths())]


def build_table(cfg: ModelConfig, trace: WorkloadTrace,
                hw: HardwareModel = H100_DGX,
                load_grid=LOAD_GRID, freq_grid=None) -> LookupTable:
    """The full profiling exercise -> SLO-filtered lookup table.

    ``freq_grid``/``load_grid`` subsets shrink the planner ILPs (the week
    simulator uses a 4x5 grid; standalone profiling benches use the full
    7x10 = paper-scale ~2,000-row table).
    """
    classes = class_profiles(trace)
    rows: list[Row] = []
    slos: list[ClassSLO] = []
    freqs = tuple(freq_grid) if freq_grid is not None else hw.frequencies
    tp_max, f_max = max(hw.tp_degrees), hw.f_max
    for c_idx, cp in enumerate(classes):
        # isolated reference at TP_max / f_max defines the class SLOs
        t_ref = _prefill_time(cfg, hw, cp.mean_in, tp_max, 1.0)
        W, K = _tbt_coeffs(cfg, hw, cp.mean_in + cp.mean_out / 2, tp_max, 1.0)
        slo = ClassSLO(t_ref=t_ref, tbt_ref=W + K,
                       slo_ttft=SLO_MULTIPLIER * t_ref,
                       slo_tbt=SLO_MULTIPLIER * (W + K))
        slos.append(slo)
        for tp in hw.tp_degrees:
            for freq in freqs:
                for load in load_grid:
                    r = _row(cfg, hw, c_idx, cp, tp, freq, load)
                    if r is None or r.ttft > slo.slo_ttft or r.tbt > slo.slo_tbt:
                        continue
                    rows.append(r)
    return LookupTable(cfg.name, hw, classes, rows, slos=slos)
