"""Accelerator power/performance model.

The paper profiles H100 DGX boxes with DCGM and drives two knobs: tensor
parallelism and GPU frequency (``nvidia-smi``, ms-scale). Frequency is a
first-class planner knob backed by an explicit analytical model:

    compute throughput  ∝ f / f_max
    HBM bandwidth       ⊥ f                      (memory clock unscaled)
    P(chip)             = P_idle + (P_peak - P_idle) · util · (f/f_max)^ALPHA

ALPHA = 2.4 approximates V·f scaling with DVFS voltage tracking (empir-
ically 2-3 on datacenter accelerators). The node multiplier 1.82× over the
accelerator aggregate is the paper's own constant (10.2 kW DGX vs 8×700 W).

The port keeps one hardware profile, ``H100_DGX`` (paper-faithful: TP ∈
{2,4,8}, 0.8-2.0 GHz); the router only sees lookup tables built from it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

ALPHA = 2.4                  # DVFS power exponent
NODE_MULTIPLIER = 1.82       # paper §5.1: whole-node / accelerator-aggregate


@dataclass(frozen=True)
class HardwareModel:
    name: str
    peak_flops: float            # per chip, bf16, at f_max [FLOP/s]
    hbm_bw: float                # per chip [B/s]
    hbm_capacity: float          # per chip [B]
    link_bw: float               # per-link interconnect [B/s]
    chip_peak_power: float       # accelerator-only peak draw [W]
    chip_idle_power: float       # accelerator idle draw [W]
    chips_per_node: int
    tp_degrees: tuple[int, ...]
    frequencies: tuple[float, ...]   # GHz knob values
    f_max: float
    mfu_dense: float = 0.5       # achievable matmul efficiency (prefill/train)
    pod_chips: int = 256

    def node_peak_power(self) -> float:
        return self.chips_per_node * self.chip_peak_power * NODE_MULTIPLIER


H100_DGX = HardwareModel(
    name="h100",
    peak_flops=989e12,           # bf16 dense, SXM
    hbm_bw=3.35e12,
    hbm_capacity=80e9,
    link_bw=450e9,               # NVLink per direction
    chip_peak_power=700.0,
    chip_idle_power=90.0,
    chips_per_node=8,
    tp_degrees=(2, 4, 8),
    frequencies=(0.8, 1.0, 1.2, 1.4, 1.6, 1.8, 2.0),
    f_max=2.0,
)

HARDWARE = {"h100": H100_DGX}


def accelerator_power(hw: HardwareModel, util: float, freq: float) -> float:
    """Per-chip power [W] at ``util`` in [0,1] and frequency ``freq`` [GHz]."""
    util = min(max(util, 0.0), 1.0)
    rel = min(freq / hw.f_max, 1.0)
    return hw.chip_idle_power + (hw.chip_peak_power - hw.chip_idle_power) * util * rel ** ALPHA


def instance_peak_power(hw: HardwareModel, tp: int, util: float, freq: float) -> float:
    """Whole-node-share power of a TP-``tp`` instance (paper's 1.82× applied)."""
    return tp * accelerator_power(hw, util, freq) * NODE_MULTIPLIER


# NVIDIA SuperPOD provisioning unit (paper §2.2): 1,016 H100s, 1.3 MW peak.
SUPERPOD_GPUS = 1016
SUPERPOD_PEAK_MW = 1.3
