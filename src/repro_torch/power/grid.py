"""Grid-interactive power plane: prices, carbon intensity, batteries.

Heron (the paper) routes around power *drops*; the economic case behind
modular wind-site DCs points further — the fleet is a grid-interactive
asset that bids load up and down against electricity **price** and
grid-**carbon** signals and rides through trips on site batteries
(PAPERS.md: "Power-Flexible AI Data Centers", the Phoenix field demo,
XWind). This module is the state for that control dimension, shared by
the rate simulators and the scenario engine:

  * ``GridSignals`` — per-site electricity price curves [$ / MWh] and
    grid-carbon-intensity traces [gCO2 / kWh], ``[S, T]`` like the wind
    series. Scenario events (``PriceSpike`` / ``CarbonRamp``) perturb
    them through multiplicative ``price_factor`` / ``carbon_factor``
    planes with the same truth/knowledge split as power: surprises lag
    in the knowledge plane by their detection delay.
  * ``BatteryBank`` — a per-site battery/UPS state model
    (capacity / charge-rate / discharge-rate / one-way efficiency).
    Charges from surplus wind (power the plan did not draw), discharges
    to ride through grid trips and price spikes. ``step`` advances one
    tick and returns the extra MW actually delivered; energy ledgers
    (``energy_in_mwh`` / ``energy_out_mwh``) let tests assert no free
    energy ever appears (out <= in * round-trip efficiency, SoC always
    in [0, capacity * health]).

Units: MW / MWh / hours throughout (the simulators convert W <-> MW at
the boundary; a 15-min slot is ``dt_h = 0.25``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# Flat defaults when no trace is supplied: cheap wind-heavy node.
DEFAULT_PRICE_USD_MWH = 30.0      # long-run PPA-ish wind price
DEFAULT_CARBON_G_KWH = 20.0       # near-source wind carbon intensity


@dataclass
class GridSignals:
    """Per-site electricity price and grid-carbon-intensity traces.

    ``price_usd_mwh``/``carbon_g_kwh`` are ``[S, T]`` base curves; the
    compiled scenario's ``price_factor``/``carbon_factor`` multiply them
    per tick (truth plane) with ``known_*`` mirrors for what the planner
    can see.
    """
    price_usd_mwh: np.ndarray       # [S, T]
    carbon_g_kwh: np.ndarray        # [S, T]

    @classmethod
    def flat(cls, num_sites: int, ticks: int,
             price: float = DEFAULT_PRICE_USD_MWH,
             carbon: float = DEFAULT_CARBON_G_KWH) -> "GridSignals":
        return cls(price_usd_mwh=np.full((num_sites, ticks), float(price)),
                   carbon_g_kwh=np.full((num_sites, ticks), float(carbon)))

    def slot_cost_usd(self, energy_mwh: np.ndarray, tick: int,
                      factor: Optional[np.ndarray] = None) -> float:
        """$ for per-site energy [S] drawn during ``tick``."""
        p = self.price_usd_mwh[:, tick]
        if factor is not None:
            p = p * factor
        return float(np.dot(energy_mwh, p))

    def slot_carbon_g(self, energy_mwh: np.ndarray, tick: int,
                      factor: Optional[np.ndarray] = None) -> float:
        """gCO2 for per-site energy [S] drawn during ``tick``."""
        ci = self.carbon_g_kwh[:, tick]
        if factor is not None:
            ci = ci * factor
        return float(np.dot(energy_mwh * 1e3, ci))    # MWh -> kWh


@dataclass
class BatteryBank:
    """Per-site battery/UPS fleet state (vectorized over sites).

    One-way ``efficiency`` applies on both charge and discharge, so the
    round trip returns ``efficiency**2`` < 1 of the energy put in. SoC
    is stored energy [MWh]; ``health`` in [0, 1] derates usable capacity
    (the ``BatteryDegradation`` scenario hook).
    """
    capacity_mwh: np.ndarray        # [S]
    charge_rate_mw: np.ndarray      # [S] max grid->battery power
    discharge_rate_mw: np.ndarray   # [S] max battery->load power
    efficiency: float = 0.95        # one-way; round trip = efficiency**2
    soc_mwh: np.ndarray = field(default=None)        # [S] stored energy
    health: np.ndarray = field(default=None)         # [S] capacity derate
    energy_in_mwh: np.ndarray = field(default=None)   # [S] absorbed
    energy_out_mwh: np.ndarray = field(default=None)  # [S] delivered

    def __post_init__(self):
        self.capacity_mwh = np.asarray(self.capacity_mwh, float)
        self.charge_rate_mw = np.asarray(self.charge_rate_mw, float)
        self.discharge_rate_mw = np.asarray(self.discharge_rate_mw, float)
        if self.soc_mwh is None:
            self.soc_mwh = np.zeros_like(self.capacity_mwh)
        else:
            self.soc_mwh = np.asarray(self.soc_mwh, float).copy()
        if self.health is None:
            self.health = np.ones_like(self.capacity_mwh)
        else:
            self.health = np.asarray(self.health, float).copy()
        if self.energy_in_mwh is None:
            self.energy_in_mwh = np.zeros_like(self.capacity_mwh)
        else:
            self.energy_in_mwh = np.asarray(self.energy_in_mwh,
                                            float).copy()
        if self.energy_out_mwh is None:
            self.energy_out_mwh = np.zeros_like(self.capacity_mwh)
        else:
            self.energy_out_mwh = np.asarray(self.energy_out_mwh,
                                             float).copy()

    @classmethod
    def sized(cls, num_sites: int, capacity_mwh: float = 1.0,
              charge_rate_mw: float = 2.0, discharge_rate_mw: float = 2.0,
              efficiency: float = 0.95, soc_frac: float = 0.0
              ) -> "BatteryBank":
        cap = np.full(num_sites, float(capacity_mwh))
        return cls(capacity_mwh=cap,
                   charge_rate_mw=np.full(num_sites, float(charge_rate_mw)),
                   discharge_rate_mw=np.full(num_sites,
                                             float(discharge_rate_mw)),
                   efficiency=float(efficiency),
                   soc_mwh=cap * float(soc_frac))

    @property
    def usable_mwh(self) -> np.ndarray:
        """Per-site usable capacity after health derating."""
        return self.capacity_mwh * np.clip(self.health, 0.0, 1.0)

    def set_health(self, health: np.ndarray) -> None:
        """Apply a degradation trace sample; SoC above the derated
        capacity is lost (the cells can no longer hold it)."""
        self.health = np.clip(np.asarray(health, float), 0.0, 1.0)
        self.soc_mwh = np.minimum(self.soc_mwh, self.usable_mwh)

    def ride_through_mw(self, dt_h: float) -> np.ndarray:
        """Max extra MW each site can sustain for one ``dt_h`` tick —
        the knowledge-plane signal a battery-aware forecast adds on top
        of predicted wind."""
        return np.minimum(self.discharge_rate_mw,
                          self.soc_mwh * self.efficiency / dt_h)

    def step(self, avail_mw: np.ndarray, demand_mw: np.ndarray,
             dt_h: float) -> np.ndarray:
        """Advance one tick. Surplus wind (avail > demand) charges;
        deficit (demand > avail) discharges. Returns per-site MW
        actually delivered from the batteries (0 where charging)."""
        avail_mw = np.asarray(avail_mw, float)
        demand_mw = np.asarray(demand_mw, float)
        surplus = np.maximum(avail_mw - demand_mw, 0.0)
        deficit = np.maximum(demand_mw - avail_mw, 0.0)

        # charge: limited by the charger and by remaining headroom
        # (stored = drawn * efficiency)
        draw_mw = np.minimum(surplus, self.charge_rate_mw)
        headroom = np.maximum(self.usable_mwh - self.soc_mwh, 0.0)
        draw_mw = np.minimum(draw_mw, headroom / (self.efficiency * dt_h))
        stored = draw_mw * dt_h * self.efficiency
        self.soc_mwh = np.minimum(self.soc_mwh + stored, self.usable_mwh)
        self.energy_in_mwh = self.energy_in_mwh + draw_mw * dt_h

        # discharge: limited by the inverter and by stored energy
        # (delivered = withdrawn * efficiency)
        out_mw = np.minimum(deficit, self.discharge_rate_mw)
        out_mw = np.minimum(out_mw, self.soc_mwh * self.efficiency / dt_h)
        withdrawn = out_mw * dt_h / self.efficiency
        self.soc_mwh = np.maximum(self.soc_mwh - withdrawn, 0.0)
        self.energy_out_mwh = self.energy_out_mwh + out_mw * dt_h
        return out_mw

    def copy(self) -> "BatteryBank":
        return BatteryBank(capacity_mwh=self.capacity_mwh.copy(),
                           charge_rate_mw=self.charge_rate_mw.copy(),
                           discharge_rate_mw=self.discharge_rate_mw.copy(),
                           efficiency=self.efficiency,
                           soc_mwh=self.soc_mwh.copy(),
                           health=self.health.copy(),
                           energy_in_mwh=self.energy_in_mwh.copy(),
                           energy_out_mwh=self.energy_out_mwh.copy())
