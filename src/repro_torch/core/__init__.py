"""Heron — the paper's primary contribution (cross-site router)."""
from repro_torch.core.lookup import LookupTable, build_table
from repro_torch.core.planner_l import Plan, SiteSpec, plan_l
from repro_torch.core.planner_s import plan_s
from repro_torch.core.planning import (ColumnPool, ConstraintBuilder, GpuBudget,
                                 plan_objective)
from repro_torch.core.router import HeronRouter
from repro_torch.core.scheduler import Configurator, RequestScheduler

__all__ = ["LookupTable", "build_table", "Plan", "SiteSpec", "plan_l",
           "plan_s", "HeronRouter", "Configurator", "RequestScheduler",
           "ColumnPool", "ConstraintBuilder", "GpuBudget", "plan_objective"]
