from repro_torch.data.wind import WindSite, WindFleet, make_default_fleet
from repro_torch.data.workload import WorkloadTrace, make_trace, CLASSES

__all__ = ["WindSite", "WindFleet", "make_default_fleet", "WorkloadTrace",
           "make_trace", "CLASSES"]
