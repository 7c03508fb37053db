"""Heron co-sim: the fleet of serving engines under the control plane."""
