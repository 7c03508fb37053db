"""JSON run records under artifacts/ — shared by simulators and launch tools.

One tiny contract: ``write_record(path, payload)`` creates parent
directories and writes indented JSON (numpy scalars coerced via
``default=float``); ``load_record(path)`` reads it back. The week/fine
simulators persist their results here (``artifacts/sim/``) so benchmarks
can *reload* a run instead of re-simulating it, and the dry-run launcher
uses the same writer for its ``artifacts/dryrun/`` reports.
"""
from __future__ import annotations

import json
import os


def write_record(path: str, payload: dict) -> str:
    """Write ``payload`` as JSON at ``path``, creating directories."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return path


def load_record(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
