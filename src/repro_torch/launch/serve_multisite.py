"""Serve a burst of requests across wind-site engines by Heron's weights.

Port of the reference's ``examples/serve_multisite.py``: an arch's reduced
smoke config served by one engine per site, the sites weighted by Heron
(``launch.serve.heron_site_weights``), every request arriving at once (the
shape a power-drop reroute produces). It exercises the admission pipeline
(``--admit-mode``: batched bucket prefills and chunked tails, the serial
reference for an A/B, or async admission interleaved with decode under
``--admit-budget``), then checks that every request completed and that
each site's p99 TTFT is at least its p50.

  PYTHONPATH=src python -m repro_torch.launch.serve_multisite
  PYTHONPATH=src python -m repro_torch.launch.serve_multisite --device cpu \\
      --admit-mode async --admit-budget 16
"""
from __future__ import annotations

from repro_torch.launch.serve import build_parser, serve_from_args


def main(argv=None) -> int:
    out = serve_from_args(build_parser(__doc__).parse_args(argv))
    if out["completed"] != out["submitted"]:
        raise SystemExit(f"served {out['completed']} of {out['submitted']}")
    for i, s in enumerate(out["per_site"]):
        # the tails are what a burst moves: admission cost lands in p99
        # TTFT long before it moves the mean
        if not s["p99_ttft"] >= s["p50_ttft"] >= 0.0:
            raise SystemExit(f"site {i}: p99 TTFT {s['p99_ttft']} below "
                             f"p50 {s['p50_ttft']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
