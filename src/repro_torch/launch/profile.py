"""Where the serving path's time goes on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile [--paged]
  PYTHONPATH=src python -m repro_torch.launch.profile --arch rwkv6-1.6b
  PYTHONPATH=src python -m repro_torch.launch.profile \
      --arch phi3.5-moe-42b-a6.6b --layers 8
  PYTHONPATH=src python -m repro_torch.launch.profile \
      --arch paligemma-3b [--paged]
  PYTHONPATH=src python -m repro_torch.launch.profile \
      --arch deepseek-v2-236b --layers 6
  PYTHONPATH=src python -m repro_torch.launch.profile --arch zamba2-7b

Runs ``serve_demo`` at an arch's full width (default llama3.2-1b) and
published depth, or at ``--layers`` layers (phi3.5-moe needs 8: its 32
do not fit one 80 GB card; deepseek-v2-236b 6 of its 60), three times with the same arguments as
``chip_smoke.py``: once to warm up (cuBLAS handles, lazily loaded
kernels, the kernel build), once warm to read the engine metrics
undisturbed, and once under ``torch.profiler``; ``--paged`` serves from
the paged KV cache at the default pool, as ``chip_smoke.py`` phase 4b
does. Prints the warm metrics,
the device's busy share in the profiled run (summed kernel time over wall
time), the kernel launches per model call, the top kernels by device
time, each hand-written kernel's device time, launches and share (one
row per instantiation, labelled with the TPU kernel it replaces: the
dense and paged decode run one body, told apart by its template flag),
the top operators by host time and the host's cudaStreamSynchronize
calls.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS
from repro_torch.launch.serve import full_width_config, serve_demo

# chip_smoke.py's serving traffic, uniform site weights included
SERVE = dict(num_requests=16, num_sites=2, max_batch=8, max_seq=1024,
             seed=0, prompt_len=(16, 701), new_tokens=(8, 33),
             site_weights=(1.0, 1.0), device="cuda", verbose=False)


# the __global__ functions of kernels/csrc, by the kernel number of the
# TPU kernel each replaces
CSRC_KERNELS = {"flash_fwd": "1", "flash_fwd_mma": "1",
                "paged_extend_fwd": "5", "paged_extend_fwd_mma": "5",
                "expert_gemm": "6", "expert_gemm_mma": "6",
                "wkv6_chunked": "7"}


def csrc_kernel(key: str):
    """(label, name) of a profiler kernel row that is one of kernels/csrc,
    else None. The name drops the return type and namespaces and keeps
    the template arguments; the decode body's instantiations are kernel 2
    (dense), 3 (dense int8), 4 (paged) or 4-int8 by its kPaged flag and
    cache type."""
    head = key.replace("(anonymous namespace)::", "").split("(", 1)[0]
    head = head.removeprefix("void ")
    qual, _, targs = head.partition("<")
    fn = qual.split("::")[-1]
    name = fn + ("<" + targs if targs else "")
    if fn == "decode_split_fwd":
        args = [a.strip() for a in targs.rstrip(">").split(",")]
        int8 = len(args) > 1 and args[1] == "signed char"
        paged = args[-1] == "true"
        label = ("4" if paged else "2") if not int8 else (
            "4-int8" if paged else "3")
        return f"kernel {label}", name
    if fn in CSRC_KERNELS:
        return f"kernel {CSRC_KERNELS[fn]}", name
    return None


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _report(label: str, out: dict) -> None:
    for i, s in enumerate(out["per_site"]):
        print(f"[{label}] site {i}: {s['num_completed']} requests, "
              f"{s['served_tokens']} tokens, prefill calls "
              f"{s['prefill_calls'] - s['extend_chunks']}, extend chunks "
              f"{s['extend_chunks']}, decode steps {s['decode_steps']}, "
              f"TTFT mean {s['mean_ttft'] * 1e3:.1f} / p99 "
              f"{s['p99_ttft'] * 1e3:.1f} ms, TBT mean "
              f"{s['mean_tbt'] * 1e3:.2f} / p99 {s['p99_tbt'] * 1e3:.2f} ms")
    tokens = sum(s["served_tokens"] for s in out["per_site"])
    print(f"[{label}] wall {out['wall_seconds']:.3f} s, {tokens} tokens, "
          f"{tokens / out['wall_seconds']:.1f} tok/s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--paged", action="store_true",
                    help="profile the paged KV-cache engines")
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the published one); "
                         "phi3.5-moe-42b-a6.6b needs --layers 8 on one 80 GB "
                         "card, whose memory its 32 layers (83.7 GB of bf16 "
                         "weights) exceed, and deepseek-v2-236b --layers 6 "
                         "(49.8 GB; its 60 layers are 479 GB)")
    args = ap.parse_args(argv)
    serve = dict(SERVE, paged=args.paged)
    cfg = full_width_config(args.arch, args.layers)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    print(f"[model] {cfg.name} at full width, {cfg.num_layers} layers")
    t0 = time.perf_counter()
    serve_demo(cfg, **serve)
    print(f"[warm-up] {time.perf_counter() - t0:.3f} s")
    _report("warm", serve_demo(cfg, **serve))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = serve_demo(cfg, **serve)
        torch.cuda.synchronize()
    _report("profiled", out)
    wall = out["wall_seconds"]
    events = prof.key_averages()
    # kernel rows only: operator rows repeat their kernels' device time
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e) for e in kernels) / 1e6
    # every launch API, cudaLaunchKernel* and cuLaunchKernel*, with and
    # without launch attributes (the hand-written kernels launch through
    # cudaLaunchKernelEx, cuBLAS through cuLaunchKernelEx)
    by_api = {e.key: e.count for e in events
              if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel"))}
    launches = sum(by_api.values())
    calls = sum(s["prefill_calls"] + s["decode_steps"]
                for s in out["per_site"])
    print(f"[profiled] device busy {busy:.3f} s = {busy / wall:.1%} of "
          f"wall; {launches} kernel launches over {calls} model calls "
          f"({launches / calls:.0f} per call): {by_api}")
    print("[device] top 15 by self device time: total ms, calls, name")
    for e in sorted(kernels, key=_device_us, reverse=True)[:15]:
        print(f"  {_device_us(e) / 1e3:10.2f} {e.count:7d}  {e.key[:90]}")
    # each hand-written kernel's share of the device time, listed or not
    # above (the kernels of kernels/csrc, by function name)
    print("[device] hand-written kernels: total ms, calls, share of busy, "
          "kernel, name")
    for e in sorted(kernels, key=_device_us, reverse=True):
        hit = csrc_kernel(e.key)
        if hit:
            print(f"  {_device_us(e) / 1e3:10.2f} {e.count:7d} "
                  f"{_device_us(e) / 1e6 / busy:6.1%}  {hit[0]:15s} "
                  f"{hit[1][:70]}")
    print("[host] top 15 by self CPU time: total ms, calls, name")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:15]:
        print(f"  {e.self_cpu_time_total / 1e3:10.2f} {e.count:7d}  "
              f"{e.key[:90]}")
    # the host's waits on the device, listed or not above: a wrapper that
    # reads a device value adds one to every call
    syncs = [e for e in events if e.key == "cudaStreamSynchronize"]
    print(f"[host] cudaStreamSynchronize: "
          f"{sum(e.count for e in syncs)} calls, "
          f"{sum(e.self_cpu_time_total for e in syncs) / 1e3:.2f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
