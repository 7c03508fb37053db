#!/usr/bin/env python3
"""Quickest proof that the PyTorch + CUDA port runs on an NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: the card, its power limit, TF32 off;
  2. build: both CUDA kernels with nvcc, from src/repro_torch/kernels/csrc,
     one nvcc per source, started together;
  3. kernels: each kernel against its plain PyTorch version at the serving
     path's shapes, with its time, the plain version's, one library call's
     (a yardstick the port never calls) and the least time the card could
     take;
  4. serve: llama3.2-1b at its published width (random weights from a
     seed) behind two site engines, 16 requests; every request completes,
     both kernels' launch counts match the model calls, and one prompt's
     logits match the plain path's.
Prints the kernel table as one JSON line, then the device line last.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# kernel vs plain: bf16 outputs round once to 8 mantissa bits on each side
# (adjacent roundings of |x| < 4 differ by <= 1.6e-2); fp32 differs only in
# the order of up to 1024-term sums
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# kernel path vs plain path, first-token logits of a 16-layer bf16 model:
# each layer's attention output differs by up to one bf16 rounding, which
# the later layers carry into logits of std ~1
LOGIT_BOUND = 0.25
SEED = 0


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, flush, reps: int = 30) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up,
    with L2 flushed before each run (the serving path reads each layer's
    cache cold)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in times)


def bound(nbytes: float, flops: float, peak: float):
    mem, ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(mem, ops) * 1e3, ("bytes" if mem >= ops else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from repro_torch.configs import llama32_1b
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import demo_requests, serve_demo
    from repro_torch.models.api import build as build_model

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32 matmul=False cudnn=False")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    logs = build.build(["flash_attention", "decode_attention"])
    print(f"[build] {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}")

    # --------------------------------------------------------- 3. kernels
    gen = torch.Generator(device=dev).manual_seed(SEED)
    l2 = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    flush = l2.zero_
    H, KVH, G = 32, 8, 4
    rows = {}

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def compare(name, got, want, dtype, case):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        ok = bool((err <= TOL[dtype] * (1 + want.float().abs())).all())
        check(torch.isfinite(got).all().item(), f"{name} {case}: non-finite")
        check(ok, f"{name} {case}: max err {err.max().item():.3g} over "
                  f"bound {TOL[dtype]} (abs + rel)")
        r = rows.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err.max().item())
        print(f"  {name} {case}: max |kernel - plain| {err.max().item():.3g}"
              f" (bound {TOL[dtype]} abs + rel)")

    print("[kernels] flash_attention vs attention_ref")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for B, S, hd, prefix in [(4, 5, 64, 0), (4, 16, 64, 0),
                                 (4, 300, 64, 0), (4, 512, 64, 0),
                                 (4, 300, 64, 100), (4, 300, 128, 0)]:
            q = rnd(B, S, H, hd, dtype=dt)
            k, v = rnd(B, S, KVH, hd, dtype=dt), rnd(B, S, KVH, hd, dtype=dt)
            compare("flash_attention",
                    flash_attention(q, k, v, causal=True, prefix_len=prefix),
                    ref.attention_ref(q, k, v, causal=True,
                                      prefix_len=prefix),
                    dtype, f"{dtype} B={B} S={S} hd={hd} prefix={prefix}")

    print("[kernels] decode_attention vs decode_attention_ref")
    S_dec = 1024
    lens_main = torch.tensor([1, 7, 333, S_dec, S_dec + 9, 512, 100, 999],
                             dtype=torch.int32, device=dev)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for hd in (64, 128):
            q = rnd(8, H, hd, dtype=dt)
            kc = rnd(8, S_dec, KVH, hd, dtype=dt)
            vc = rnd(8, S_dec, KVH, hd, dtype=dt)
            compare("decode_attention",
                    decode_attention(q, kc, vc, lens_main),
                    ref.decode_attention_ref(q, kc, vc, lens_main), dtype,
                    f"{dtype} B=8 S={S_dec} hd={hd} lengths="
                    f"{lens_main.tolist()}")

    print("[kernels] times (bf16, CUDA events, median of 30, L2 flushed)")
    bf = torch.bfloat16
    for S in (5, 16, 300, 512):
        B, hd = 4, 64
        q = rnd(B, S, H, hd, dtype=bf)
        k, v = rnd(B, S, KVH, hd, dtype=bf), rnd(B, S, KVH, hd, dtype=bf)
        kr, vr = (t.repeat_interleave(G, dim=2).transpose(1, 2)
                  for t in (k, v))
        qt = q.transpose(1, 2)
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True), flush)
        plain = time_ms(lambda: ref.attention_ref(q, k, v, causal=True), flush)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kr, vr, is_causal=True), flush)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4.0 * B * H * hd * (S * (S + 1) / 2)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        print(f"  flash_attention B={B} S={S} hd={hd}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f}, library {lib:.4f}, bound {b_ms:.5f} "
              f"({b_by}) -> {b_ms / ms:.1%} of bound")
        if S == 512:
            rows["flash_attention"].update(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, shape=f"bf16 B={B} Sq=Sk={S} H={H} KVH={KVH} "
                f"hd={hd} causal")
    hd = 64
    q = rnd(8, H, hd, dtype=bf)
    kc, vc = rnd(8, S_dec, KVH, hd, dtype=bf), rnd(8, S_dec, KVH, hd, dtype=bf)
    mask = (torch.arange(S_dec, device=dev)[None, :]
            < lens_main[:, None])[:, None, None, :]
    kr, vr = (t.repeat_interleave(G, dim=2).transpose(1, 2) for t in (kc, vc))
    qt = q[:, :, None, :]
    ms = time_ms(lambda: decode_attention(q, kc, vc, lens_main), flush)
    plain = time_ms(lambda: ref.decode_attention_ref(q, kc, vc, lens_main),
                    flush)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kr, vr, attn_mask=mask), flush)
    keys = int(lens_main.clamp(max=S_dec).sum())
    nbytes = 2 * (2 * q.numel() + 2 * keys * KVH * hd) + 4 * 8
    b_ms, b_by = bound(nbytes, 4.0 * H * hd * keys, BF16_FLOP_PER_S)
    print(f"  decode_attention B=8 S={S_dec} hd={hd} ragged: kernel {ms:.4f} ms, "
          f"plain {plain:.4f}, library {lib:.4f}, bound {b_ms:.5f} ({b_by}) "
          f"-> {b_ms / ms:.1%} of bound")
    rows["decode_attention"].update(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
        shape=f"bf16 B=8 S={S_dec} H={H} KVH={KVH} hd={hd} "
        f"lengths={lens_main.tolist()}")
    del l2, q, kc, vc, kr, vr, mask
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 4. serve
    cfg = llama32_1b
    L = cfg.num_layers
    serve_kw = dict(num_requests=16, num_sites=2, seed=SEED,
                    prompt_len=(16, 701), new_tokens=(8, 33))
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention.launches = 0
    decode_attention.launches = 0
    out = serve_demo(cfg, max_batch=8, max_seq=1024, device="cuda",
                     **serve_kw)
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    sites = out["per_site"]
    check(out["completed"] == out["submitted"] == 16,
          f"served {out['completed']}/{out['submitted']}")
    prefill_calls = sum(s["prefill_calls"] - s["extend_chunks"]
                        for s in sites)
    decode_calls = sum(s["decode_steps"] for s in sites)
    check(launches["flash_attention"] > 0 and launches["decode_attention"] > 0,
          f"a kernel was not launched on the serving path: {launches}")
    check(launches["flash_attention"] == L * prefill_calls,
          f"flash launches {launches['flash_attention']} != {L} x "
          f"{prefill_calls} prefill calls")
    check(launches["decode_attention"] == L * decode_calls,
          f"decode launches {launches['decode_attention']} != {L} x "
          f"{decode_calls} decode calls")
    reqs = demo_requests(cfg, **serve_kw)
    served = sum(s["served_tokens"] for s in sites)
    check(served == sum(r.max_new_tokens for _, r in reqs),
          f"served {served} tokens")
    print(f"[serve] {cfg.name} L={L} d={cfg.d_model} H={cfg.num_heads} "
          f"KVH={cfg.num_kv_heads} V={cfg.vocab_size} bf16: "
          f"{out['completed']}/16 requests, {served} tokens in "
          f"{out['wall_seconds']:.3f} s ({served / out['wall_seconds']:.1f} "
          f"tok/s), peak memory {peak_gb:.2f} GB")
    for i, s in enumerate(sites):
        print(f"  site {i}: {s['num_completed']} requests, prefill calls "
              f"{s['prefill_calls'] - s['extend_chunks']}, extend chunks "
              f"{s['extend_chunks']}, decode steps {s['decode_steps']}, "
              f"TTFT mean {s['mean_ttft'] * 1e3:.1f} / p99 "
              f"{s['p99_ttft'] * 1e3:.1f} ms, TBT mean "
              f"{s['mean_tbt'] * 1e3:.2f} / p99 {s['p99_tbt'] * 1e3:.2f} ms")
    print(f"  launches on the serving path: {launches}")

    prompt = torch.as_tensor(reqs[0][1].prompt[None, :])
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(SEED))
    with torch.no_grad():
        got, _ = build_model(cfg).prefill_fn(params, {"tokens": prompt})
        want, _ = build_model(cfg, reference=True).prefill_fn(
            params, {"tokens": prompt})
    torch.cuda.synchronize()
    check(got.shape == (1, cfg.vocab_size) and bool(torch.isfinite(got).all()),
          f"logits shape {tuple(got.shape)} or non-finite")
    lerr = (got.float() - want.float()).abs().max().item()
    check(lerr <= LOGIT_BOUND, f"logits differ by {lerr:.3g} > {LOGIT_BOUND}")
    print(f"[serve] request 0 (prompt {prompt.shape[1]} tokens) first-token "
          f"logits, kernel path vs plain path: max |diff| {lerr:.4g} "
          f"(bound {LOGIT_BOUND}), argmax {int(got.argmax())} vs "
          f"{int(want.argmax())}")

    # ---------------------------------------------------------- 5. report
    src = {"flash_attention": ("flash_attention.py:96", "flash_attention"),
           "decode_attention": ("decode_attention.py:92", "decode_attention")}
    table = []
    for name, r in rows.items():
        tpu_line, fn = src[name]
        table.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{tpu_line}",
            "tpu_source": f"src/repro/kernels/{name}.py:{fn}",
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    print(smi)                        # the card, as nvidia-smi gives it
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
