#!/usr/bin/env python3
"""Quickest proof that the PyTorch + CUDA port runs on an NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: the card, its power limit, TF32 off, whether opt_einsum is
     there (without it torch contracts a many-operand einsum left to
     right);
  2. build: every CUDA kernel with nvcc, from src/repro_torch/kernels/csrc,
     one nvcc per source, started together; the registers, shared memory
     and spills of the flash attention, expert GEMM, paged extend, WKV6
     and decode (kernels 2, 3, 4, 4-int8: one body) kernels, and of the
     backward kernels of kernels 1 (hd 64, 112, 128 and 256), 6 and 7;
  3. kernels: each kernel against its plain PyTorch version at the serving
     path's shapes (the paged ones with all-sentinel rows and lengths past
     the table), with its time, the plain version's, one library call's
     where one exists (a yardstick the port never calls) and the least
     time the card could take; kernels 2 and 4 also with every row full,
     with one row alone and at hd 128;
  4. serve: llama3.2-1b at its published width (random weights from a
     seed) behind two site engines, 16 requests; every request completes,
     the kernels' launch counts match the model calls, and one prompt's
     logits match the plain path's;
  4b. paged serve: the same 16 requests through paged engines, at the
     default pool and at a pool small enough that admission waits; every
     page comes back, kernels 4 and 5 launch once per layer and call, and
     a 2-layer fp32 model at full width gives the dense streams;
  4c. int8: a prefilled batch quantized into a dense and a paged int8
     cache, one extend chunk and decode steps through kernels 3 and
     4-int8, logits against the plain path;
  4d. async: the same 16 requests through async admission (prompt tails
     interleaved with decode steps under the default token budget), dense
     and paged; every request completes with the batched run's stream,
     every page comes back, the kernels launch once per layer and model
     call, and a 2-layer fp32 model at full width gives the batched
     streams too;
  5. moe: phi3.5-moe at its published width, 8 of its 32 layers (the
     whole model does not fit one 80 GB card), the same 16 requests; the
     expert GEMM (kernel 6) launches three times per layer and model call,
     and one prompt's logits match the plain path's;
  6. ssm: rwkv6-1.6b whole, the same 16 requests; the WKV6 kernel
     (kernel 7) launches once per layer and admission call, and one
     prompt's logits match the plain path's at fp32, and at bf16 within
     twice the plain path's own spread between two chunk sizes;
  7. co-sim: Heron's fleet co-sim (``launch/cosim.py::run_cosim``: 4
     sites, 150,000 users, 120 ticks, Heron planning) over llama3.2-1b
     engines at its published width; 7a a partial grid trip over dense
     caches (kernels 1, 2), 7b a site failure over paged caches (kernels
     1, 4, 5), whose drained requests resume elsewhere. Each run's
     ``E2EResult`` counters equal those of the same run on the CPU with a
     1-layer fp32 model, no token is duplicated, every ledger balances
     and the kernels launch once per layer and model call; 7c a 2-layer
     fp32 model at full width, drained after 3 steps and resumed on an
     engine with another seed, gives the uninterrupted run's streams,
     dense and paged;
  8. new families: qwen3-14b whole (qk-norm, 40 heads over 8 KV heads)
     and seamless-m4t-medium whole (encoder-decoder: 12 + 12 layers, its
     encoder over 160 zero frames, cross-attention in every decoder
     layer), the same 16 requests, dense and paged; every request
     completes, the kernels launch as the model calls count them (the
     encoder's and the cross-attention's kernel 1 launches and the
     cross-attention decode's kernel 2 launches included), and one
     prompt's logits (with random frames for seamless) through prefill
     and two decode steps match the plain path's;
  9. vlm: paligemma-3b whole (18 layers, 8 heads over one KV head, hd
     256), each prompt behind 256 zero patches that take cache positions,
     the same 16 requests, dense and paged, batched and async; every
     request completes or is rejected as the engine's rule gives from the
     lengths and the prefix, the kernels launch once per layer and model
     call, every page comes back, one prompt's logits (random patches)
     through a prefill, extend chunks and two decode steps match the plain
     path's, dense and paged; a 2-layer fp32 model at full width gives
     equal streams dense and paged, batched and async; int8 caches at hd
     256 go through kernels 3 and 4-int8;
  10. mla: deepseek-v2-236b at its published width, 6 of its 60 layers
     (MLA attention, 160 experts top-6 and 2 shared in every layer), the
     same 16 requests, batched and async, over its dense latent cache;
     every request completes, kernel 1 launches once per layer and
     prefill call and kernel 6 three times per layer and token slice,
     kernels 2-5 never; one prompt's logits through a prefill, extend
     chunks and two decode steps match the plain path's (its argmax, and
     within twice the plain path's own spread between two cuts of the
     prompt, and at least LOGIT_BOUND: the top-6 routing over 160
     experts flips under bf16 rounding); a 1-layer
     fp32 model at full width gives equal streams batched and async;
  11. hybrid: zamba2-7b whole (81 Mamba2 layers, the shared attention +
     MLP block with a rank-128 LoRA per group of 6, hd 112), lora_b,
     A_log and dt_bias perturbed from a seed, the same 16 requests,
     batched and async over its dense state + attention caches; every
     request completes, kernel 1 launches once per group and prefill
     call and kernel 2 once per group and decode step, kernels 3-7
     never; one prompt's logits through a prefill, extend chunks and two
     decode steps match the plain path's, at bf16 within twice the plain
     path's own spread between two SSD chunk sizes (81 recurrent layers
     decorrelate the logits under one rounding) and, the whole model at
     fp32, within LOGIT_BOUND_FP32 with argmax equal at every call; an
     int8 attn cache at B=4 (fp32 model) goes through kernel 3; a 7-layer
     fp32 copy (one group, one tail layer) gives the plain path's streams.
  12. trainer: llama3.2-1b whole at its published width trains 6 steps of
     the synthetic stream at seq 4096, a global batch of 8 in 4
     microbatches (``launch/train.py::train_loop`` at its default rate):
     every loss finite and the last below the first, kernel 1 (with its
     LSE) and each of its three backward kernels launched once per layer
     and microbatch, no plain attention call; a 2-layer fp32 copy's loss
     and every gradient leaf through the kernels match the plain path's;
     a 2-layer bf16 copy's gradient leaves through the kernels lie no
     further from the fp32 plain path's than GRAD_FACTOR_BF16 times the
     bf16 plain path's; a 2-layer bf16 copy trained 4 steps straight and
     2 + a checkpoint restored into fresh parameters + 2 gives bitwise
     equal losses and parameters under
     ``torch.use_deterministic_algorithms(True)``.
  13. moe trainer: phi3.5-moe at its published width, 2 of its 32 layers
     (a third layer's weights and AdamW state would pass 80 GB), trains 6
     steps at seq 4096, a global batch of 4 in 4 microbatches: every loss
     finite and the last below the first, kernel 1 (hd 128, G = 4) and its
     three backward kernels launched once per layer and microbatch, kernel
     6 and its dX and dW kernels three times (every dX and dW launch on
     the wgmma body), no plain kernel call; step
     seconds, tokens/s, peak memory beside its reckoning, the model-FLOP
     share; a 2-layer fp32 copy's loss and every gradient leaf through the
     kernels match the plain path's; a 2-layer bf16 copy's gradient leaves
     lie no further from the fp32 plain path's than GRAD_FACTOR_BF16 times
     the bf16 plain path's (tokens whose top-2 set differs from the fp32
     plain path's are counted); two runs of one step from the same state
     give bitwise-equal parameters.
  14. encdec trainer: seamless-m4t-medium whole (12 encoder and 12
     decoder layers) trains 6 steps of ``training.make_train_step`` at
     seq 1024 over 160 frames (normal x 0.02 from the seed), a global
     batch of 8 in 4 microbatches: every loss finite and the last below
     the first, kernel 1 and its three backward kernels launched 36 times
     a microbatch (12 encoder, 12 self- and 12 cross-attention calls), no
     plain attention call; step seconds, tokens/s, peak memory beside its
     reckoning, the model-FLOP share, the head's GEMMs at vocab 256,206
     and 256,208; a 2-layer (2 + 2) fp32 copy's loss
     and gradient leaves through the kernels match the plain path's; a
     2-layer bf16 copy's leaves lie no further from the fp32 plain path's
     than GRAD_FACTOR_BF16 times the bf16 plain path's.
  15. ssm trainer: rwkv6-1.6b whole (24 layers) trains 6 steps through
     ``launch/train.py::train_loop`` at seq 4096, a global batch of 4 in 4
     microbatches: every loss finite and the last below the first, kernel
     7 (with its chunk-state output) and kernel 7-bwd launched once per
     layer and microbatch, and so each of 7-bwd's passes, no plain WKV6
     call; step seconds, tokens/s, peak memory beside its reckoning, the
     model-FLOP share, 7-bwd's share of the step; the 2-layer fp32 and
     bf16 copies' checks as phase 14's (the fp32 one within
     GRAD_REL_BOUND_WKV, its bonus_u leaves printed).
  16. hybrid trainer: zamba2-7b at its published width, 13 of its 81
     layers (2 groups of the shared attention + MLP block and 6 Mamba2
     layers, then 1 tail layer), trains 6 steps through
     ``launch/train.py::train_loop`` at seq 4096, a global batch of 4 in
     4 microbatches: every loss finite and the last below the first,
     kernel 1 (hd 112, with its LSE) and its three backward kernels
     launched 2 x 4 x 6 = 48 times, no plain attention call, peak memory
     under 80 GB beside its reckoning; step seconds, tokens/s, the
     model-FLOP share with its basis, kernel 1 and 1-bwd's share of the
     step; a 7-layer copy (one group, one tail layer; lora_b, A_log and
     dt_bias perturbed as phase 11's) through ``_grad_checks``: fp32 loss
     and every leaf within GRAD_REL_BOUND_HYBRID of the plain path's,
     bf16 leaves within GRAD_FACTOR_BF16.
  17. vlm trainer: paligemma-3b whole (18 layers, 8 heads of 256 over
     one KV head, vocab 257,216, tied embeddings) trains 6 steps through
     ``training.make_train_step`` (``train_loop`` makes no patches), a
     global batch of 16 rows of 256 patches (normal x 0.02 from the seed,
     a bidirectional prefix) + 512 text tokens in 4 microbatches: every
     loss finite and the last below the first, kernel 1 (hd 256, with its
     LSE) and its three backward kernels launched 18 x 4 x 6 = 432 times,
     no plain attention call; the memory reckoning beside the measured
     peak, step seconds, tokens/s, the model-FLOP share with its basis,
     kernel 1 and 1-bwd's share of the step; the 2-layer copies'
     ``_grad_checks`` (fp32 within GRAD_REL_BOUND, ``frontend_proj``'s
     leaf printed; bf16 within GRAD_FACTOR_BF16).
Phase 3 also holds kernels 1, 2, 4 and 5 at those families' shapes
(G = 5 at hd 128, G = 1 at hd 64 and 128, kernel 1 without the causal
mask), kernels 1-5 at paligemma-3b's (hd 256, G = 8 over one KV head,
kernel 1 with a 256-position bidirectional prefix), kernel 1 at
deepseek-v2's q/k 192 over v 128 and kernel 6 at its 160 experts, and
kernels 1, 2 and 3 at zamba2-7b's hd 112, against their plain versions,
with times and bounds; phase 2 lists the hd-256, 192/128 and hd-112
instantiations beside the others. Phase 3 ends with kernel 1's output and
LSE and its backward kernels (D, dK/dV, dQ) against their plain versions at
the training shape, ragged, prefix and non-causal shapes, the edges of the
bf16 bodies' tiles (lengths and prefixes at 127-129, G = 1 and 8), bf16
and fp32, their determinism, and their times beside their bounds and
SDPA's backward (D beside ``torch.linalg.vecdot``); the same at hd 128
(phi3.5-moe's B 1 x 4096 and qwen3-14b's G = 5 at B 1 x 2048, and the
hd-128 bodies' 32-position tiles' edges) and at hd 112 (zamba2-7b's B 1
x 4096 over 32 KV heads, the edges of hd 128's layout, which hd 112
takes, G = 4 and 8, ``FlashAttentionFn``'s gradients on unaligned and
strided views, bounds counted at 112) and at hd 256 (phase 17's B 4 x
768 with its 256-position prefix, the hd-256 layouts' tile edges, a
prefix longer than Sq, non-causal, G = 1 over 8, bitwise repeats at bf16
and fp32, bounds over the visible pairs, SDPA under the boolean mask of
the same pairs); and kernel 6's backward (dX,
dW) against its plain version at its fill and tile edges, 160 experts
top-6 and phi3.5-moe's training microbatch, each case naming the body it
took (wgmma, mma.sync or the fp32 FMA body), timed at the microbatch
beside its bound and ``torch.bmm``, with kernel 6's forward there too;
and kernel 7-bwd against its plain version (``ref.wkv6_chunked_bwd_ref``)
at phase 15's microbatch (B 1 x 4096, 32 heads of 64) and at edge
shapes (S 1, 31, 33, hd 16, the decay at -1.5 and -1e-6, a nonzero
state0), bf16 and fp32, its dS pass against ``ref.wkv6_bwd_ds_ref``,
two runs bitwise equal, kernel 7's forward there with its chunk-state
output on and off (outputs bitwise equal), each timed beside its bound
and plain version, and each of 7-bwd's four passes timed alone; phase 2
prints their registers, spills and shared memory, and 7-bwd's blocks an
SM by pass (its chunk pass at least two).
Prints the kernel table as one JSON line, then the device line last.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path


sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# cuBLAS reads its workspace setting when CUDA initialises; phase 12's
# restart check runs under torch.use_deterministic_algorithms(True), which
# needs this one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# 3xTF32: an fp32 product as three TF32 MMAs at 495 TFLOP/s (kernel 7-bwd)
TF32X3_FLOP_PER_S = 495e12 / 3
# kernel vs plain: bf16 outputs round once to 8 mantissa bits on each side
# (adjacent roundings of |x| < 4 differ by <= 1.6e-2); fp32 differs only in
# the order of up to 1024-term sums
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# kernel path vs plain path, first-token logits of a 16-layer bf16 model:
# each layer's attention output differs by up to one bf16 rounding, which
# the later layers carry into logits of std ~1
LOGIT_BOUND = 0.25
# the same at fp32 for the 24-layer recurrent rwkv6-1.6b: the kernel and the
# plain form sum the same fp32 terms in another order (~1e-6 relative per
# layer), carried through 24 layers to logits of std ~1
LOGIT_BOUND_FP32 = 1e-3
# rwkv6-1.6b at bf16: its recurrent layers re-round each layer's output to
# bf16 and carry the rounding across the prompt, so the plain path differs
# from itself, run at 16-token chunks in place of 32 (the same math), by as
# much as from the kernel path; the kernel path is held within this
# multiple of that spread
SPREAD_FACTOR_BF16 = 2.0
SEED = 0
# phase 12's fp32 check: kernel path vs plain path, each gradient leaf's
# largest difference over its largest magnitude (fp32 sums in another
# order, through two layers and the backward)
GRAD_REL_BOUND = 1e-4
# kernel 1's LSE vs the plain one: fp32 sums in another order (2e-5);
# at bf16 the kernel sums bf16-rounded probabilities (2e-3 of a row sum)
LSE_TOL = {"bfloat16": 2e-3, "float32": 2e-5}
# kernel 1's backward vs its plain version, ||kernel - plain|| / ||plain||
# over a whole dQ, dK or dV: at bf16 the kernels round P and dS to bf16
# (unit roundoff 2^-9 ~ 2e-3) before two of their products and each output
# once, errors of random sign whose norm stays a few units of 2^-9 (TOL's
# 2e-2 abs floor is near a typical dQ entry at the training shape, so this
# holds the bulk); at fp32 the same sums in another order
BWD_REL_NORM = {"bfloat16": 1e-2, "float32": 1e-5}
# phase 15's fp32 check (rwkv6): kernel 7's 3xTF32 products hold its fp32
# outputs to TOL's 2e-5, not to fp32 rounding, and bonus_u's gradient is a
# sum over every token of signed terms that nearly cancel, which kernel
# 7-bwd takes in another order than autograd (its worst leaf); held as
# phase 6 holds this model's fp32 logits
GRAD_REL_BOUND_WKV = LOGIT_BOUND_FP32
# phase 16's fp32 check (zamba2-7b): kernel 1 and its backward sum the
# shared attention's fp32 terms in another order (~3e-7 of a gradient's
# norm in phase 3), and the Mamba2 layers behind it, their gated norms and
# the decay clamp carry that to 1-2e-4 of a leaf's largest entry at full
# width (with the decays perturbed or not); held as phase 11 holds this
# model's fp32 logits
GRAD_REL_BOUND_HYBRID = LOGIT_BOUND_FP32
# phase 12's bf16 check: each gradient leaf's distance from the fp32 plain
# path's, ||g - g32|| / ||g32||, through the kernels at most this multiple
# of the bf16 plain path's own distance (both round the same products to
# bf16 outside attention)
GRAD_FACTOR_BF16 = 2.0
# ~50 us at the H100's 1.98 GHz boost clock (time_ms)
SPIN_CYCLES = 100_000


def clocks() -> str:
    """The card's SM clock, power draw and throttle reasons now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, flush, reps: int = 30) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up,
    with L2 flushed before each run (the serving path reads each layer's
    cache cold). A 50 us device spin after the flush gives the host a head
    start, so the time of a wrapper's host code never shows as an idle
    device between the two events."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
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


def reset(*kernels) -> None:
    for k in kernels:
        k.launches = 0


def backward_kernels(dev, flush, compare, rows, extra_shapes) -> None:
    """Phase 3's end: kernel 1's LSE output and its three backward kernels
    against their plain versions (``ref.attention_lse_ref``,
    ``ref.attention_bwd_ref``) at bf16 and fp32: llama3.2-1b's training
    shape (B 2, 4096 tokens, 32 heads over 8, hd 64, causal), ragged
    small shapes, a prefix and a non-causal case; at hd 128 phi3.5-moe's
    training shape (B 1, 4096 tokens, 32 heads over 8), qwen3-14b's G = 5
    (B 1, 2048 tokens, 40 heads over 8) and the hd-128 bodies' tile edges;
    at hd 112 zamba2-7b's training shape (B 1, 4096 tokens, 32 heads over
    32), its tile edges, ragged, prefix, non-causal and G = 4 and 8 cases,
    and ``FlashAttentionFn``'s gradients on unaligned and strided views;
    two backward runs bitwise equal at each width; kernel 1's forward time
    with the LSE on and off, and each backward kernel's time beside its
    bound, its plain version's and its library call's (SDPA's backward;
    for D, ``torch.linalg.vecdot``). Its own generator, so every other
    input stays as it was."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    H, KVH, hd = 32, 8, 64

    def inputs(B, Sq, Sk, dt, causal, prefix, h=H, kvh=KVH, hd=hd):
        q, do = (torch.randn((B, Sq, h, hd), generator=g, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn((B, Sk, kvh, hd), generator=g, device=dev).to(dt)
                for _ in range(2))
        lse = torch.empty((B, h, Sq), device=dev)
        o = FA.flash_attention(q, k, v, causal=causal, prefix_len=prefix,
                               lse=lse)
        return q, k, v, o, lse, do

    def rel_norm(name, got, want, dtype, case):
        e = ((got.float() - want.float()).norm()
             / want.float().norm()).item()
        check(e <= BWD_REL_NORM[dtype], f"{name} {case}: ||kernel - plain|| "
              f"/ ||plain|| {e:.3g} over {BWD_REL_NORM[dtype]}")
        print(f"  {name} {case}: ||kernel - plain|| / ||plain|| {e:.3g} "
              f"(bound {BWD_REL_NORM[dtype]})")

    print("[kernels] flash_attention's output and LSE vs attention_lse_ref; "
          "backward kernels (D, dK/dV, dQ) vs attention_bwd_ref, on the "
          "forward kernel's output and LSE")
    # B, Sq, Sk, causal, prefix, H, KVH; then the bf16 bodies' tile edges
    # (128 keys or query rows a block, 64 a warpgroup and a streamed tile):
    # lengths and prefixes at 128 and either side, G = 1 and G = 8, and
    # Sq != Sk without the mask
    cases = [(2, 4096, 4096, True, 0, H, KVH), (2, 1, 1, True, 0, H, KVH),
             (2, 63, 63, True, 0, H, KVH), (2, 257, 257, True, 0, H, KVH),
             (2, 300, 300, True, 70, H, KVH), (2, 200, 300, False, 0, H, KVH),
             (2, 127, 127, True, 0, H, KVH), (2, 128, 128, True, 0, H, KVH),
             (2, 129, 129, True, 0, H, KVH), (1, 300, 300, True, 127, H, KVH),
             (1, 300, 300, True, 128, H, KVH),
             (1, 300, 300, True, 129, H, KVH), (1, 300, 300, True, 64, H, KVH),
             (2, 257, 257, True, 0, 8, 8), (2, 257, 257, True, 0, H, 4),
             (1, 129, 127, False, 0, H, KVH), (2, 127, 385, False, 0, H, KVH)]
    # hd 128: phi3.5-moe's training shape, qwen3-14b's G = 5, and
    # the hd-128 bf16 bodies' edges (a streamed tile of 32 queries or keys
    # beside the 128 keys or rows a block)
    cases128 = [(1, 4096, 4096, True, 0, H, KVH),
                (1, 2048, 2048, True, 0, 40, 8),
                (1, 31, 31, True, 0, H, KVH), (1, 33, 33, True, 0, H, KVH),
                (1, 127, 127, True, 0, H, KVH), (1, 128, 128, True, 0, H, KVH),
                (1, 129, 129, True, 0, H, KVH),
                (1, 300, 300, True, 31, H, KVH),
                (1, 300, 300, True, 64, H, KVH),
                (1, 300, 300, True, 129, H, KVH), (1, 257, 257, True, 0, 8, 8),
                (1, 257, 257, True, 0, H, 4), (1, 129, 127, False, 0, H, KVH),
                (1, 127, 385, False, 0, H, KVH)]
    # hd 112 (zamba2-7b's shared attention, 32 heads over 32): its training
    # shape, the hd-128 layout's tile edges, ragged S, prefixes, Sq != Sk
    # without the mask, B 2, and G = 4 and 8 (no zamba2 path has G > 1)
    cases112 = [(1, 4096, 4096, True, 0, H, H),
                (1, 31, 31, True, 0, H, H), (1, 33, 33, True, 0, H, H),
                (1, 127, 127, True, 0, H, H), (1, 128, 128, True, 0, H, H),
                (1, 129, 129, True, 0, H, H), (2, 300, 300, True, 0, H, H),
                (1, 300, 300, True, 31, H, H), (1, 300, 300, True, 129, H, H),
                (1, 257, 257, True, 0, H, KVH), (2, 257, 257, True, 0, 8, 1),
                (1, 129, 127, False, 0, H, H), (1, 127, 385, False, 0, H, H)]
    # hd 256 (paligemma-3b, 8 heads over 1): phase 17's microbatch (B 4 x
    # 256 patches + 512 text tokens, the patches a bidirectional prefix),
    # prefix 0, the hd-256 layouts' tile edges (64 keys a (b) block, 128
    # rows a (c) block, 32-position streamed tiles), a prefix longer than
    # Sq, ragged Sq != Sk without the mask, the microbatch without it, and
    # G = 1 over 8
    cases256 = [(4, 768, 768, True, 256, 8, 1), (1, 300, 300, True, 0, 8, 1),
                (1, 65, 65, True, 0, 8, 1), (2, 129, 129, True, 64, 8, 1),
                (1, 200, 200, True, 300, 8, 1),
                (1, 129, 127, False, 0, 8, 1), (2, 127, 385, False, 0, 8, 1),
                (4, 768, 768, False, 0, 8, 1), (1, 257, 257, True, 33, 8, 8)]
    for dtype, (hd_, case_list) in ((d, c) for c in ((hd, cases),
                                                     (128, cases128),
                                                     (112, cases112),
                                                     (256, cases256))
                                    for d in ("bfloat16", "float32")):
        dt = getattr(torch, dtype)
        for B, Sq, Sk, causal, prefix, h, kvh in case_list:
            case = (f"{dtype} B={B} Sq={Sq} Sk={Sk} H={h} KVH={kvh} hd={hd_} "
                    f"{'causal' if causal else 'non-causal'} prefix={prefix}")
            kw = dict(causal=causal, prefix_len=prefix)
            q, k, v, o, lse, do = inputs(B, Sq, Sk, dt, causal, prefix, h,
                                         kvh, hd_)
            check(torch.equal(o, FA.flash_attention(q, k, v, **kw)),
                  f"flash_attention {case}: the LSE changed the output")
            o_want, lse_want = ref.attention_lse_ref(q, k, v, **kw)
            compare("flash_attention", o, o_want, dtype, case)
            err = (lse - lse_want).abs()
            check(bool((err <= LSE_TOL[dtype] * (1 + lse_want.abs())).all()),
                  f"flash_attention LSE {case}: max err "
                  f"{err.max().item():.3g} over {LSE_TOL[dtype]}")
            print(f"  flash_attention LSE {case}: max |kernel - plain| "
                  f"{err.max().item():.3g} (bound {LSE_TOL[dtype]} abs + "
                  f"rel)")
            del o_want, lse_want, err
            D = FA.flash_attention_bwd_dot(o, do)
            compare("flash_attention_bwd_dot", D,
                    (o.float() * do.float()).sum(-1).transpose(1, 2),
                    "float32", case)
            dk, dv = FA.flash_attention_bwd_dkdv(q, k, v, do, lse, D, **kw)
            dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, D, **kw)
            want = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
            compare("flash_attention_bwd_dkdv", dk, want[1], dtype,
                    case + " dk")
            compare("flash_attention_bwd_dkdv", dv, want[2], dtype,
                    case + " dv")
            compare("flash_attention_bwd_dq", dq, want[0], dtype, case)
            if Sq > 1:          # at Sq = Sk = 1, dS and so dQ, dK are 0
                rel_norm("flash_attention_bwd_dkdv", dk, want[1], dtype,
                         case + " dk")
                rel_norm("flash_attention_bwd_dkdv", dv, want[2], dtype,
                         case + " dv")
                rel_norm("flash_attention_bwd_dq", dq, want[0], dtype, case)
            del q, k, v, o, lse, do, D, dk, dv, dq, want
            torch.cuda.empty_cache()

    bf = torch.bfloat16
    for Bd, hd_, kvh_ in ((1, 128, KVH), (2, hd, KVH), (1, 112, H)):
        q, k, v, o, lse, do = inputs(Bd, 4096, 4096, bf, True, 0, kvh=kvh_,
                                     hd=hd_)
        runs = [FA.flash_attention_bwd(q, k, v, o, lse, do) for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"flash_attention_bwd hd={hd_}: two runs differ")
        print(f"  flash_attention_bwd bf16 B={Bd} S=4096 KVH={kvh_} "
              f"hd={hd_}: two runs bitwise equal (dq, dk, dv)")
        del runs, q, k, v, o, lse, do
    for dtype in ("bfloat16", "float32"):
        q, k, v, o, lse, do = inputs(4, 768, 768, getattr(torch, dtype), True,
                                     256, 8, 1, 256)
        runs = [FA.flash_attention_bwd(q, k, v, o, lse, do, prefix_len=256)
                for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"flash_attention_bwd {dtype} hd=256: two runs differ")
        print(f"  flash_attention_bwd {dtype} B=4 S=768 H=8 KVH=1 hd=256 "
              f"prefix=256: two runs bitwise equal (dq, dk, dv)")
        del runs, q, k, v, o, lse, do

    # FlashAttentionFn at hd 112 on views the backward kernels do not take
    # as they are (a 2-byte offset; a strided slice of a fused projection):
    # the forward kernel reads them, the Function hands the backward
    # aligned copies; its gradients against autograd of the plain version
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        Bv, Sv, Hv = 1, 300, 8
        n = Bv * Sv * Hv * 112
        flat = torch.randn(3 * n + 1, generator=g, device=dev).to(dt)
        odd = [flat[1 + i * n:1 + (i + 1) * n].view(Bv, Sv, Hv, 112)
               for i in range(3)]
        fused = torch.randn((Bv, Sv, 3 * Hv, 112), generator=g,
                            device=dev).to(dt)
        strided = list(fused.split(Hv, dim=2))
        dov = torch.randn((Bv, Sv, Hv, 112), generator=g, device=dev).to(dt)
        for what, views in (("2-byte offset", odd), ("strided", strided)):
            case = f"{dtype} B={Bv} S={Sv} H=KVH={Hv} hd=112 {what} views"
            check(what != "2-byte offset"
                  or all(t.data_ptr() % 16 for t in views),
                  f"FlashAttentionFn {case}: a view is aligned")
            leaves_ = [t.detach().requires_grad_() for t in views]
            out = FA.FlashAttentionFn.apply(*leaves_, True, 0)
            got = torch.autograd.grad(out, leaves_, dov)
            plain = [t.detach().requires_grad_() for t in views]
            want = torch.autograd.grad(ref.attention_ref(*plain), plain, dov)
            for nm, a, b in zip(("dq", "dk", "dv"), got, want):
                compare("flash_attention_bwd_dq" if nm == "dq" else
                        "flash_attention_bwd_dkdv", a, b, dtype,
                        f"FlashAttentionFn {case} {nm}")
                rel_norm("FlashAttentionFn", a, b, dtype, f"{case} {nm}")
        del flat, odd, fused, strided, dov, leaves_, plain, got, want
    B, S = 2, 4096
    q, k, v, o, lse, do = inputs(B, S, S, bf, True, 0)

    print("[kernels] times at the training shape (bf16, CUDA events, "
          "median of 30, L2 flushed; plain median of 5)")

    def visible(Sq, pre):
        """(query, key) pairs a causal mask with a prefix shows, Sq = Sk"""
        return sum(min(Sq, max(i + 1, pre)) for i in range(Sq))

    def sdpa(qt, kt, vt, Sq, pre):
        """SDPA over [B, heads, S, hd] views: causal with GQA, or with a
        prefix under the boolean mask of the same pairs (True: attend),
        K and V repeated to the query heads"""
        if not pre:
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        i = torch.arange(Sq, device=dev)
        mask = (i[None, :] <= i[:, None]) | (i[None, :] < pre)
        G_ = qt.shape[1] // kt.shape[1]
        return F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(G_, dim=1),
            vt.repeat_interleave(G_, dim=1), attn_mask=mask)

    # llama3.2-1b's shapes, then zamba2-7b's training shape (hd 112, 32
    # heads over 32), then phase 17's microbatch (hd 256, 8 heads over 1,
    # a 256-position prefix)
    for Bf, Sf, Hf, hdf, kvf, pre in ((4, 512, H, hd, KVH, 0),
                                      (B, S, H, hd, KVH, 0),
                                      (1, 4096, H, 112, H, 0),
                                      (4, 768, 8, 256, 1, 256)):
        qf, kf, vf = (q, k, v) if (Bf, Sf, hdf) == (B, S, hd) else (
            torch.randn((Bf, Sf, n, hdf), generator=g, device=dev).to(bf)
            for n in (Hf, kvf, kvf))
        buf = torch.empty((Bf, Hf, Sf), device=dev)
        kw = dict(prefix_len=pre)
        off = time_ms(lambda: FA.flash_attention(qf, kf, vf, **kw), flush)
        on = time_ms(lambda: FA.flash_attention(qf, kf, vf, lse=buf, **kw),
                     flush)
        plain = time_ms(lambda: ref.attention_lse_ref(qf, kf, vf, **kw),
                        flush, reps=5)
        # SDPA's forward (its LSE stays inside the library): a yardstick;
        # with a prefix, under the boolean mask of the same pairs, K and V
        # repeated to the query heads (as phase 3's paligemma-3b row)
        qt, kt, vt = (t.transpose(1, 2) for t in (qf, kf, vf))
        lib = time_ms(lambda: sdpa(qt, kt, vt, Sf, pre), flush)
        # q, k, v read and the output written (bf16), the LSE written
        # (fp32); QK^T and PV over the visible pairs
        b_ms, b_by = bound(2 * (2 * qf.numel() + kf.numel() + vf.numel())
                           + 4 * buf.numel(),
                           4.0 * Bf * Hf * hdf * visible(Sf, pre),
                           BF16_FLOP_PER_S)
        what = f"causal prefix={pre}" if pre else "causal"
        print(f"  flash_attention B={Bf} S={Sf} H={Hf} KVH={kvf} hd={hdf} "
              f"{what}: LSE off "
              f"{off:.4f} ms, on {on:.4f} ms, plain (with its LSE) "
              f"{plain:.4f}, library (SDPA forward, "
              f"{'K, V repeated, boolean mask' if pre else 'enable_gqa=True'}"
              f") "
              f"{lib:.4f}, bound {b_ms:.5f} ({b_by}) -> {b_ms / on:.1%} of "
              f"bound, kernel / library {on / lib:.2f}")
        extra_shapes.setdefault("flash_attention", []).append(dict(
            ms=on, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
            bound_by=b_by, lse_off_ms=off,
            shape=f"bf16 B={Bf} Sq=Sk={Sf} H={Hf} KVH={kvf} hd={hdf} "
                  f"{what}, with the LSE output"))
        del qt, kt, vt, qf, kf, vf
    # each backward kernel at llama3.2-1b's training shape (the table's
    # row), then at hd 128: phi3.5-moe's (B 1 x 4096, 32 heads over 8) and
    # qwen3-14b's G = 5 (B 1 x 2048, 40 heads over 8); then zamba2-7b's at
    # hd 112 (B 1 x 4096, 32 heads over 32), its bound counted at 112; then
    # paligemma-3b's at hd 256 (phase 17's microbatch: B 4 x 768, 8 heads
    # over 1, a 256-position prefix), its bound over the visible pairs
    for Bt, St, Ht, KVHt, hdt, pre in ((B, S, H, KVH, hd, 0),
                                       (1, 4096, H, KVH, 128, 0),
                                       (1, 2048, 40, 8, 128, 0),
                                       (1, 4096, H, H, 112, 0),
                                       (4, 768, 8, 1, 256, 256)):
        if hdt != hd:
            q, k, v, o, lse, do = inputs(Bt, St, St, bf, True, pre, Ht, KVHt,
                                         hdt)
        shape = (f"bf16 B={Bt} Sq=Sk={St} H={Ht} KVH={KVHt} hd={hdt} "
                 f"causal" + (f" prefix={pre}" if pre else ""))
        kw = dict(prefix_len=pre)
        n = q.numel()
        half = Bt * Ht * hdt * visible(St, pre)      # the visible pairs' MACs
        stats = 2 * 4 * Bt * Ht * St                 # lse and D, fp32
        D = FA.flash_attention_bwd_dot(o, do)
        # SDPA's whole backward (dQ, dK and dV) at the same shape: the
        # library row of the dK/dV kernel; vecdot reads o and dO and
        # reduces over hd, as D: the library row of (a). Yardsticks the
        # port never calls
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = sdpa(qt, kt, vt, St, pre)
        dot = do.transpose(1, 2)
        lib = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                  retain_graph=True), flush)
        timed = {
            "flash_attention_bwd_dot": (
                lambda: FA.flash_attention_bwd_dot(o, do),
                lambda: (o.float() * do.float()).sum(-1).transpose(1, 2),
                lambda: torch.linalg.vecdot(o, do, dim=-1),
                2 * 2 * n + 4 * Bt * Ht * St, 2.0 * n),
            "flash_attention_bwd_dkdv": (
                lambda: FA.flash_attention_bwd_dkdv(q, k, v, do, lse, D, **kw),
                lambda: ref.attention_bwd_ref(q, k, v, o, lse, do, **kw), None,
                2 * (2 * n + 4 * k.numel()) + stats, 4 * 2 * half),
            "flash_attention_bwd_dq": (
                lambda: FA.flash_attention_bwd_dq(q, k, v, do, lse, D, **kw),
                lambda: ref.attention_bwd_ref(q, k, v, o, lse, do, **kw), None,
                2 * (3 * n + 2 * k.numel()) + stats, 3 * 2 * half)}
        total = 0.0
        for name, (fn, plain_fn, lib_fn, nbytes, flops) in timed.items():
            ms = time_ms(fn, flush)
            plain = time_ms(plain_fn, flush, reps=5)
            b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
            total += ms
            library = (time_ms(lib_fn, flush) if lib_fn
                       else lib if name == "flash_attention_bwd_dkdv"
                       else None)
            what = ("torch.linalg.vecdot(o, do, dim=-1)" if lib_fn
                    else "SDPA's whole backward, " + (
                        "K, V repeated, boolean mask" if pre
                        else "enable_gqa=True"))
            print(f"  {name} {shape}: kernel {ms:.4f} ms, plain {plain:.4f}"
                  f", bound {b_ms:.5f} ({b_by}) -> {b_ms / ms:.1%} of bound"
                  + (f", library ({what}) {library:.4f}" if library else ""))
            entry = dict(ms=ms, plain_ms=plain, library_ms=library,
                         bound_ms=b_ms, bound_by=b_by, shape=shape)
            if hdt == hd:
                rows[name].update(entry)
            else:
                extra_shapes.setdefault(name, []).append(entry)
        whole, whole_by = bound(2 * (4 * n + 4 * k.numel()) + stats,
                                5 * 2 * half, BF16_FLOP_PER_S)
        print(f"  the whole backward (D + dK/dV + dQ) at {shape}: "
              f"{total:.4f} ms, bound {whole:.5f} ({whole_by}: 5 causal-half "
              f"matmuls) -> {whole / total:.1%}; SDPA's backward {lib:.4f} "
              f"ms, kernels / library {total / lib:.2f}")
        del q, k, v, o, lse, do, D, qt, kt, vt, out, dot
        torch.cuda.empty_cache()


def expert_backward_kernels(dev, flush, compare, rows, extra_shapes) -> None:
    """Phase 3: kernel 6's backward (dX and dW) against its plain version
    (``ref.expert_matmul_bwd_ref``) at bf16 and fp32, by element and by
    relative norm: fill 0, 1, ragged and C, D and F not multiples of 8 (the
    mma.sync body), C at the 128-row tiles and either side, fills at and
    either side of the wgmma body's 64-row warpgroups, every fill 0, D not
    a multiple of its 256 columns, F a multiple of 8 but not of its 64-deep
    slabs, 160 experts top-6, each case naming the body that dX and dW
    took; then at phi3.5-moe's training microbatch (E 16, C = T = 4096,
    top-2 fills from a seeded routing, D 4096, F 6400), gate/up and down,
    bf16: two runs bitwise equal and each kernel's time beside its bound,
    the plain version's (dX and dW together) and ``torch.bmm`` over every
    row, and kernel 6's forward there (the training forward) beside its
    bound, plain version and ``torch.bmm``. Its own generator, so every
    other input stays as it was."""
    import torch
    from repro_torch.kernels import expert_matmul as EM
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(SEED + 24)
    bf = torch.bfloat16

    def routed_fill(E, T, k):
        idx = torch.topk(torch.rand((T, E), generator=g, device=dev), k,
                         dim=-1).indices
        return torch.bincount(idx.reshape(-1), minlength=E).to(torch.int32)

    def inputs(E, C, D, F, fill, dt):
        xe = torch.randn((E, C, D), generator=g, device=dev).to(dt)
        w = (torch.randn((E, D, F), generator=g, device=dev)
             / D ** 0.5).to(dt)
        dy = torch.randn((E, C, F), generator=g, device=dev).to(dt)
        f = torch.tensor(fill, dtype=torch.int32, device=dev) if isinstance(
            fill, list) else fill
        return xe, w, f, dy

    def check_pair(xe, w, f, dy, dtype, case):
        dxe = EM.expert_matmul_bwd_dx(dy, w, f)
        dw = EM.expert_matmul_bwd_dw(xe, dy, f)
        want = ref.expert_matmul_bwd_ref(xe, w, f, dy)
        E, C, Din = xe.shape
        Dout = dy.shape[2]
        bodies = (EM.bwd_body(dy, w, dxe, Din, Dout),
                  EM.bwd_body(xe, dy, dw, Din, Dout))
        print(f"  {case}: dX body {bodies[0]}, dW body {bodies[1]}")
        rows_past = torch.arange(C, device=dev)[None, :] >= f[:, None]
        check(not dxe[rows_past].any(), f"expert_matmul_bwd_dx {case}: rows "
              "past fill are not zero")
        check(not dw[f == 0].any(), f"expert_matmul_bwd_dw {case}: an empty "
              "expert's dw is not zero")
        for name, got, wt in (("expert_matmul_bwd_dx", dxe, want[0]),
                              ("expert_matmul_bwd_dw", dw, want[1])):
            compare(name, got, wt, dtype, case)
            if wt.any():
                e = ((got.float() - wt.float()).norm()
                     / wt.float().norm()).item()
                check(e <= BWD_REL_NORM[dtype], f"{name} {case}: ||kernel - "
                      f"plain|| / ||plain|| {e:.3g} over "
                      f"{BWD_REL_NORM[dtype]}")
                print(f"  {name} {case}: ||kernel - plain|| / ||plain|| "
                      f"{e:.3g} (bound {BWD_REL_NORM[dtype]})")
        return bodies

    print("[kernels] expert_matmul_bwd_dx / _dw vs expert_matmul_bwd_ref")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for E, C, D, F_, fill in (
                (16, 128, 512, 640, [0, 1, 128, 64, 127, 2, 0, 100, 5, 128,
                                     33, 1, 0, 77, 128, 9]),
                (4, 127, 203, 300, [0, 1, 64, 127]),
                (4, 129, 256, 384, [0, 1, 129, 100]),
                (2, 64, 64, 64, [0, 0]),
                (8, 300, 640, 1536, [63, 64, 65, 127, 129, 191, 257, 300]),
                (4, 520, 1536, 640, [520] * 4),
                (3, 256, 640, 200, [0, 0, 0]),
                (3, 256, 640, 200, [255, 17, 256]),
                (160, 48, 512, 384, routed_fill(160, 8, 6))):
            xe, w, f, dy = inputs(E, C, D, F_, fill, dt)
            check_pair(xe, w, f, dy, dtype,
                       f"{dtype} E={E} C={C} D={D} F={F_} fill={f.tolist()}")
            del xe, w, dy

    E, T, D, F_ = 16, 4096, 4096, 6400
    fill = routed_fill(E, T, 2)
    live, live_e = int(fill.sum()), int((fill > 0).sum())
    print(f"[kernels] kernel 6's backward at phi3.5-moe's training "
          f"microbatch: E={E} C=T={T} top-2 fill {fill.tolist()} (bf16; "
          f"times by CUDA events, median of 30, L2 flushed; plain median of "
          f"5)")
    for label, Din, Dout in (("gate/up", D, F_), ("down", F_, D)):
        xe, w, f, dy = inputs(E, T, Din, Dout, fill, bf)
        rows_past = torch.arange(T, device=dev)[None, :] >= f[:, None]
        xe[rows_past] = 0          # as the buckets hold them
        dy[rows_past] = 0
        case = (f"bfloat16 E={E} C=T={T} D={Din} F={Dout} top-2 ({live} "
                f"live rows, {live_e} experts) {label}")
        bodies = check_pair(xe, w, f, dy, "bfloat16", case)
        for fn, args in ((EM.expert_matmul_bwd_dx, (dy, w, f)),
                         (EM.expert_matmul_bwd_dw, (xe, dy, f))):
            check(torch.equal(fn(*args), fn(*args)),
                  f"{fn.__name__} {case}: two runs differ")
        print(f"  expert_matmul_bwd_dx / _dw {case}: two runs bitwise equal")
        plain = time_ms(lambda: ref.expert_matmul_bwd_ref(xe, w, f, dy),
                        flush, reps=5)
        flops = 2.0 * live * Din * Dout
        for name, fn, lib_fn, nbytes, body in (
                ("expert_matmul_bwd_dx",
                 lambda: EM.expert_matmul_bwd_dx(dy, w, f),
                 lambda: torch.bmm(dy, w.transpose(1, 2)),
                 # live rows of dy, live experts' w, the whole output
                 2 * (live * Dout + live_e * Din * Dout + E * T * Din),
                 bodies[0]),
                ("expert_matmul_bwd_dw",
                 lambda: EM.expert_matmul_bwd_dw(xe, dy, f),
                 lambda: torch.bmm(xe.transpose(1, 2), dy),
                 # live rows of xe and dy, the whole output
                 2 * (live * (Din + Dout) + E * Din * Dout), bodies[1])):
            ms = time_ms(fn, flush)
            lib = time_ms(lib_fn, flush)
            b_ms, b_by = bound(nbytes + 4 * E, flops, BF16_FLOP_PER_S)
            print(f"  {name} {label} ({body} body): kernel {ms:.4f} ms, "
                  f"plain (dX and dW) {plain:.4f}, library (bmm, every row) "
                  f"{lib:.4f}, bound {b_ms:.5f} ({b_by}) -> {b_ms / ms:.1%} "
                  f"of bound, kernel / library {ms / lib:.2f}")
            entry = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by, shape=case, body=body)
            if label == "gate/up":
                rows[name].update(entry)
            else:
                extra_shapes.setdefault(name, []).append(entry)
        # the training forward at the same microbatch (phase 13's kernel 6
        # launches), on the same inputs: live rows of xe, live experts' w,
        # the whole output
        got = EM.expert_matmul(xe, w, f)
        check(not got[rows_past].any(), f"expert_matmul {case}: rows past "
              "fill are not zero")
        compare("expert_matmul", got, ref.expert_matmul_ref(xe, w, f),
                "bfloat16", case)
        del got
        ms = time_ms(lambda: EM.expert_matmul(xe, w, f), flush)
        fwd_plain = time_ms(lambda: ref.expert_matmul_ref(xe, w, f), flush,
                            reps=5)
        lib = time_ms(lambda: torch.bmm(xe, w), flush)
        b_ms, b_by = bound(2 * (live * Din + live_e * Din * Dout
                                + E * T * Dout) + 4 * E, flops,
                           BF16_FLOP_PER_S)
        print(f"  expert_matmul (forward) {label}: kernel {ms:.4f} ms, plain "
              f"{fwd_plain:.4f}, library (bmm, every row) {lib:.4f}, bound "
              f"{b_ms:.5f} ({b_by}) -> {b_ms / ms:.1%} of bound, kernel / "
              f"library {ms / lib:.2f}")
        extra_shapes.setdefault("expert_matmul", []).append(dict(
            ms=ms, plain_ms=fwd_plain, library_ms=lib, bound_ms=b_ms,
            bound_by=b_by, shape=f"training forward: {case}"))
        del xe, w, dy
        torch.cuda.empty_cache()


def wkv_bwd_flops(S: int, H: int, hd: int, B: int) -> float:
    """Kernel 7-bwd's products on these inputs, 2 FLOP a multiply-add: per
    chunk of C tokens and (b, h) the pair tiles P and dP (strictly lower,
    and the two diagonals), dv's (s >= t) and dA's and dBm's (j < t)
    within the chunk, dv's, dA's and dKd's state terms and dS's update
    (C hd^2 each)."""
    mac = 0
    for t0 in range(0, S, 32):
        C = min(32, S - t0)
        low = C * (C - 1) // 2
        mac += 4 * C * hd * hd + (4 * low + C * (C + 1) // 2 + 2 * C) * hd
    return 2.0 * mac * B * H


def wkv6_backward_kernels(dev, flush, rows, extra_shapes) -> None:
    """Phase 3: kernel 7 at phase 15's training microbatch (B 1, 4096
    tokens, rwkv6-1.6b's 32 heads of 64) with its chunk-state output on
    and off (bitwise-equal outputs, the states against the plain ones),
    and kernel 7-bwd against ``ref.wkv6_chunked_bwd_ref`` there and at
    edge shapes (S 1, 31 and 33, hd 16, the decay at the clamp -1.5 and
    at -1e-6, a nonzero state0 and final-state gradient), bf16 and fp32,
    by element and by relative norm, and 7-bwd's dS pass against
    ``ref.wkv6_bwd_ds_ref``; two runs bitwise equal; each time beside its
    bound and its plain version's (no library call computes either), and
    each pass of 7-bwd timed alone. Its own generator, so every other
    input stays as it was."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as W6

    g = torch.Generator(device=dev).manual_seed(SEED + 26)
    bf = torch.bfloat16

    def inputs(B, S, H, hd, dt, logw=None, state0=True):
        r, k, v = (0.5 * torch.randn((B, S, H, hd), generator=g,
                                     device=dev).to(dt) for _ in range(3))
        w = ((-1.5 * torch.rand((B, S, H, hd), generator=g, device=dev))
             .clamp(max=-1e-6) if logw is None
             else torch.full((B, S, H, hd), logw, device=dev))
        u = 0.3 * torch.randn((H, hd), generator=g, device=dev)
        s0 = 0.1 * torch.randn((B, H, hd, hd), generator=g, device=dev)
        if not state0:
            s0.zero_()
        dout = torch.randn((B, S, H, hd), generator=g, device=dev)
        dstate = torch.randn((B, H, hd, hd), generator=g, device=dev)
        return (r, k, v, w, u, s0), dout, dstate

    def states_of(a):
        B, S, H, hd = a[0].shape
        st = torch.empty((B, W6.n_chunks(S), H, hd, hd), device=dev)
        out = W6.wkv6(*a, chunk_states=st)
        return st, out

    r_row = rows.setdefault("wkv6_bwd", {"max_abs_err": 0.0})

    def check_bwd(got, want, dtype, case):
        """bf16 outputs at bf16's bound by element; fp32 outputs at 2e-5
        with the abs part scaled by the output's largest magnitude (sums
        of signed fp32 terms in another order: dS over tokens that do not
        decay, du over B and S, dlogw a difference of running sums); each
        by relative norm too."""
        names = ("dr", "dk", "dv", "dlogw", "du", "dstate0")
        worst = []
        for name, a, b in zip(names, got, want):
            dt = "bfloat16" if a.dtype == torch.bfloat16 else "float32"
            err = (a.float() - b.float()).abs()
            scale = (b.float().abs() if dt == "bfloat16"
                     else b.float().abs().max())
            check(bool(torch.isfinite(a).all()), f"wkv6_bwd {case} {name}: "
                  "non-finite")
            check(bool((err <= TOL[dt] * (1 + scale)).all()),
                  f"wkv6_bwd {case} {name}: max err {err.max().item():.3g} "
                  f"over {TOL[dt]} (abs + rel)")
            rel = ((a.float() - b.float()).norm()
                   / b.float().norm().clamp(min=1e-30)).item()
            check(rel <= BWD_REL_NORM[dt], f"wkv6_bwd {case} {name}: "
                  f"||kernel - plain|| / ||plain|| {rel:.3g} over "
                  f"{BWD_REL_NORM[dt]}")
            r_row["max_abs_err"] = max(r_row["max_abs_err"],
                                       err.max().item())
            worst.append(f"{name} {err.max().item():.2e}/{rel:.1e}")
        print(f"  wkv6_bwd {case}: max |kernel - plain| / relative norm: "
              + ", ".join(worst))

    def check_ds(got, want, case):
        """The dS pass (local and scan kernels) against the plain one: dS
        at every chunk's end and dstate0, fp32 outputs held as
        check_bwd holds them."""
        worst = []
        for name, a, b in zip(("dS", "dstate0"), got, want):
            err = (a - b).abs()
            rel = ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
            check(bool(torch.isfinite(a).all()) and bool(
                (err <= TOL["float32"] * (1 + b.abs().max())).all())
                and rel <= BWD_REL_NORM["float32"],
                f"wkv6_bwd_ds {case} {name}: max err {err.max().item():.3g}"
                f", relative norm {rel:.3g}")
            worst.append(f"{name} {err.max().item():.2e}/{rel:.1e}")
        print(f"  wkv6_bwd_ds (dS pass) {case}: max |kernel - plain| / "
              f"relative norm: " + ", ".join(worst))

    print("[kernels] wkv6_bwd (kernel 7-bwd) vs wkv6_chunked_bwd_ref, from "
          "the kernel forward's chunk states; its dS pass vs "
          "wkv6_bwd_ds_ref")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for B, S, H, hd, logw, s0 in ((2, 1, 32, 64, None, True),
                                      (2, 31, 32, 64, None, True),
                                      (2, 33, 32, 64, None, True),
                                      (3, 33, 4, 16, None, True),
                                      (1, 100, 32, 64, -1.5, True),
                                      (1, 100, 32, 64, -1e-6, True),
                                      (2, 64, 32, 64, None, False)):
            a, dout, ds = inputs(B, S, H, hd, dt, logw, s0)
            st, _ = states_of(a)
            want_st = ref.wkv6_chunked_ref(*a, chunk_states=True)[2]
            check(bool(((st - want_st).abs()
                        <= TOL["float32"] * (1 + want_st.abs())).all()),
                  f"wkv6 {dtype} B={B} S={S}: chunk states differ from "
                  "the plain ones")
            ds = ds if s0 else None
            case = (f"{dtype} B={B} S={S} H={H} hd={hd} logw="
                    f"{logw or 'U(-1.5, 0)'} state0 {'random' if s0 else 0}"
                    f" dstate {'random' if ds is not None else 'none'}")
            check_bwd(W6.wkv6_bwd(*a[:5], st, dout, ds),
                      ref.wkv6_chunked_bwd_ref(*a, st, dout, ds), dtype,
                      case)
            check_ds(W6.wkv6_bwd_ds(a[0], a[3], dout, ds),
                     ref.wkv6_bwd_ds_ref(a[0], a[3], dout, ds), case)

    # phase 15's microbatch: the training path's zero state0 and no
    # final-state gradient
    B, S, H, hd = 1, 4096, 32, 64
    a, dout, _ = inputs(B, S, H, hd, bf, state0=False)
    o, s = W6.wkv6(*a)
    st, (o2, s2) = states_of(a)
    check(torch.equal(o, o2) and torch.equal(s, s2), "wkv6: the chunk-state "
          "output changed the output or the final state")
    check(torch.equal(st[:, 0], a[5]), "wkv6: chunk 0's state is not state0")
    case = f"bfloat16 B={B} S={S} H={H} hd={hd} (phase 15's microbatch)"
    print(f"  wkv6 {case}: out and final state bitwise equal with the "
          f"chunk-state output on and off")
    check_bwd(W6.wkv6_bwd(*a[:5], st, dout),
              ref.wkv6_chunked_bwd_ref(*a, st, dout), "bfloat16", case)
    check_ds(W6.wkv6_bwd_ds(a[0], a[3], dout),
             ref.wkv6_bwd_ds_ref(a[0], a[3], dout), case)
    x1 = W6.wkv6_bwd(*a[:5], st, dout)
    x2 = W6.wkv6_bwd(*a[:5], st, dout)
    check(all(torch.equal(p, q) for p, q in zip(x1, x2)),
          f"wkv6_bwd {case}: two runs differ")
    print(f"  wkv6_bwd {case}: two runs bitwise equal")
    del x1, x2, o, s, o2, s2

    print("[kernels] kernel 7 (training forward) and 7-bwd at phase 15's "
          "microbatch (bf16; CUDA events, median of 30, L2 flushed; plain "
          "median of 5)")
    n = B * S * H * hd
    nst = st.numel()
    fwd_bytes = 3 * 2 * n + 2 * 4 * n + 4 * H * hd + 2 * 4 * B * H * hd * hd
    fwd_flops = 4.0 * hd * n
    for label, fn, plain_fn, extra in (
            ("off", lambda: W6.wkv6(*a),
             lambda: ref.wkv6_chunked_ref(*a), 0),
            ("on", lambda: W6.wkv6(*a, chunk_states=st),
             lambda: ref.wkv6_chunked_ref(*a, chunk_states=True), 4 * nst)):
        ms = time_ms(fn, flush)
        plain = time_ms(plain_fn, flush, reps=5)
        b_ms, b_by = bound(fwd_bytes + extra, fwd_flops, BF16_FLOP_PER_S)
        print(f"  wkv6 {case}, chunk-state output {label}: kernel {ms:.4f} "
              f"ms, plain (chunked) {plain:.4f}, bound {b_ms:.5f} ({b_by}) "
              f"-> {b_ms / ms:.1%} of bound")
        extra_shapes.setdefault("wkv6", []).append(dict(
            ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
            bound_by=b_by, shape=f"training forward, chunk-state output "
            f"{label}: {case}"))
    ms = time_ms(lambda: W6.wkv6_bwd(*a[:5], st, dout), flush)
    plain = time_ms(lambda: ref.wkv6_chunked_bwd_ref(*a, st, dout),
                    flush, reps=5)
    # each pass alone (L2 flushed before each, as before the whole call),
    # and the dS pass (local and scan) as one call
    pass_ms = {p: time_ms(fn, flush) for p, fn in
               W6.bwd_pass_timers(*a[:5], st, dout).items()}
    ds_ms = time_ms(lambda: W6.wkv6_bwd_ds(a[0], a[3], dout), flush)
    ds_plain = time_ms(lambda: ref.wkv6_bwd_ds_ref(a[0], a[3], dout), flush,
                       reps=5)
    # inputs r/k/v, logw, u, the chunk states, dout; outputs dr/dk/dv,
    # dlogw, du's partials, dstate0 (the scratch is the design's, not the
    # function's: not counted)
    nbytes = (3 * 2 * n + 2 * 4 * n + 4 * H * hd + 4 * nst
              + 3 * 2 * n + 4 * n + 4 * B * H * hd + 4 * B * H * hd * hd)
    flops = wkv_bwd_flops(S, H, hd, B)
    b_ms, b_by = bound(nbytes, flops, TF32X3_FLOP_PER_S)
    print(f"  wkv6_bwd {case}: passes " + ", ".join(
        f"{p} {t:.4f} ms" for p, t in pass_ms.items())
        + f" (sum {sum(pass_ms.values()):.4f}); the dS pass (local + scan, "
        f"one call) {ds_ms:.4f} ms, plain (wkv6_bwd_ds_ref) {ds_plain:.4f}")
    print(f"  wkv6_bwd {case}: kernel {ms:.4f} ms, plain "
          f"(wkv6_chunked_bwd_ref) {plain:.4f}, bound {b_ms:.5f} ({b_by}: "
          f"{nbytes / 1e6:.1f} MB of inputs and outputs at 3.35 TB/s, "
          f"{flops / 1e9:.3f} GFLOP of products as 3xTF32 at 495 / 3 "
          f"TFLOP/s; scratch not counted) -> {b_ms / ms:.1%} of bound; "
          f"library: none")
    r_row.update(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                 bound_by=b_by, shape=case, passes_ms=pass_ms,
                 ds_pass_ms=ds_ms)
    del a, dout, st
    torch.cuda.empty_cache()


def _plain_counter(ref, names):
    """Wrap the named plain versions in ``ref`` so that each call is
    recorded; returns (the calls, a function that restores them)."""
    plain = {n: getattr(ref, n) for n in names}
    calls = []

    def counted(name, fn):
        def call(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return call

    for name, fn in plain.items():
        setattr(ref, name, counted(name, fn))

    def restore():
        for name, fn in plain.items():
            setattr(ref, name, fn)
    return calls, restore


def perturb_hybrid(p, dev):
    """A hybrid model's weights with lora_b (zero at init, as in the
    reference), A_log and dt_bias perturbed from a seed, in place, so that
    the LoRA delta and the decay clamp (dt * A past 1.5) take part."""
    import torch
    gz = torch.Generator(device=dev).manual_seed(SEED + 8)
    noise = lambda t, sd: (sd * torch.randn(
        t.shape, generator=gz, device=dev)).to(t.dtype)
    p["shared"]["lora_b"] += noise(p["shared"]["lora_b"], 0.02)
    for layer in p["mamba"] + p.get("mamba_tail", []):
        layer["A_log"] += noise(layer["A_log"], 0.5)
        layer["dt_bias"] += noise(layer["dt_bias"], 1.0)
    return p


def grad_check_layers(cfg) -> int:
    """The depth of ``_grad_checks``'s copies: 2 layers, or for the hybrid
    one group and one tail layer (shared_attn_every + 1), so that the copy
    attends and its tail is on the path."""
    return cfg.shared_attn_every + 1 if cfg.family == "hybrid" else 2


def _grad_checks(tag, dev, cfg, kernels, n_launch, batch_of, fp32_bound,
                 note=None):
    """The checks phases 14, 15 and 16 share, on copies at full width cut
    to ``grad_check_layers(cfg)`` layers (a hybrid copy's weights
    perturbed by ``perturb_hybrid``): at fp32 the kernel path's loss and
    every gradient leaf against the plain path's (``fp32_bound``, seq 256,
    B 2); at bf16 each leaf's distance from the fp32 plain path's through
    the kernels at most GRAD_FACTOR_BF16 times the bf16 plain path's (seq
    1024, B 2). The plain path launches no kernel; ``n_launch`` is each
    kernel's count on one kernel-path call. ``batch_of(cfg, seq)`` gives
    the batch; the fp32 check also prints the largest error of the leaves
    whose path holds ``note``."""
    import torch
    from repro_torch.models.api import build as build_model
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.tree import flatten_with_path, leaves, tree_map

    n_layers = grad_check_layers(cfg)
    cut = dict(num_layers=n_layers)
    if cfg.encoder_layers:
        cut["encoder_layers"] = 2

    def init(c):
        p = build_model(c).init_params(
            torch.Generator(device=dev).manual_seed(SEED))
        return perturb_hybrid(p, dev) if c.family == "hybrid" else p

    cfg32 = dataclasses.replace(cfg, dtype="float32", **cut)
    p32 = init(cfg32)
    batch = batch_of(cfg32, 256)
    reset(*kernels)
    loss, grads = value_and_grad(build_model(cfg32).loss_fn, p32, batch)
    n_k = [k.launches for k in kernels]
    check(n_k == n_launch, f"{tag} fp32: launches {n_k}, want {n_launch}")
    loss_p, grads_p = value_and_grad(
        build_model(cfg32, reference=True).loss_fn, p32, batch)
    check([k.launches for k in kernels] == n_k,
          f"{tag} fp32: the plain path launched a kernel")
    rel = [((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
           for a, b in zip(leaves(grads), leaves(grads_p))]
    paths = [p for p, _ in flatten_with_path(grads)]
    worst = paths[rel.index(max(rel))]
    if note is not None:
        noted = max((x, p) for x, p in zip(rel, paths) if note in p)
        print(f"[{tag}] fp32: the {note} leaves' largest |kernel - plain| "
              f"/ max |plain| {noted[0]:.2e} at {noted[1]} (bound "
              f"{fp32_bound})")
    loss_rel = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
    print(f"[{tag}] {n_layers}-layer fp32 copy at full width, seq 256, B 2: "
          f"loss "
          f"{loss.item():.6f} vs plain {loss_p.item():.6f} (rel "
          f"{loss_rel:.2e}); {len(rel)} gradient leaves, largest |kernel - "
          f"plain| / max |plain| {max(rel):.2e} at {worst} (bound "
          f"{fp32_bound})")
    check(loss_rel <= fp32_bound and max(rel) <= fp32_bound,
          f"{tag} fp32: loss rel {loss_rel:.3g}, worst leaf {max(rel):.3g} "
          f"(bound {fp32_bound})")
    del p32, grads, grads_p
    torch.cuda.empty_cache()

    cfg16 = dataclasses.replace(cfg, **cut)
    params = init(cfg16)
    batch = batch_of(cfg16, 1024)
    reset(*kernels)
    loss_k, g_k = value_and_grad(build_model(cfg16).loss_fn, params, batch)
    check([k.launches for k in kernels] == n_launch,
          f"{tag} bf16: launches {[k.launches for k in kernels]}")
    loss_p, g_p = value_and_grad(
        build_model(cfg16, reference=True).loss_fn, params, batch)
    loss_32, g_32 = value_and_grad(
        build_model(cfg32, reference=True).loss_fn,
        tree_map(lambda t: t.float(), params), batch)
    check([k.launches for k in kernels] == n_launch,
          f"{tag} bf16: the plain path launched a kernel")

    def dist(a, b):
        return ((a.float() - b.float()).norm()
                / b.float().norm().clamp(min=1e-30)).item()

    e_k = [dist(a, c) for a, c in zip(leaves(g_k), leaves(g_32))]
    e_p = [dist(b, c) for b, c in zip(leaves(g_p), leaves(g_32))]
    kp = max(dist(a, b) for a, b in zip(leaves(g_k), leaves(g_p)))
    ratio = max(a / max(b, 1e-30) for a, b in zip(e_k, e_p))
    worst = max(range(len(e_k)), key=lambda i: e_k[i] / max(e_p[i], 1e-30))
    print(f"[{tag}] {n_layers}-layer bf16 copy at full width, seq 1024, B 2: "
          f"loss "
          f"{loss_k.item():.6f}, plain {loss_p.item():.6f}, fp32 plain "
          f"{loss_32.item():.6f}; over {len(e_k)} gradient leaves ||g - "
          f"g_fp32|| / ||g_fp32|| at most {max(e_k):.3e} through the "
          f"kernels and {max(e_p):.3e} through the plain path, worst leaf's "
          f"ratio {ratio:.3f} (leaf {worst}: {e_k[worst]:.3e} vs "
          f"{e_p[worst]:.3e}; bound {GRAD_FACTOR_BF16}); kernels vs plain "
          f"at most {kp:.3e}")
    check(math.isfinite(loss_k.item()) and ratio <= GRAD_FACTOR_BF16,
          f"{tag} bf16: loss {loss_k.item()}; worst leaf's distance from "
          f"fp32 through the kernels / the plain path's {ratio:.3g} (bound "
          f"{GRAD_FACTOR_BF16})")
    del params, g_k, g_p, g_32
    torch.cuda.empty_cache()


def trainer(dev, smi) -> dict:
    """Phase 12: llama3.2-1b whole trains 6 steps (the main run), a
    2-layer fp32 copy's gradient is held against the plain path, and a
    2-layer bf16 copy restarts from a checkpoint bit for bit. Returns the
    main run's launches of kernel 1's backward kernels."""
    import tempfile

    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import full_width_config
    from repro_torch.launch.train import FULL_WIDTH_LR, train_loop
    from repro_torch.models.api import build as build_model
    from repro_torch.training import AdamW, default_schedule, make_train_step
    from repro_torch.tree import leaves

    kernels = (FA.flash_attention, FA.flash_attention_bwd_dot,
               FA.flash_attention_bwd_dkdv, FA.flash_attention_bwd_dq)
    cfg = full_width_config("llama3.2-1b")
    steps, B, S, nm = 6, 8, 4096, 4
    torch.cuda.empty_cache()
    # every plain attention call on the path is counted: there must be none
    plain_calls, restore = _plain_counter(ref, ("attention_ref",
                                                "attention_lse_ref",
                                                "attention_bwd_ref"))
    reset(*kernels)
    try:
        out = train_loop(arch="llama3.2-1b", steps=steps, global_batch=B,
                         seq_len=S, num_microbatches=nm, device="cuda",
                         seed=SEED, log_every=0)
    finally:
        restore()
    torch.cuda.synchronize()
    launched = {k.__name__: k.launches for k in kernels}
    check(out["cfg"] == cfg, "trainer: not llama3.2-1b at its published width")
    check(out["lr"] == FULL_WIDTH_LR, f"trainer: lr {out['lr']}")
    want = cfg.num_layers * nm * steps
    check(all(n == want for n in launched.values()),
          f"trainer: launches {launched}, want {want} each "
          f"({cfg.num_layers} layers x {nm} microbatches x {steps} steps)")
    check(not plain_calls, f"trainer: plain attention on the card's path: "
          f"{sorted(set(plain_calls))}")
    losses = out["losses"]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"trainer: losses {losses}")
    tokens = B * S
    n_params = out["params"]
    # model FLOPs a step: 6 N a token for the weights' products, forward and
    # backward, plus 6 L S H hd a token for causal attention's QK^T and PV
    # (half of 12 L S H hd), forward and backward
    flop = tokens * (6 * n_params + 6 * cfg.num_layers * S * cfg.num_heads
                     * cfg.resolved_head_dim)
    steady = statistics.median(out["step_seconds"][1:])
    print(f"[train] llama3.2-1b whole ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads}, hd "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.3f} B params, bf16), seq {S}, global batch {B} "
          f"in {nm} microbatches, AdamW lr {out['lr']} (train_loop's default "
          f"at a published width) under default_schedule"
          f"({steps}, warmup=1), {steps} steps")
    print(f"[train] losses {[round(x, 4) for x in losses]}")
    print(f"[train] step seconds {[round(x, 3) for x in out['step_seconds']]}"
          f"; median of steps 2-{steps} {steady:.3f} s, {tokens / steady:.0f} "
          f"tokens/s; peak memory {out['peak_bytes'] / 1e9:.2f} GB")
    print(f"[train] model FLOP share: tokens x (6 N + 6 L S H hd) = "
          f"{flop:.4g} FLOP a step / {steady:.3f} s / 989 TFLOP/s = "
          f"{flop / steady / BF16_FLOP_PER_S:.1%}")
    print(f"[train] launches {launched} (= {cfg.num_layers} x {nm} x "
          f"{steps}); plain attention calls 0")
    del out
    torch.cuda.empty_cache()

    # the kernel path's gradient against the plain path's on 2-layer
    # copies at full width: fp32 (the FMA bodies of kernel 1 and its
    # backward), and bf16 (their tensor-core bodies) against the fp32 plain
    # path beside the bf16 plain path
    _grad_checks("train", dev, cfg, kernels, [2] * 4,
                 lambda c, seq: SyntheticLM(vocab_size=c.vocab_size,
                                            seq_len=seq, global_batch=2,
                                            seed=SEED).batch(0, dev),
                 GRAD_REL_BOUND)

    # restart: a 2-layer bf16 copy, 4 steps straight against 2 steps, a
    # checkpoint, a restore into freshly drawn parameters and state, and 2
    # more: the losses and final parameters bitwise equal
    cfgr = dataclasses.replace(cfg, num_layers=2)
    model = build_model(cfgr)
    opt = AdamW(lr=FULL_WIDTH_LR)
    step = make_train_step(model.loss_fn, opt,
                           schedule=default_schedule(4, warmup=1))
    data = SyntheticLM(vocab_size=cfgr.vocab_size, seq_len=512,
                       global_batch=2, seed=SEED)

    def fresh(seed):
        p = model.init_params(torch.Generator(device=dev).manual_seed(seed))
        return p, opt.init(p)

    def run(params, state, lo, hi, losses):
        for i in range(lo, hi):
            params, state, m = step(params, state, data.batch(i, dev))
            losses.append(m["loss"].item())
        return params, state

    torch.use_deterministic_algorithms(True)
    try:
        straight, resumed = [], []
        p_a, _ = run(*fresh(SEED), 0, 4, straight)
        p_b, s_b = run(*fresh(SEED), 0, 2, resumed)
        with tempfile.TemporaryDirectory() as d:
            store = CheckpointStore(d)
            store.save(2, {"params": p_b, "opt": s_b},
                       extra={"data_step": 2})
            del p_b, s_b
            p_c, s_c = fresh(SEED + 1)
            restored, extra = store.restore({"params": p_c, "opt": s_c})
        p_b, _ = run(restored["params"], restored["opt"],
                     extra["data_step"], 4, resumed)
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, b) for a, b in zip(leaves(p_a), leaves(p_b)))
    check(straight == resumed and same,
          f"trainer restart: losses {straight} vs {resumed}, final "
          f"parameters equal: {same}")
    print(f"[train] restart (2-layer bf16 copy, seq 512, B 2, deterministic "
          f"algorithms): losses {straight} straight and through a "
          f"checkpoint at step 2, bitwise equal; final parameters bitwise "
          f"equal")
    print(f"[train] card: {smi}")
    del p_a, p_b, restored
    torch.cuda.empty_cache()
    return {k: launched[k] for k in ("flash_attention_bwd_dot",
                                     "flash_attention_bwd_dkdv",
                                     "flash_attention_bwd_dq")}


def moe_trainer(dev, smi) -> dict:
    """Phase 13: phi3.5-moe at its published width, 2 of its 32 layers,
    trains 6 steps (the main run); a 2-layer fp32 copy's gradient is held
    against the plain path, a 2-layer bf16 copy's against the fp32 plain
    path beside the bf16 plain path's, and two runs of one step from the
    same state give bitwise-equal parameters. Returns the main run's
    launches of kernel 6's backward kernels."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import expert_matmul as EM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import full_width_config
    from repro_torch.launch.train import FULL_WIDTH_LR, train_loop
    from repro_torch.models import moe as MOE
    from repro_torch.models.api import build as build_model
    from repro_torch.training import AdamW, make_train_step
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.tree import flatten_with_path, leaves, tree_map

    arch = "phi3.5-moe-42b-a6.6b"
    # 2 of 32 layers: a layer's weights and optimizer state take 20.8 GB
    # (1.300 B parameters at 16 bytes), a third would pass 80 GB
    L, steps, B, S, nm = 2, 6, 4, 4096, 4
    cfg = full_width_config(arch, L)
    attn = (FA.flash_attention, FA.flash_attention_bwd_dot,
            FA.flash_attention_bwd_dkdv, FA.flash_attention_bwd_dq)
    experts = (EM.expert_matmul, EM.expert_matmul_bwd_dx,
               EM.expert_matmul_bwd_dw)
    kernels = attn + experts
    names = ("attention_ref", "attention_lse_ref", "attention_bwd_ref",
             "expert_matmul_ref", "expert_matmul_bwd_ref")
    # earlier phases' engines and caches may sit in reference cycles
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[moe-train] device memory allocated before the run: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()
    plain_calls, restore = _plain_counter(ref, names)
    reset(*kernels)
    for k in experts[1:]:
        k.bodies = {}
    try:
        out = train_loop(arch=arch, steps=steps, global_batch=B, seq_len=S,
                         num_microbatches=nm, device="cuda", num_layers=L,
                         seed=SEED, log_every=0)
    finally:
        restore()
    torch.cuda.synchronize()
    launched = {k.__name__: k.launches for k in kernels}
    check(out["cfg"] == cfg, f"moe trainer: not {arch} at its published "
          f"width and {L} layers")
    check(out["lr"] == FULL_WIDTH_LR, f"moe trainer: lr {out['lr']}")
    want = {k.__name__: (1 if k in attn else 3) * L * nm * steps
            for k in kernels}
    check(launched == want, f"moe trainer: launches {launched}, want {want} "
          f"(one attention call and 3 expert GEMMs a layer and microbatch)")
    check(not plain_calls, f"moe trainer: plain kernels on the card's path: "
          f"{sorted(set(plain_calls))}")
    bodies = {k.__name__: k.bodies for k in experts[1:]}
    check(all(b == {"wgmma": want[n]} for n, b in bodies.items()),
          f"moe trainer: kernel 6's backward bodies {bodies}, want every "
          f"launch on wgmma")
    losses = out["losses"]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"moe trainer: losses {losses}")
    tokens = B * S
    torch.cuda.empty_cache()
    # the parameters the later checks start from (the main run's draw);
    # active parameters a token: every weight but the embedding table (a
    # lookup), each expert stack at k / E of its size
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(SEED))
    k_e = cfg.experts_per_token / cfg.num_experts
    active = sum(t.numel() * (k_e if path[-1] in ("w_gate", "w_up", "w_down")
                              and "moe" in path else 1)
                 for path, t in flatten_with_path(params)
                 if path != ("embed", "embed"))
    # model FLOPs a step: 6 N_active a token for the weights' products,
    # forward and backward, plus 6 L S H hd a token for causal attention's
    # QK^T and PV (half of 12 L S H hd), forward and backward
    flop = tokens * (6 * active + 6 * L * S * cfg.num_heads
                     * cfg.resolved_head_dim)
    steady = statistics.median(out["step_seconds"][1:])
    n_params = out["params"]
    print(f"[moe-train] {arch} at its published width, {L} of its 32 "
          f"layers (d {cfg.d_model}, {cfg.num_heads} heads over "
          f"{cfg.num_kv_heads}, hd {cfg.resolved_head_dim}, {cfg.num_experts}"
          f" experts top-{cfg.experts_per_token} of F {cfg.resolved_moe_d_ff},"
          f" vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B params, "
          f"{active / 1e9:.3f} B active a token, bf16), seq {S}, global "
          f"batch {B} in {nm} microbatches ({tokens} tokens a step), AdamW lr "
          f"{out['lr']} under default_schedule({steps}, warmup=1), {steps} "
          f"steps")
    print(f"[moe-train] memory reckoning: {n_params / 1e9:.3f} B params x 16 "
          f"bytes (bf16 params and grads, the fp32 accumulator, fp32 mu/nu) "
          f"= {16 * n_params / 1e9:.1f} GB; activations ~3.9 GB a layer "
          f"(the C = T buckets autograd keeps: xe 0.54 GB, gate, up, silu "
          f"and their product 0.84 GB each), logits and their fp32 loss "
          f"~1.3 GB: ~{16 * n_params / 1e9 + 3.9 * L + 1.3:.0f} GB; measured "
          f"peak {out['peak_bytes'] / 1e9:.2f} GB")
    print(f"[moe-train] losses {[round(x, 4) for x in losses]}")
    step_s = [round(x, 3) for x in out["step_seconds"]]
    print(f"[moe-train] step seconds {step_s}; median of steps 2-{steps} "
          f"{steady:.3f} s, {tokens / steady:.0f} tokens/s; peak memory "
          f"{out['peak_bytes'] / 1e9:.2f} GB")
    print(f"[moe-train] model FLOP share: tokens x (6 N_active + 6 L S H hd) "
          f"= {flop:.4g} FLOP a step / {steady:.3f} s / 989 TFLOP/s = "
          f"{flop / steady / BF16_FLOP_PER_S:.1%}")
    print(f"[moe-train] launches {launched} (a step: "
          f"{ {k: v // steps for k, v in launched.items()} }); plain kernel "
          f"calls 0; kernel 6's backward by body {bodies}")
    del out
    torch.cuda.empty_cache()

    # routing of each path's layers, recorded by wrapping _route: how many
    # tokens pick another top-2 set than the fp32 plain path's
    routes = []
    route = MOE._route

    def recording(*a, **kw):
        w_, idx, aux = route(*a, **kw)
        routes.append(idx.sort(dim=-1).values)
        return w_, idx, aux

    def routed(fn, *a):
        routes.clear()
        MOE._route = recording
        try:
            got = fn(*a)
        finally:
            MOE._route = route
        return got, list(routes)

    def flips(ra, rb):
        return sum(int((a != b).any(-1).sum()) for a, b in zip(ra, rb))

    # the kernel path's gradient against the plain path's: 2 layers at
    # full width, fp32 (the FMA bodies of kernels 1 and 6 and their
    # backward kernels)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = build_model(cfg32).init_params(
        torch.Generator(device=dev).manual_seed(SEED))
    batch = SyntheticLM(vocab_size=cfg32.vocab_size, seq_len=256,
                        global_batch=2, seed=SEED).batch(0, dev)
    reset(*kernels)
    (loss, grads), r_k = routed(value_and_grad, build_model(cfg32).loss_fn,
                                p32, batch)
    n_k = [k.launches for k in kernels]
    check(n_k == [L] * 4 + [3 * L] * 3, f"moe trainer fp32: launches {n_k}")
    (loss_p, grads_p), r_p = routed(value_and_grad, build_model(
        cfg32, reference=True).loss_fn, p32, batch)
    check([k.launches for k in kernels] == n_k,
          "moe trainer fp32: the plain path launched a kernel")
    rel = [((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
           for a, b in zip(leaves(grads), leaves(grads_p))]
    loss_rel = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
    print(f"[moe-train] 2-layer fp32 copy at full width, seq 256, B 2: loss "
          f"{loss.item():.6f} vs plain {loss_p.item():.6f} (rel "
          f"{loss_rel:.2e}); {len(rel)} gradient leaves, largest |kernel - "
          f"plain| / max |plain| {max(rel):.2e} (bound {GRAD_REL_BOUND}); "
          f"tokens routed to another top-2 set than the plain path's: "
          f"{flips(r_k, r_p)} of {sum(len(r) for r in r_p)}")
    check(loss_rel <= GRAD_REL_BOUND and max(rel) <= GRAD_REL_BOUND,
          f"moe trainer fp32: loss rel {loss_rel:.3g}, worst leaf "
          f"{max(rel):.3g} (bound {GRAD_REL_BOUND})")
    del p32, grads, grads_p
    torch.cuda.empty_cache()

    # the same at bf16, through the kernels' tensor-core bodies: 2 layers
    # at full width, seq 1024, B 2; each gradient leaf's distance from the
    # fp32 plain path's (the same parameters, upcast), through the kernels
    # against the bf16 plain path's own
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=1024,
                        global_batch=2, seed=SEED).batch(0, dev)
    reset(*kernels)
    (loss_k, g_k), r_k = routed(value_and_grad, build_model(cfg).loss_fn,
                                params, batch)
    check([k.launches for k in kernels] == n_k,
          f"moe trainer bf16: launches {[k.launches for k in kernels]}")
    (loss_p, g_p), r_p = routed(value_and_grad, build_model(
        cfg, reference=True).loss_fn, params, batch)
    params32 = tree_map(lambda t: t.float(), params)
    (loss_32, g_32), r_32 = routed(value_and_grad, build_model(
        cfg32, reference=True).loss_fn, params32, batch)
    del params32
    check([k.launches for k in kernels] == n_k,
          "moe trainer bf16: the plain path launched a kernel")

    def dist(a, b):
        return ((a.float() - b.float()).norm()
                / b.float().norm().clamp(min=1e-30)).item()

    e_k = [dist(a, c) for a, c in zip(leaves(g_k), leaves(g_32))]
    e_p = [dist(b, c) for b, c in zip(leaves(g_p), leaves(g_32))]
    kp = max(dist(a, b) for a, b in zip(leaves(g_k), leaves(g_p)))
    ratio = max(a / b for a, b in zip(e_k, e_p))
    worst = max(range(len(e_k)), key=lambda i: e_k[i] / e_p[i])
    n_tok = sum(len(r) for r in r_32)
    print(f"[moe-train] 2-layer bf16 copy at full width, seq 1024, B 2: loss "
          f"{loss_k.item():.6f}, plain {loss_p.item():.6f}, fp32 plain "
          f"{loss_32.item():.6f}; over {len(e_k)} gradient leaves ||g - "
          f"g_fp32|| / ||g_fp32|| at most {max(e_k):.3e} through the "
          f"kernels and {max(e_p):.3e} through the plain path, worst leaf's "
          f"ratio {ratio:.3f} (leaf {worst}: {e_k[worst]:.3e} vs "
          f"{e_p[worst]:.3e}; bound {GRAD_FACTOR_BF16}); kernels vs plain at "
          f"most {kp:.3e}; tokens (x layers) routed to another top-2 set "
          f"than the fp32 plain path's: {flips(r_k, r_32)} through the "
          f"kernels, {flips(r_p, r_32)} through the bf16 plain path, of "
          f"{n_tok}")
    check(math.isfinite(loss_k.item()) and ratio <= GRAD_FACTOR_BF16,
          f"moe trainer bf16: loss {loss_k.item()}; worst leaf's distance "
          f"from fp32 through the kernels / the plain path's {ratio:.3g} "
          f"(bound {GRAD_FACTOR_BF16})")
    del g_k, g_p, g_32
    torch.cuda.empty_cache()

    # two runs of one step (one microbatch) from the same parameters and a
    # fresh optimizer state: bitwise-equal parameters. The hand-written
    # kernels use no atomics; deterministic algorithms pin PyTorch's own
    # (cuBLAS, the scatter and gather backwards)
    opt = AdamW(lr=FULL_WIDTH_LR)
    step = make_train_step(build_model(cfg).loss_fn, opt)
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            p_, _, m_ = step(params, opt.init(params), batch)
            runs.append((p_, m_["loss"].item()))
            del p_, m_
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, b) for a, b in zip(leaves(runs[0][0]),
                                                 leaves(runs[1][0])))
    check(same and runs[0][1] == runs[1][1],
          f"moe trainer: two runs of one step differ (losses "
          f"{runs[0][1]}, {runs[1][1]}; parameters equal: {same})")
    print(f"[moe-train] two runs of one step (2-layer bf16 at full width, "
          f"seq 1024, B 2, deterministic algorithms) from the same state: "
          f"losses {runs[0][1]} and {runs[1][1]}, parameters bitwise equal")
    print(f"[moe-train] card: {smi}")
    del params, runs
    torch.cuda.empty_cache()
    return {k: launched[k] for k in ("expert_matmul_bwd_dx",
                                     "expert_matmul_bwd_dw")}


def encdec_trainer(dev, smi) -> None:
    """Phase 14: seamless-m4t-medium whole (12 encoder and 12 decoder
    layers) trains 6 steps through ``training.make_train_step`` (the main
    run: ``train_loop`` takes no frames), each batch's frames normal x
    0.02 from the seed; then the 2-layer copies' gradient checks."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import full_width_config
    from repro_torch.launch.train import FULL_WIDTH_LR
    from repro_torch.models.api import build as build_model
    from repro_torch.training import AdamW, default_schedule, make_train_step
    from repro_torch.tree import flatten_with_path, leaves

    arch = "seamless-m4t-medium"
    cfg = full_width_config(arch)
    # 8 rows of 1024 tokens over 160 frames a step, in 4 microbatches of 2
    # rows: the fp32 logits at vocab 256,206 take 1 GB per 1024 tokens
    steps, B, S, nm = 6, 8, 1024, 4
    Se, L, Le = cfg.num_prefix_embeddings, cfg.num_layers, cfg.encoder_layers
    kernels = (FA.flash_attention, FA.flash_attention_bwd_dot,
               FA.flash_attention_bwd_dkdv, FA.flash_attention_bwd_dq)

    def batch_of(c, seq, rows=2, step=0):
        b = SyntheticLM(vocab_size=c.vocab_size, seq_len=seq,
                        global_batch=rows, seed=SEED).batch(step, dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 100 + step)
        b["frames"] = 0.02 * torch.randn((rows, Se, c.d_model), generator=g,
                                         device=dev)
        return b

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[encdec-train] device memory allocated before the run: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    model = build_model(cfg)
    opt = AdamW(lr=FULL_WIDTH_LR)
    step = make_train_step(model.loss_fn, opt, num_microbatches=nm,
                           schedule=default_schedule(steps, warmup=1))
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    state = opt.init(params)
    n_params = sum(t.numel() for t in leaves(params))
    # model parameters by the tokens that go through them: the encoder,
    # the frontend projection and every decoder layer's cross K/V
    # projections see the frames, the rest the decoder's tokens; the
    # embedding table is a lookup
    n_enc = sum(t.numel() for path, t in flatten_with_path(params)
                if path[0] in ("encoder", "frontend_proj")
                or ("cross" in path and path[-1] in ("wk", "wv")))
    n_dec = n_params - n_enc - params["embed"]["embed"].numel()
    calls, restore = _plain_counter(ref, ("attention_ref",
                                          "attention_lse_ref",
                                          "attention_bwd_ref"))
    reset(*kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    try:
        for i in range(steps):
            batch = batch_of(cfg, S, B, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(m["loss"].item())          # synchronises
            secs.append(time.perf_counter() - t0)
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {k.__name__: k.launches for k in kernels}
    want = (Le + 2 * L) * nm * steps
    check(all(v == want for v in launched.values()),
          f"encdec trainer: launches {launched}, want {want} each ((12 "
          f"encoder + 12 self + 12 cross) x {nm} microbatches x {steps} "
          f"steps)")
    check(not calls, f"encdec trainer: plain attention on the card's path: "
          f"{sorted(set(calls))}")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"encdec trainer: losses {losses}")
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    dec_tok, enc_tok = B * S, B * Se
    # model FLOPs a step: 6 N a token for the weights' products, forward
    # and backward, the frames' through the encoder's; attention's QK^T
    # and PV forward and backward: 12 Se H hd a token and layer over the
    # encoder's keys (the encoder and the cross-attention), 6 S H hd for
    # the decoder's causal half
    flop = (6 * (n_dec * dec_tok + n_enc * enc_tok)
            + 12 * Le * Se * H * hd * enc_tok
            + (6 * S + 12 * Se) * L * H * hd * dec_tok)
    steady = statistics.median(secs[1:])
    logit_gb = 2 * S * cfg.vocab_size * 12 / 1e9
    print(f"[encdec-train] {arch} whole ({Le} encoder + {L} decoder layers, "
          f"d {cfg.d_model}, {H} heads of {hd}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.3f} B params: {n_enc / 1e9:.3f} B over the "
          f"frames, {n_dec / 1e9:.3f} B over the tokens, bf16), seq {S} "
          f"over {Se} frames (normal x 0.02), global batch {B} in {nm} "
          f"microbatches ({dec_tok} tokens a step), AdamW lr {FULL_WIDTH_LR}"
          f" under default_schedule({steps}, warmup=1), {steps} steps of "
          f"make_train_step")
    print(f"[encdec-train] memory reckoning: {n_params / 1e9:.3f} B params "
          f"x 16 bytes = {16 * n_params / 1e9:.1f} GB; a microbatch's logits "
          f"(bf16, their fp32 copy and both gradients, 12 bytes a logit) "
          f"{logit_gb:.1f} GB; activations ~2 GB: ~"
          f"{16 * n_params / 1e9 + logit_gb + 2:.0f} GB; measured peak "
          f"{peak / 1e9:.2f} GB")
    print(f"[encdec-train] losses {[round(x, 4) for x in losses]}")
    print(f"[encdec-train] step seconds {[round(x, 3) for x in secs]}; "
          f"median of steps 2-{steps} {steady:.3f} s, {dec_tok / steady:.0f}"
          f" tokens/s; peak memory {peak / 1e9:.2f} GB")
    print(f"[encdec-train] model FLOP share: {flop:.4g} FLOP a step / "
          f"{steady:.3f} s / 989 TFLOP/s = "
          f"{flop / steady / BF16_FLOP_PER_S:.1%}")
    print(f"[encdec-train] launches {launched} (a step: "
          f"{ {k: v // steps for k, v in launched.items()} }); plain "
          f"attention calls 0")
    del params, state, step, model
    gc.collect()
    torch.cuda.empty_cache()
    # the head's products at a microbatch (2 x 1024 tokens): the forward
    # x W^T and the weight's gradient dy^T x, over the vocab of 256,206
    # rows (not a multiple of 8: the logits' rows are not 16-byte
    # aligned) and over 256,208
    g = torch.Generator(device=dev).manual_seed(SEED + 140)
    bf = torch.bfloat16
    x = torch.randn((2 * S, cfg.d_model), generator=g, device=dev).to(bf)
    head = []
    for V in (cfg.vocab_size, -(-cfg.vocab_size // 8) * 8):
        w = torch.randn((V, cfg.d_model), generator=g, device=dev).to(bf)
        dy = torch.randn((2 * S, V), generator=g, device=dev).to(bf)
        fl = 2.0 * 2 * S * cfg.d_model * V
        f_ms = time_ms(lambda: torch.nn.functional.linear(x, w), lambda: None)
        w_ms = time_ms(lambda: dy.t() @ x, lambda: None)
        head.append(f"vocab {V}: x W^T {f_ms:.4f} ms "
                    f"({fl / f_ms / 1e9:.0f} TFLOP/s), dy^T x {w_ms:.4f} ms "
                    f"({fl / w_ms / 1e9:.0f} TFLOP/s)")
        del w, dy
    print(f"[encdec-train] the head's GEMMs at a microbatch ({2 * S} "
          f"tokens, bf16, CUDA events, median of 30): " + "; ".join(head))
    del x
    torch.cuda.empty_cache()
    _grad_checks("encdec-train", dev, cfg, kernels, [6] * 4,
                 lambda c, seq: batch_of(c, seq), GRAD_REL_BOUND)
    print(f"[encdec-train] card: {smi}")


def ssm_trainer(dev, smi, bwd_ms) -> dict:
    """Phase 15: rwkv6-1.6b whole (24 layers) trains 6 steps through
    ``launch/train.py::train_loop`` (the main run); then the 2-layer
    copies' gradient checks. ``bwd_ms``: kernel 7-bwd's time at this
    microbatch from phase 3, for its share of the step. Returns the main
    run's launches of kernel 7-bwd, and of each of its passes."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as W6
    from repro_torch.launch.serve import full_width_config
    from repro_torch.launch.train import FULL_WIDTH_LR, train_loop

    arch = "rwkv6-1.6b"
    cfg = full_width_config(arch)
    # 4 rows of 4096 tokens a step in 4 microbatches of one row: a second
    # row's activations (~22 GB) would pass 80 GB
    steps, B, S, nm = 6, 4, 4096, 4
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    kernels = (W6.wkv6, W6.wkv6_bwd)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[ssm-train] device memory allocated before the run: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    calls, restore = _plain_counter(ref, ("wkv6_ref", "wkv6_chunked_ref",
                                          "wkv6_chunked_bwd_ref"))
    reset(*kernels)
    W6.wkv6_bwd.passes = dict.fromkeys(W6.PASSES, 0)
    try:
        out = train_loop(arch=arch, steps=steps, global_batch=B, seq_len=S,
                         num_microbatches=nm, device="cuda", seed=SEED,
                         log_every=0)
    finally:
        restore()
    torch.cuda.synchronize()
    launched = {k.__name__: k.launches for k in kernels}
    passes = dict(W6.wkv6_bwd.passes)
    check(out["cfg"] == cfg, f"ssm trainer: not {arch} whole")
    check(out["lr"] == FULL_WIDTH_LR, f"ssm trainer: lr {out['lr']}")
    want = L * nm * steps
    check(all(v == want for v in launched.values()),
          f"ssm trainer: launches {launched}, want {want} each ({L} layers "
          f"x {nm} microbatches x {steps} steps)")
    check(all(v == want for v in passes.values()),
          f"ssm trainer: kernel 7-bwd's pass launches {passes}, want {want} "
          f"each")
    check(not calls, f"ssm trainer: plain WKV6 on the card's path: "
          f"{sorted(set(calls))}")
    losses = out["losses"]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"ssm trainer: losses {losses}")
    tokens = B * S
    n_params = out["params"]
    n_model = n_params - cfg.vocab_size * cfg.d_model   # the table: a lookup
    # model FLOPs a step: 6 N a token for the weights' products (the
    # embedding table excluded), forward and backward, plus the WKV
    # recurrence's k v^T and r S, 4 hd d a token and layer, forward and
    # backward (x 3)
    flop = tokens * (6 * n_model + 12 * L * hd * cfg.d_model)
    steady = statistics.median(out["step_seconds"][1:])
    n_chunk = -(-S // 32)
    st_gb = L * n_chunk * H * hd * hd * 4 / 1e9
    print(f"[ssm-train] {arch} whole ({L} layers, d {cfg.d_model}, {H} heads "
          f"of {hd}, F {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.3f} B params, bf16), seq {S}, global batch {B} "
          f"in {nm} microbatches ({tokens} tokens a step), AdamW lr "
          f"{out['lr']} (train_loop's default at a published width) under "
          f"default_schedule({steps}, warmup=1), {steps} steps")
    print(f"[ssm-train] memory reckoning: {n_params / 1e9:.3f} B params x 16 "
          f"bytes = {16 * n_params / 1e9:.1f} GB; activations ~220 KB a "
          f"token and layer = {220e3 * S * L / 1e9:.1f} GB a microbatch; "
          f"the chunk states {st_gb:.2f} GB; the logits 12 bytes each "
          f"{S * cfg.vocab_size * 12 / 1e9:.1f} GB: ~"
          f"{16 * n_params / 1e9 + 220e3 * S * L / 1e9 + st_gb + S * cfg.vocab_size * 12 / 1e9:.0f}"
          f" GB; measured peak {out['peak_bytes'] / 1e9:.2f} GB")
    print(f"[ssm-train] losses {[round(x, 4) for x in losses]}")
    print(f"[ssm-train] step seconds "
          f"{[round(x, 3) for x in out['step_seconds']]}; median of steps "
          f"2-{steps} {steady:.3f} s, {tokens / steady:.0f} tokens/s; peak "
          f"memory {out['peak_bytes'] / 1e9:.2f} GB")
    print(f"[ssm-train] model FLOP share: tokens x (6 N + 12 L hd d) = "
          f"{flop:.4g} FLOP a step / {steady:.3f} s / 989 TFLOP/s = "
          f"{flop / steady / BF16_FLOP_PER_S:.1%}")
    print(f"[ssm-train] launches {launched} (a step: "
          f"{ {k: v // steps for k, v in launched.items()} }); kernel "
          f"7-bwd's passes {passes}; plain WKV6 calls 0")
    per_step = launched["wkv6_bwd"] // steps
    print(f"[ssm-train] kernel 7-bwd's share of the step: {per_step} x "
          f"{bwd_ms:.4f} ms (phase 3, this microbatch) = "
          f"{per_step * bwd_ms:.1f} ms of {steady * 1e3:.1f} ms, "
          f"{per_step * bwd_ms / 1e3 / steady:.1%}")
    del out
    gc.collect()
    torch.cuda.empty_cache()

    def batch_of(c, seq):
        return SyntheticLM(vocab_size=c.vocab_size, seq_len=seq,
                           global_batch=2, seed=SEED).batch(0, dev)

    _grad_checks("ssm-train", dev, cfg, kernels, [2, 2], batch_of,
                 GRAD_REL_BOUND_WKV, note="bonus_u")
    print(f"[ssm-train] card: {smi}")
    return {"wkv6_bwd": launched["wkv6_bwd"], "wkv6_bwd_passes": passes}


def hybrid_trainer(dev, smi, extra_shapes) -> None:
    """Phase 16: zamba2-7b at its published width, 13 of its 81 layers (2
    groups of the shared attention + MLP block and 6 Mamba2 layers, then 1
    tail layer), trains 6 steps through ``launch/train.py::train_loop``
    (the main run); then the 7-layer copies' gradient checks (one group,
    one tail layer). ``extra_shapes``: phase 3's rows, whose hd-112
    training-shape entries of kernel 1 and 1-bwd take this run's
    launches, and give kernel 1's and 1-bwd's share of the step."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import full_width_config
    from repro_torch.launch.train import FULL_WIDTH_LR, train_loop
    from repro_torch.models.transformer import _zamba_grouping

    arch, L = "zamba2-7b", 13
    cfg = dataclasses.replace(full_width_config(arch), num_layers=L)
    groups, per, tail = _zamba_grouping(cfg)
    check((groups, per, tail) == (2, 6, 1),
          f"hybrid trainer: grouping {(groups, per, tail)}")
    # 4 rows of 4096 tokens a step in 4 microbatches of one row, as phase
    # 15
    steps, B, S, nm = 6, 4, 4096, 4
    kernels = (FA.flash_attention, FA.flash_attention_bwd_dot,
               FA.flash_attention_bwd_dkdv, FA.flash_attention_bwd_dq)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[hybrid-train] device memory allocated before the run: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; opt_einsum "
          f"available {torch.backends.opt_einsum.is_available()}")
    calls, restore = _plain_counter(ref, ("attention_ref",
                                          "attention_lse_ref",
                                          "attention_bwd_ref"))
    reset(*kernels)
    try:
        out = train_loop(arch=arch, steps=steps, global_batch=B, seq_len=S,
                         num_microbatches=nm, device="cuda", seed=SEED,
                         num_layers=L, log_every=0)
    finally:
        restore()
    torch.cuda.synchronize()
    launched = {k.__name__: k.launches for k in kernels}
    check(out["cfg"] == cfg, f"hybrid trainer: not {arch} at {L} layers")
    check(out["lr"] == FULL_WIDTH_LR, f"hybrid trainer: lr {out['lr']}")
    want = groups * nm * steps
    check(all(v == want for v in launched.values()),
          f"hybrid trainer: launches {launched}, want {want} each ({groups} "
          f"groups x {nm} microbatches x {steps} steps)")
    check(not calls, f"hybrid trainer: plain attention on the card's path: "
          f"{sorted(set(calls))}")
    losses = out["losses"]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"hybrid trainer: losses {losses}")
    check(out["peak_bytes"] < 80e9,
          f"hybrid trainer: peak {out['peak_bytes'] / 1e9:.2f} GB")

    tokens = B * S
    n_params = out["params"]
    d, V = cfg.d_model, cfg.vocab_size
    H, hd, F_ = cfg.num_heads, cfg.resolved_head_dim, cfg.d_ff
    d_in, N, P = cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_head_dim
    Hs, C = d_in // P, 32
    shared = 4 * d * H * hd + 3 * d * F_            # attention + MLP
    n_mamba = (n_params - shared - 2 * V * d
               - groups * cfg.shared_attn_lora_rank * 4 * d) // L
    # model FLOPs a step: 6 N' a token for the weights' products, forward
    # and backward, N' the parameters with the shared block counted once a
    # group and the embedding table excluded (a lookup); the attention's
    # QK^T and PV over the causal half, 6 S H hd a token and group; the
    # SSD's products (the causal half of each chunk's C B^T and its
    # scores x, each chunk's state contribution and the inter-chunk read
    # of the state), 3 x (C N + C Hs P + 4 Hs P N) a token and layer
    n_eff = n_params - V * d + (groups - 1) * shared
    flop = tokens * (6 * n_eff + 6 * groups * S * H * hd
                     + 3 * L * (C * N + C * Hs * P + 4 * Hs * P * N))
    steady = statistics.median(out["step_seconds"][1:])
    # activations a microbatch row, by shapes: a Mamba2 layer saves its
    # in_proj output (bf16), ~6 conv-stream tensors (bf16) and ~12 fp32
    # tensors of x's size in the SSD and the gated norm; the shared block
    # ~12 d + 4 F bf16 values a token; the logits 12 bytes each
    act_m = S * (2 * (2 * d_in + 2 * N + Hs) + 6 * 2 * (d_in + 2 * N)
                 + 12 * 4 * d_in)
    act_s = S * 2 * (12 * d + 4 * F_)
    logits = S * V * 12
    reckon = 16 * n_params + L * act_m + groups * act_s + logits
    print(f"[hybrid-train] {arch} at full width, {L} of its 81 layers "
          f"({groups} groups of the shared attention + MLP block with a "
          f"rank-{cfg.shared_attn_lora_rank} LoRA a group and {per} Mamba2 "
          f"layers, then {tail} tail layer; d {d}, {H} heads of {hd} over "
          f"{cfg.num_kv_heads}, F {F_}, {Hs} SSM heads of {P}, state {N}, "
          f"vocab {V}; {n_params / 1e9:.3f} B params, a Mamba2 layer "
          f"{n_mamba / 1e6:.1f} M, the shared block {shared / 1e6:.1f} M, "
          f"bf16), seq {S}, global batch {B} in {nm} microbatches ({tokens} "
          f"tokens a step), AdamW lr {out['lr']} (train_loop's default at a "
          f"published width) under default_schedule({steps}, warmup=1), "
          f"{steps} steps")
    print(f"[hybrid-train] memory reckoning: {n_params / 1e9:.3f} B params x "
          f"16 bytes = {16 * n_params / 1e9:.1f} GB; activations "
          f"{act_m / 1e9:.2f} GB a Mamba2 layer x {L} + {act_s / 1e9:.2f} GB "
          f"a group's shared block x {groups}; the logits "
          f"{logits / 1e9:.2f} GB: ~{reckon / 1e9:.1f} GB; measured peak "
          f"{out['peak_bytes'] / 1e9:.2f} GB")
    print(f"[hybrid-train] losses {[round(x, 4) for x in losses]}")
    print(f"[hybrid-train] step seconds "
          f"{[round(x, 3) for x in out['step_seconds']]}; median of steps "
          f"2-{steps} {steady:.3f} s, {tokens / steady:.0f} tokens/s; peak "
          f"memory {out['peak_bytes'] / 1e9:.2f} GB")
    print(f"[hybrid-train] model FLOP share: tokens x (6 N' + 6 groups S H "
          f"hd + 3 L (C N + C Hs P + 4 Hs P N)), N' = {n_eff / 1e9:.3f} B "
          f"(the shared block once a group, the embedding table excluded) = "
          f"{flop:.4g} FLOP a step / {steady:.3f} s / 989 TFLOP/s = "
          f"{flop / steady / BF16_FLOP_PER_S:.1%}")
    print(f"[hybrid-train] launches {launched} (= {groups} x {nm} x "
          f"{steps}); plain attention calls 0")
    # phase 3's times at this shape: kernel 1 with the LSE and 1-bwd
    attn_ms = 0.0
    for name in launched:
        for e in extra_shapes.get(name, []):
            if "hd=112" in e["shape"] and "Sq=Sk=4096" in e["shape"]:
                e["launches"] = launched[name]
                attn_ms += e["ms"] * launched[name] / steps
    print(f"[hybrid-train] kernel 1 and 1-bwd's share of the step: "
          f"{attn_ms:.1f} ms (phase 3's times at this shape x launches a "
          f"step) of {steady * 1e3:.1f} ms, {attn_ms / 1e3 / steady:.1%}")
    del out
    gc.collect()
    torch.cuda.empty_cache()

    def batch_of(c, seq):
        return SyntheticLM(vocab_size=c.vocab_size, seq_len=seq,
                           global_batch=2, seed=SEED).batch(0, dev)

    _grad_checks("hybrid-train", dev, cfg, kernels, [1] * 4, batch_of,
                 GRAD_REL_BOUND_HYBRID, note="lora_a")
    print(f"[hybrid-train] card: {smi}")


def vlm_trainer(dev, smi, extra_shapes) -> None:
    """Phase 17: paligemma-3b whole (18 layers, 8 heads of 256 over one KV
    head) trains 6 steps through ``training.make_train_step`` (the main
    run: ``train_loop`` takes no patches), each row 256 patches (normal x
    0.02 from the seed) ahead of 512 text tokens, a bidirectional prefix;
    then the 2-layer copies' gradient checks. ``extra_shapes``: phase 3's
    rows, whose hd-256 sub-rows at this microbatch take this run's
    launches."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import full_width_config
    from repro_torch.launch.train import FULL_WIDTH_LR
    from repro_torch.models.api import build as build_model
    from repro_torch.training import AdamW, default_schedule, make_train_step
    from repro_torch.tree import leaves

    arch = "paligemma-3b"
    cfg = full_width_config(arch)
    # 16 rows of 256 patches + 512 text tokens a step, in 4 microbatches of
    # 4 rows: the bf16 logits over the text at vocab 257,216, their fp32
    # copy and both gradients take 6.3 GB a microbatch
    steps, B, S, nm = 6, 16, 512, 4
    P, L, H = cfg.num_prefix_embeddings, cfg.num_layers, cfg.num_heads
    hd = cfg.resolved_head_dim
    kernels = (FA.flash_attention, FA.flash_attention_bwd_dot,
               FA.flash_attention_bwd_dkdv, FA.flash_attention_bwd_dq)

    def batch_of(c, seq, rows=2, step=0):
        b = SyntheticLM(vocab_size=c.vocab_size, seq_len=seq,
                        global_batch=rows, seed=SEED).batch(step, dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 170 + step)
        b["patches"] = 0.02 * torch.randn((rows, P, c.d_model), generator=g,
                                          device=dev)
        return b

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[vlm-train] device memory allocated before the run: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    model = build_model(cfg)
    opt = AdamW(lr=FULL_WIDTH_LR)
    step = make_train_step(model.loss_fn, opt, num_microbatches=nm,
                           schedule=default_schedule(steps, warmup=1))
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    state = opt.init(params)
    n_params = sum(t.numel() for t in leaves(params))
    # parameters by the positions whose products they take: the patch
    # projection the patches, the tied embedding table (its product the
    # head; its lookup not counted) the text, the rest every position
    n_proj = params["frontend_proj"].numel()
    n_embed = params["embed"]["embed"].numel()
    n_body = n_params - n_proj - n_embed
    mb_logits = 12 * (B // nm) * S * cfg.vocab_size
    acts = 9e9
    print(f"[vlm-train] memory reckoning: {n_params / 1e9:.3f} B params x 16 "
          f"bytes (bf16 weights and gradients, fp32 AdamW moments and "
          f"update) = {16 * n_params / 1e9:.1f} GB; a microbatch's logits "
          f"(12 bytes a logit x {(B // nm) * S} text tokens x "
          f"{cfg.vocab_size}) {mb_logits / 1e9:.1f} GB; activations ~"
          f"{acts / 1e9:.0f} GB: ~{(16 * n_params + mb_logits + acts) / 1e9:.0f}"
          f" GB")
    calls, restore = _plain_counter(ref, ("attention_ref",
                                          "attention_lse_ref",
                                          "attention_bwd_ref"))
    reset(*kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    try:
        for i in range(steps):
            batch = batch_of(cfg, S, B, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(m["loss"].item())          # synchronises
            secs.append(time.perf_counter() - t0)
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {k.__name__: k.launches for k in kernels}
    want = L * nm * steps
    check(all(v == want for v in launched.values()),
          f"vlm trainer: launches {launched}, want {want} each ({L} layers "
          f"x {nm} microbatches x {steps} steps)")
    check(not calls, f"vlm trainer: plain attention on the card's path: "
          f"{sorted(set(calls))}")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"vlm trainer: losses {losses}")
    # model FLOPs a step: 6 N a position for the weights' products, forward
    # and backward (the body over patches and text, the patch projection
    # over the patches, the tied head over the text); attention's QK^T and
    # PV, forward and backward: 12 L H hd a visible (query, key) pair, the
    # 256-position prefix seen whole by every query
    T = P + S
    visible = sum(min(T, max(i + 1, P)) for i in range(T))
    flop = B * (6 * (n_body * T + n_proj * P + n_embed * S)
                + 12 * L * H * hd * visible)
    steady = statistics.median(secs[1:])
    print(f"[vlm-train] {arch} whole ({L} layers, d {cfg.d_model}, {H} heads "
          f"of {hd} over {cfg.num_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, tied embeddings, {n_params / 1e9:.3f} B params,"
          f" bf16), {P} patches (normal x 0.02) + {S} text tokens a row, "
          f"global batch {B} in {nm} microbatches ({B * T} positions, "
          f"{B * S} text tokens a step), AdamW lr {FULL_WIDTH_LR} under "
          f"default_schedule({steps}, warmup=1), {steps} steps of "
          f"make_train_step")
    print(f"[vlm-train] measured peak {peak / 1e9:.2f} GB")
    print(f"[vlm-train] losses {[round(x, 4) for x in losses]}")
    print(f"[vlm-train] step seconds {[round(x, 3) for x in secs]}; median "
          f"of steps 2-{steps} {steady:.3f} s, {B * T / steady:.0f} "
          f"positions/s ({B * S / steady:.0f} text tokens/s); peak memory "
          f"{peak / 1e9:.2f} GB")
    print(f"[vlm-train] model FLOP share: B x (6 (N_body T + N_proj P + "
          f"N_embed S) + 12 L H hd x {visible} visible pairs) = {flop:.4g} "
          f"FLOP a step / {steady:.3f} s / 989 TFLOP/s = "
          f"{flop / steady / BF16_FLOP_PER_S:.1%}")
    print(f"[vlm-train] launches {launched} (= {L} x {nm} x {steps}); plain "
          f"attention calls 0")
    # phase 3's times at this microbatch: kernel 1 with the LSE and 1-bwd
    attn_ms = 0.0
    for name in launched:
        for e in extra_shapes.get(name, []):
            if "hd=256" in e["shape"] and f"Sq=Sk={T}" in e["shape"]:
                e["launches"] = launched[name]
                attn_ms += e["ms"] * launched[name] / steps
    print(f"[vlm-train] kernel 1 and 1-bwd's share of the step: "
          f"{attn_ms:.1f} ms (phase 3's times at this microbatch x launches "
          f"a step) of {steady * 1e3:.1f} ms, {attn_ms / 1e3 / steady:.1%}")
    del params, state, step, model
    gc.collect()
    torch.cuda.empty_cache()
    _grad_checks("vlm-train", dev, cfg, kernels, [2] * 4,
                 lambda c, seq: batch_of(c, seq), GRAD_REL_BOUND,
                 note="frontend_proj")
    print(f"[vlm-train] card: {smi}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import numpy
    import scipy
    import torch.nn.functional as F
    from repro_torch.configs import get_config, llama32_1b, reduced
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention_int8 import (
        decode_attention_int8)
    from repro_torch.kernels.expert_matmul import (
        bwd_smem_bytes as expert_bwd_smem_bytes, expert_matmul,
        expert_matmul_bwd_dw, expert_matmul_bwd_dx,
        smem_bytes as expert_smem_bytes)
    from repro_torch.kernels.flash_attention import (
        bwd_smem_bytes, flash_attention, flash_attention_bwd_dkdv,
        flash_attention_bwd_dot, flash_attention_bwd_dq,
        smem_bytes as flash_smem_bytes)
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_int8,
        plan as decode_plan)
    from repro_torch.kernels.paged_extend_attention import (
        paged_extend_attention, plan as extend_plan)
    from repro_torch.kernels.wkv6 import (
        bwd_blocks_per_sm as wkv6_bwd_blocks_per_sm,
        bwd_smem_bytes as wkv6_bwd_smem_bytes, plan as wkv6_plan, wkv6,
        wkv6_bwd)
    from repro_torch.launch.cosim import run_cosim
    from repro_torch.launch.serve import (demo_requests, full_width_config,
                                          serve_demo)
    from repro_torch.models import layers as Lyr
    from repro_torch.models import moe as MOE
    from repro_torch.models.moe import slice_tokens
    from repro_torch.models import transformer as T
    from repro_torch.models.api import build as build_model
    from repro_torch.serving.engine import (ServingEngine,
                                            insert_cache_pages,
                                            insert_cache_rows)
    kernel_fns = {k.__name__: k for k in (
        flash_attention, decode_attention, decode_attention_int8,
        paged_decode_attention, paged_decode_attention_int8,
        paged_extend_attention, expert_matmul, wkv6,
        flash_attention_bwd_dot, flash_attention_bwd_dkdv,
        flash_attention_bwd_dq, expert_matmul_bwd_dx, expert_matmul_bwd_dw,
        wkv6_bwd)}

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | numpy {numpy.__version__} scipy "
          f"{scipy.__version__} | allow_tf32 matmul=False cudnn=False | "
          f"opt_einsum available "
          f"{torch.backends.opt_einsum.is_available()}")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    logs = build.build(["flash_attention", "decode_attention",
                        "decode_attention_int8", "paged_decode_attention",
                        "paged_extend_attention", "expert_matmul", "wkv6",
                        "flash_attention_bwd", "expert_matmul_bwd",
                        "wkv6_bwd"])
    print(f"[build] {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            spills = "spill" in line and not line.strip().startswith(
                "0 bytes stack frame, 0 bytes spill stores")
            if "Used" in line or spills or "error" in line.lower():
                print(f"  {name}: {line.strip()}")
    # the tensor-core kernels (bf16) beside the FMA ones (fp32): registers,
    # static shared memory and spills of each instantiation from ptxas, the
    # dynamic shared memory its launch asks for from the library
    smem = {"flash_attention": [
                (f"{dt} hd={hd}", flash_smem_bytes(getattr(torch, dt), hd))
                for dt in ("bfloat16", "float32")
                for hd in (64, 112, 128, 256)]
            + [(f"{dt} q/k=192 v=128", flash_smem_bytes(getattr(torch, dt),
                                                        192, 128))
               for dt in ("bfloat16", "float32")],
            "expert_matmul": [
                (f"bfloat16 C{op}16", expert_smem_bytes(torch.bfloat16, c))
                for op, c in (("<=", 16), (">", 17))],
            # kernel 5 at the paged serving table (64 pages of 16; hd 256
            # at paligemma-3b's 8 heads over 1), kernel 7 at rwkv6-1.6b's
            # heads: the launch's cut beside its bytes
            "paged_extend_attention": [
                (f"{dt} hd={hd} C={c}", extend_plan(getattr(torch, dt), hd, c,
                                                    h, kvh, 64, 16))
                for dt in ("bfloat16", "float32") for hd, c, h, kvh in (
                    (64, 1, 32, 8), (64, 64, 32, 8), (64, 256, 32, 8),
                    (128, 64, 32, 8), (256, 1, 8, 1), (256, 64, 8, 1))],
            "wkv6": [(f"{dt} B={b}", wkv6_plan(getattr(torch, dt), 64, b, 32))
                     for dt in ("bfloat16", "float32") for b in (8, 1)],
            # the decode body's cut at the serving capacity (1024 keys: a
            # dense cache of S=1024, a table of 64 pages of 16)
            "decode_attention": [
                (f"{dt} hd={hd} S=1024", decode_plan(getattr(torch, dt), hd,
                                                     32, 8, 1, 1024))
                for dt in ("bfloat16", "float32")
                for hd in (64, 112, 128, 256)],
            "decode_attention_int8": [
                (f"int8 hd={hd} S=1024", decode_plan(torch.int8, hd, 32, 8, 1,
                                                     1024))
                for hd in (64, 112, 128, 256)],
            "paged_decode_attention": [
                (f"{dt} hd={hd} W=64 page=16", decode_plan(
                    getattr(torch, dt), hd, 32, 8, 64, 16))
                for dt in ("bfloat16", "float32", "int8")
                for hd in (64, 128, 256)],
            # dK/dV and dQ share a layout size (at hd 256 the larger of
            # their two layouts); D needs none. The bf16
            # bodies' ptxas count is their launch's (384 threads); after
            # setmaxnreg the two consumer warpgroups hold 232 and the
            # producer's 40
            "flash_attention_bwd": [
                (f"{dt} hd={hd} dK/dV and dQ",
                 bwd_smem_bytes(getattr(torch, dt), hd))
                for dt in ("bfloat16", "float32")
                for hd in (64, 112, 128, 256)],
            # kernel 6's backward: each bf16 body's launch (fp32:
            # static). The wgmma bodies' ptxas count is their launch's
            # (384 threads); after setmaxnreg the two consumer warpgroups
            # hold 224 and the producer's 56
            "expert_matmul_bwd": [
                (f"bfloat16 {body} {what}", expert_bwd_smem_bytes(body, dw))
                for body in ("wgmma", "mma.sync")
                for what, dw in (("dX", False), ("dW", True))],
            # kernel 7-bwd's passes with shared memory (the scan and du
            # passes have none): one layout for bf16 and fp32 (fp32 tiles)
            "wkv6_bwd": [(f"{p} hd={hd}", n) for hd in (64, 16)
                         for p, n in wkv6_bwd_smem_bytes(torch.bfloat16,
                                                         hd).items() if n]}
    # decode_split_fwd's mangled arguments: q type, cache type, hd, paged
    mangled = {"13__nv_bfloat16": "bf16", "f": "fp32", "a": "int8"}

    def decode_args(m):
        hit = re.fullmatch(r"(13__nv_bfloat16|f)(S2_|f|a)Li(\d+)ELb([01])E", m)
        if not hit:
            return m
        q_t, c_t, hd_, paged = hit.groups()
        return (f"{mangled[q_t]}, {mangled.get(c_t, mangled[q_t])}, {hd_}, "
                f"{'paged' if paged == '1' else 'dense'}")

    # kernel 6's backward bodies' mangled arguments end with dW (1) or dX
    def expert_bwd_args(m):
        hit = re.search(r"Lb([01])E$", m)
        return m if not hit else "dW" if hit[1] == "1" else "dX"

    # kernel 1 with its LSE output is the same instantiation (a pointer
    # argument, null when serving): its flash_fwd_mma<64, 64, 1> line is
    # the training forward's
    for name in ("flash_attention", "expert_matmul", "paged_extend_attention",
                 "wkv6", "decode_attention", "decode_attention_int8",
                 "paged_decode_attention", "flash_attention_bwd",
                 "expert_matmul_bwd", "wkv6_bwd"):
        fn, spill = None, ""
        for line in logs.get(name, "").splitlines():
            if "Compiling entry function" in line:   # mangled template
                m = re.search(r"(flash_fwd_mma|flash_fwd|expert_gemm_mma|"
                              r"expert_gemm|paged_extend_fwd_mma|"
                              r"paged_extend_fwd|wkv6_chunked|"
                              r"wkv6_bwd_local|wkv6_bwd_scan|wkv6_bwd_chunk|"
                              r"decode_split_fwd|bwd_dkdv_wgmma|bwd_dq_wgmma|"
                              r"bwd_dkdv_split|"
                              r"bwd_dkdv_fma|bwd_dq_fma|bwd_dot|"
                              r"expert_bwd_wgmma|expert_bwd_mma|"
                              r"expert_bwd_fma)I(.*?)EEv", line)
                fn = (None if not m else f"{m[1]}<{decode_args(m[2])}>"
                      if m[1] == "decode_split_fwd" else
                      f"{m[1]}<{expert_bwd_args(m[2])}>"
                      if m[1].startswith("expert_bwd") else
                      f"{m[1]}<{m[2]}>")
                fn = fn or ("wkv6_bwd_du" if "wkv6_bwd_du" in line
                            else line.split("'")[1])
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line and fn:
                print(f"  [ptxas] {name} {fn}: {line.split(':', 1)[1].strip()}"
                      f"; {spill}")
        print(f"  [smem] {name} dynamic shared memory per launch: " +
              ", ".join(f"{k} {v} B" if isinstance(v, int) else f"{k} {v}"
                        for k, v in smem[name]))

    # kernel 7-bwd's blocks resident on an SM, by pass: its chunk pass is
    # built for two
    occ = {f"{dt} hd={hd}": wkv6_bwd_blocks_per_sm(getattr(torch, dt), hd)
           for dt in ("bfloat16", "float32") for hd in (64, 16)}
    print(f"  [occupancy] wkv6_bwd blocks an SM by pass: {occ}")
    check(all(o["chunk"] >= 2 for o in occ.values()),
          f"wkv6_bwd: its chunk pass holds fewer than two blocks an SM: {occ}")

    # --------------------------------------------------------- 3. kernels
    gen = torch.Generator(device=dev).manual_seed(SEED)
    l2 = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    flush = l2.zero_
    H, KVH, G = 32, 8, 4
    rows = {}

    def rnd(*shape, dtype, g=None):
        return torch.randn(shape, generator=g or gen, device=dev).to(dtype)

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

    # the paged serving shape: 8 rows, a 64-page table (1024 tokens) over
    # a pool of 512 pages + the trash page; row 5's table is all sentinel
    # (a free slot) and rows 3/4 run past the table's width
    P_pool, page, W = 512, 16, 64

    def paged_inputs(dtype, hd, B=8, sentinel=(5,), g=None):
        if dtype == torch.int8:
            kp, ks = Lyr.quantize_kv(rnd(P_pool + 1, page, KVH, hd,
                                         dtype=torch.float32, g=g))
            vp, vs = Lyr.quantize_kv(rnd(P_pool + 1, page, KVH, hd,
                                         dtype=torch.float32, g=g))
        else:
            kp = rnd(P_pool + 1, page, KVH, hd, dtype=dtype, g=g)
            vp = rnd(P_pool + 1, page, KVH, hd, dtype=dtype, g=g)
            ks = vs = None
        perm = torch.randperm(P_pool, generator=g or gen, device=dev)
        table = perm[:B * W].reshape(B, W).to(torch.int32)
        for b in sentinel:
            table[b] = P_pool
        return kp, vp, ks, vs, table

    print("[kernels] decode_attention_int8 vs decode_attention_int8_ref")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for hd in (64, 128):
            q = rnd(8, H, hd, dtype=dt)
            kc, ks = Lyr.quantize_kv(rnd(8, S_dec, KVH, hd,
                                         dtype=torch.float32))
            vc, vs = Lyr.quantize_kv(rnd(8, S_dec, KVH, hd,
                                         dtype=torch.float32))
            kn, vn = rnd(8, KVH, hd, dtype=dt), rnd(8, KVH, hd, dtype=dt)
            lens = torch.cat([lens_main[:-1],
                              torch.zeros(1, dtype=torch.int32, device=dev)])
            compare("decode_attention_int8",
                    decode_attention_int8(q, kc, vc, ks, vs, lens, k_new=kn,
                                          v_new=vn),
                    ref.decode_attention_int8_ref(q, kc, vc, ks, vs, lens,
                                                  kn, vn), dtype,
                    f"{dtype} B=8 S={S_dec} hd={hd} +fresh lengths="
                    f"{lens.tolist()}")

    print("[kernels] paged_decode_attention(_int8) vs "
          "paged_decode_attention_ref")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for hd in (64, 128):
            q = rnd(8, H, hd, dtype=dt)
            kp, vp, _, _, table = paged_inputs(dt, hd)
            for w in (W, 16):
                t = table[:, :w]
                compare("paged_decode_attention",
                        paged_decode_attention(q, kp, vp, t, lens_main),
                        ref.paged_decode_attention_ref(q, kp, vp, t,
                                                       lens_main),
                        dtype, f"{dtype} B=8 W={w} page={page} hd={hd} "
                        f"lengths={lens_main.tolist()} row 5 sentinel")
            kp, vp, ks, vs, table = paged_inputs(torch.int8, hd)
            kn, vn = rnd(8, KVH, hd, dtype=dt), rnd(8, KVH, hd, dtype=dt)
            for fresh in (True, False):
                a, c = (kn, vn) if fresh else (None, None)
                compare("paged_decode_attention_int8",
                        paged_decode_attention_int8(q, kp, vp, ks, vs, table,
                                                    lens_main, k_new=a,
                                                    v_new=c),
                        ref.paged_decode_attention_ref(
                            q, kp, vp, table, lens_main, k_scale=ks,
                            v_scale=vs, k_new=a, v_new=c),
                        dtype, f"{dtype} B=8 W={W} hd={hd} int8 fresh="
                        f"{fresh} row 5 sentinel")

    print("[kernels] paged_extend_attention vs paged_extend_attention_ref")
    pos_ext = torch.tensor([256, 0, 512, 0, 128, 900, 64, 2000],
                           dtype=torch.int32, device=dev)
    # every row near the table's width (1024): the bf16 kernel splits each
    # row's keys over a cluster of blocks at C <= 32. These cases draw from
    # their own generator, so every other input stays as it was before
    # they were added
    gen_full = torch.Generator(device=dev).manual_seed(SEED + 2)
    pos_full = torch.tensor([1024, 1000, 1017, 990, 1024, 1003, 1010, 1021],
                            dtype=torch.int32, device=dev)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for C, hd in ((1, 64), (16, 64), (64, 64), (256, 64), (64, 128)):
            q = rnd(8, C, H, hd, dtype=dt)
            kn, vn = (rnd(8, C, KVH, hd, dtype=dt) for _ in range(2))
            kp, vp, _, _, table = paged_inputs(dt, hd, sentinel=(1, 3))
            compare("paged_extend_attention",
                    paged_extend_attention(q, kp, vp, kn, vn, table, pos_ext),
                    ref.paged_extend_attention_ref(q, kp, vp, kn, vn, table,
                                                   pos_ext),
                    dtype, f"{dtype} B=8 C={C} W={W} hd={hd} pos="
                    f"{pos_ext.tolist()} rows 1,3 sentinel")
            if C in (1, 64):
                qf = rnd(8, C, H, hd, dtype=dt, g=gen_full)
                kf, vf = (rnd(8, C, KVH, hd, dtype=dt, g=gen_full)
                          for _ in range(2))
                compare("paged_extend_attention",
                        paged_extend_attention(qf, kp, vp, kf, vf, table,
                                               pos_full),
                        ref.paged_extend_attention_ref(qf, kp, vp, kf, vf,
                                                       table, pos_full),
                        dtype, f"{dtype} B=8 C={C} W={W} hd={hd} pos="
                        f"{pos_full.tolist()} rows 1,3 sentinel")

    print("[kernels] times (bf16, CUDA events, median of 30, L2 flushed)")
    # what this method reads for a kernel that does nothing: the floor
    # under every time below
    tiny = torch.zeros(1, device=dev)
    print(f"  timing floor (one 1-element zero_ kernel, the same method): "
          f"{time_ms(tiny.zero_, flush):.4f} ms")
    bf = torch.bfloat16
    extra_shapes = {}
    for S, hd in ((5, 64), (16, 64), (300, 64), (512, 64), (512, 128)):
        # hd 128 draws from its own generator: every later input stays as
        # it was before that case was timed
        g = torch.Generator(device=dev).manual_seed(SEED + 1) if hd == 128 \
            else None
        B = 4
        q = rnd(B, S, H, hd, dtype=bf, g=g)
        k = rnd(B, S, KVH, hd, dtype=bf, g=g)
        v = rnd(B, S, KVH, hd, dtype=bf, g=g)
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
              f"({b_by}) -> {b_ms / ms:.1%} of bound, kernel / library "
              f"{ms / lib:.2f}")
        entry = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                     bound_by=b_by, shape=f"bf16 B={B} Sq=Sk={S} H={H} "
                     f"KVH={KVH} hd={hd} causal")
        if (S, hd) == (512, 64):     # llama3.2-1b's largest bucket
            rows["flash_attention"].update(entry)
        elif S == 512:               # phi3.5-moe's heads
            extra_shapes["flash_attention"] = [entry]
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

    # kernels 3 and 4: the decode shape above (4000 live keys), int8 with
    # the fresh token; bytes: each key's K and V rows and scales once
    keys_kv = keys * KVH
    kn, vn = rnd(8, KVH, hd, dtype=bf), rnd(8, KVH, hd, dtype=bf)
    kc8, ks8 = Lyr.quantize_kv(kc)
    vc8, vs8 = Lyr.quantize_kv(vc)
    fresh_bytes = 2 * 2 * kn.numel()
    ms = time_ms(lambda: decode_attention_int8(
        q, kc8, vc8, ks8, vs8, lens_main, k_new=kn, v_new=vn), flush)
    plain = time_ms(lambda: ref.decode_attention_int8_ref(
        q, kc8, vc8, ks8, vs8, lens_main, kn, vn), flush)
    nbytes = 2 * 2 * q.numel() + 2 * keys_kv * (hd + 4) + fresh_bytes + 32
    b_ms, b_by = bound(nbytes, 4.0 * H * hd * (keys + 8), BF16_FLOP_PER_S)
    print(f"  decode_attention_int8 B=8 S={S_dec} hd={hd} ragged +fresh: "
          f"kernel {ms:.4f} ms, plain {plain:.4f}, bound {b_ms:.5f} ({b_by})"
          f" -> {b_ms / ms:.1%} of bound")
    rows["decode_attention_int8"].update(
        ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"bf16 q, int8 cache B=8 S={S_dec} H={H} KVH={KVH} hd={hd} "
        f"lengths={lens_main.tolist()} + fresh token")

    kp, vp, _, _, table = paged_inputs(bf, hd, sentinel=())
    lens_pg = lens_main.clamp(max=W * page)
    ms = time_ms(lambda: paged_decode_attention(q, kp, vp, table, lens_main),
                 flush)
    plain = time_ms(lambda: ref.paged_decode_attention_ref(
        q, kp, vp, table, lens_main), flush)
    keys_pg = int(lens_pg.sum())
    nbytes = (2 * 2 * q.numel() + 2 * 2 * keys_pg * KVH * hd + 4 * 8
              + 4 * table.numel())
    b_ms, b_by = bound(nbytes, 4.0 * H * hd * keys_pg, BF16_FLOP_PER_S)
    print(f"  paged_decode_attention B=8 W={W} page={page} hd={hd}: kernel "
          f"{ms:.4f} ms, plain {plain:.4f}, bound {b_ms:.5f} ({b_by}) -> "
          f"{b_ms / ms:.1%} of bound")
    rows["paged_decode_attention"].update(
        ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"bf16 B=8 W={W} page={page} pool={P_pool}+1 H={H} KVH={KVH} "
        f"hd={hd} lengths={lens_main.tolist()}")
    kp8, vp8, ks8, vs8, table = paged_inputs(torch.int8, hd, sentinel=())
    ms = time_ms(lambda: paged_decode_attention_int8(
        q, kp8, vp8, ks8, vs8, table, lens_main, k_new=kn, v_new=vn), flush)
    plain = time_ms(lambda: ref.paged_decode_attention_ref(
        q, kp8, vp8, table, lens_main, k_scale=ks8, v_scale=vs8, k_new=kn,
        v_new=vn), flush)
    nbytes = (2 * 2 * q.numel() + 2 * keys_pg * KVH * (hd + 4) + fresh_bytes
              + 4 * 8 + 4 * table.numel())
    b_ms, b_by = bound(nbytes, 4.0 * H * hd * (keys_pg + 8), BF16_FLOP_PER_S)
    print(f"  paged_decode_attention_int8 B=8 W={W} hd={hd} +fresh: kernel "
          f"{ms:.4f} ms, plain {plain:.4f}, bound {b_ms:.5f} ({b_by}) -> "
          f"{b_ms / ms:.1%} of bound")
    rows["paged_decode_attention_int8"].update(
        ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"bf16 q, int8 pools B=8 W={W} page={page} H={H} KVH={KVH} "
        f"hd={hd} lengths={lens_main.tolist()} + fresh token")

    # kernels 2 and 4 at three more shapes, each checked against its plain
    # version and timed beside its bound (kernel 2 beside SDPA too): every
    # row at 1024 keys, one 1024-key row alone (a site with one live
    # request), and phi3.5-moe's decode (hd 128). Their own generator, so
    # every other input stays as it was
    g_dec = torch.Generator(device=dev).manual_seed(SEED + 3)
    for label, B, hd_x, lens_x in (
            ("every row at 1024 keys", 8, 64, [S_dec] * 8),
            ("one 1024-key row", 1, 64, [S_dec]),
            ("hd 128", 8, 128, lens_main.tolist())):
        lx = torch.tensor(lens_x, dtype=torch.int32, device=dev)
        qx = rnd(B, H, hd_x, dtype=bf, g=g_dec)
        kx, vx = (rnd(B, S_dec, KVH, hd_x, dtype=bf, g=g_dec)
                  for _ in range(2))
        kpx, vpx = (rnd(P_pool + 1, page, KVH, hd_x, dtype=bf, g=g_dec)
                    for _ in range(2))
        tx = torch.randperm(P_pool, generator=g_dec, device=dev)[
            :B * W].reshape(B, W).to(torch.int32)
        keys_x = int(lx.clamp(max=S_dec).sum())
        case = f"bf16 B={B} hd={hd_x} lengths={lens_x} ({label})"
        compare("decode_attention", decode_attention(qx, kx, vx, lx),
                ref.decode_attention_ref(qx, kx, vx, lx), "bfloat16",
                f"{case}, S={S_dec}")
        compare("paged_decode_attention",
                paged_decode_attention(qx, kpx, vpx, tx, lx),
                ref.paged_decode_attention_ref(qx, kpx, vpx, tx, lx),
                "bfloat16", f"{case}, W={W} page={page}")
        mask_x = (torch.arange(S_dec, device=dev)[None, :]
                  < lx[:, None])[:, None, None, :]
        krx, vrx = (t.repeat_interleave(G, dim=2).transpose(1, 2)
                    for t in (kx, vx))
        flops_x = 4.0 * H * hd_x * keys_x
        for name, fn, plain_fn, lib_fn, nbytes in (
                ("decode_attention",
                 lambda: decode_attention(qx, kx, vx, lx),
                 lambda: ref.decode_attention_ref(qx, kx, vx, lx),
                 lambda: F.scaled_dot_product_attention(
                     qx[:, :, None, :], krx, vrx, attn_mask=mask_x),
                 2 * (2 * qx.numel() + 2 * keys_x * KVH * hd_x) + 4 * B),
                ("paged_decode_attention",
                 lambda: paged_decode_attention(qx, kpx, vpx, tx, lx),
                 lambda: ref.paged_decode_attention_ref(qx, kpx, vpx, tx,
                                                        lx), None,
                 2 * 2 * qx.numel() + 2 * 2 * keys_x * KVH * hd_x + 4 * B
                 + 4 * tx.numel())):
            ms = time_ms(fn, flush)
            plain = time_ms(plain_fn, flush)
            lib = time_ms(lib_fn, flush) if lib_fn else None
            b_ms, b_by = bound(nbytes, flops_x, BF16_FLOP_PER_S)
            lib_txt = f", library {lib:.4f}" if lib else ""
            print(f"  {name} {case}: kernel {ms:.4f} ms, plain {plain:.4f}"
                  f"{lib_txt}, bound {b_ms:.5f} ({b_by}) -> "
                  f"{b_ms / ms:.1%} of bound")
            extra_shapes.setdefault(name, []).append(dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, shape=f"{case}, "
                + (f"S={S_dec}" if name == "decode_attention"
                   else f"W={W} page={page} pool={P_pool}+1")))
        del qx, kx, vx, kpx, vpx, krx, vrx

    # kernel 5 at the tail chunks the serving path runs: 8 rows, half of
    # them masked (pos 0), the others mid-prompt
    pos_tail = torch.tensor([256, 0, 512, 0, 128, 0, 64, 0],
                            dtype=torch.int32, device=dev)
    kp, vp, _, _, table = paged_inputs(bf, hd, sentinel=())
    # the tails, then C = 1 and 64 at a near-full table (other_shapes)
    for pos, C in ([(pos_tail, c) for c in (1, 16, 64, 256)]
                   + [(pos_full, c) for c in (1, 64)]):
        g = gen_full if pos is pos_full else None
        qe = rnd(8, C, H, hd, dtype=bf, g=g)
        kn, vn = (rnd(8, C, KVH, hd, dtype=bf, g=g) for _ in range(2))
        ms = time_ms(lambda: paged_extend_attention(
            qe, kp, vp, kn, vn, table, pos), flush)
        plain = time_ms(lambda: ref.paged_extend_attention_ref(
            qe, kp, vp, kn, vn, table, pos), flush)
        cached = int(pos.clamp(max=W * page).sum())
        nbytes = (2 * 2 * qe.numel() + 2 * 2 * kn.numel()
                  + 2 * 2 * cached * KVH * hd + 4 * 8 + 4 * table.numel())
        flops = 4.0 * H * hd * (C * cached + 8 * C * (C + 1) / 2)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        cut = extend_plan(bf, hd, C, H, KVH, W, page)
        print(f"  paged_extend_attention B=8 C={C} pos={pos.tolist()} "
              f"hd={hd} ({cut['splits']} splits of {cut['split_len']} keys): "
              f"kernel {ms:.4f} ms, plain {plain:.4f}, bound {b_ms:.5f} "
              f"({b_by}) -> {b_ms / ms:.1%} of bound")
        entry = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                     bound_by=b_by, shape=f"bf16 B=8 C={C} W={W} page={page} "
                     f"H={H} KVH={KVH} hd={hd} pos={pos.tolist()}")
        if C == 64 and pos is pos_tail:
            rows["paged_extend_attention"].update(entry)
        else:
            extra_shapes.setdefault("paged_extend_attention",
                                    []).append(entry)
    del q, kc, vc, kr, vr, mask, kp, vp, kp8, vp8, kc8, vc8

    # kernels 1, 2, 4 and 5 at the shapes of the families phase 8 serves,
    # each against its plain version at bf16 and fp32 and timed at bf16
    # beside its bound: qwen3-14b's G = 5 (40 heads over 8 KV heads, hd
    # 128); seamless-m4t-medium's G = 1 at hd 64 (16 heads): its encoder
    # without the causal mask over Se = 160 frames, cross-attention of a
    # 64-token chunk over the 160 encoder keys, and the cross-attention
    # decode with every row at 160 keys; deepseek-7b's G = 1 at hd 128 (32
    # heads). Their own generator, so every other input stays as it was
    g_fam = torch.Generator(device=dev).manual_seed(SEED + 4)
    print("[kernels] the new families' shapes (kernels 1, 2, 4, 5) vs their "
          "plain versions; times at bf16")

    def timed(name, case, fn, plain_fn, lib_fn, nbytes, flops):
        ms = time_ms(fn, flush)
        plain = time_ms(plain_fn, flush)
        lib = time_ms(lib_fn, flush) if lib_fn else None
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        lib_txt = f", library {lib:.4f}" if lib else ""
        print(f"  {name} {case}: kernel {ms:.4f} ms, plain {plain:.4f}"
              f"{lib_txt}, bound {b_ms:.5f} ({b_by}) -> {b_ms / ms:.1%} of "
              f"bound")
        extra_shapes.setdefault(name, []).append(dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
            bound_by=b_by, shape=case))

    def sdpa_kv(t, group):      # [B,S,KVH,hd] -> SDPA's [B,H,S,hd]
        return t.repeat_interleave(group, dim=2).transpose(1, 2)

    for label, B, Sq, Sk, Hx, KVHx, hdx, causal in (
            ("qwen3-14b prefill", 4, 512, 512, 40, 8, 128, True),
            ("seamless encoder", 8, 160, 160, 16, 16, 64, False),
            ("seamless cross-attention chunk", 8, 64, 160, 16, 16, 64,
             False)):
        Gx = Hx // KVHx
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            qx = rnd(B, Sq, Hx, hdx, dtype=dt, g=g_fam)
            kx, vx = (rnd(B, Sk, KVHx, hdx, dtype=dt, g=g_fam)
                      for _ in range(2))
            case = (f"{dtype} B={B} Sq={Sq} Sk={Sk} H={Hx} KVH={KVHx} "
                    f"(G={Gx}) hd={hdx} "
                    f"{'causal' if causal else 'non-causal'} ({label})")
            compare("flash_attention",
                    flash_attention(qx, kx, vx, causal=causal),
                    ref.attention_ref(qx, kx, vx, causal=causal), dtype,
                    case)
            if dt is not bf:
                continue
            pairs = Sq * (Sq + 1) / 2 if causal else Sq * Sk
            krx, vrx = sdpa_kv(kx, Gx), sdpa_kv(vx, Gx)
            qtx = qx.transpose(1, 2)
            timed("flash_attention", case,
                  lambda: flash_attention(qx, kx, vx, causal=causal),
                  lambda: ref.attention_ref(qx, kx, vx, causal=causal),
                  lambda: F.scaled_dot_product_attention(
                      qtx, krx, vrx, is_causal=causal),
                  2 * (2 * qx.numel() + kx.numel() + vx.numel()),
                  4.0 * B * Hx * hdx * pairs)
            del krx, vrx, qtx
        del qx, kx, vx

    lens_cross = torch.full((8,), 160, dtype=torch.int32, device=dev)
    for label, S, Hx, KVHx, hdx, lx in (
            ("seamless cross-attention decode", 160, 16, 16, 64, lens_cross),
            ("qwen3-14b decode", S_dec, 40, 8, 128, lens_main),
            ("deepseek-7b decode", S_dec, 32, 32, 128, lens_main)):
        Gx = Hx // KVHx
        keys_x = int(lx.clamp(max=S).sum())
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            qx = rnd(8, Hx, hdx, dtype=dt, g=g_fam)
            kx, vx = (rnd(8, S, KVHx, hdx, dtype=dt, g=g_fam)
                      for _ in range(2))
            case = (f"{dtype} B=8 S={S} H={Hx} KVH={KVHx} (G={Gx}) hd={hdx} "
                    f"lengths={lx.tolist()} ({label})")
            compare("decode_attention", decode_attention(qx, kx, vx, lx),
                    ref.decode_attention_ref(qx, kx, vx, lx), dtype, case)
            if dt is not bf:
                continue
            mask_x = (torch.arange(S, device=dev)[None, :]
                      < lx[:, None])[:, None, None, :]
            krx, vrx = sdpa_kv(kx, Gx), sdpa_kv(vx, Gx)
            timed("decode_attention", case,
                  lambda: decode_attention(qx, kx, vx, lx),
                  lambda: ref.decode_attention_ref(qx, kx, vx, lx),
                  lambda: F.scaled_dot_product_attention(
                      qx[:, :, None, :], krx, vrx, attn_mask=mask_x),
                  2 * (2 * qx.numel() + 2 * keys_x * KVHx * hdx) + 4 * 8,
                  4.0 * Hx * hdx * keys_x)
            del krx, vrx
        del qx, kx, vx

    # kernels 4 and 5 at the serving table (64 pages of 16 over a pool of
    # 512 + the trash page): decode at the ragged lengths, a 64-token
    # extend chunk at the tails' offsets
    for label, Hx, KVHx, hdx in (("qwen3-14b", 40, 8, 128),
                                 ("deepseek-7b", 32, 32, 128),
                                 ("seamless-m4t-medium", 16, 16, 64)):
        Gx = Hx // KVHx
        keys_pg = int(lens_main.clamp(max=W * page).sum())
        cached = int(pos_tail.clamp(max=W * page).sum())
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            kpx, vpx = (rnd(P_pool + 1, page, KVHx, hdx, dtype=dt, g=g_fam)
                        for _ in range(2))
            tx = torch.randperm(P_pool, generator=g_fam, device=dev)[
                :8 * W].reshape(8, W).to(torch.int32)
            qx = rnd(8, Hx, hdx, dtype=dt, g=g_fam)
            case = (f"{dtype} B=8 W={W} page={page} pool={P_pool}+1 H={Hx} "
                    f"KVH={KVHx} (G={Gx}) hd={hdx}")
            dcase = f"{case} lengths={lens_main.tolist()} ({label} decode)"
            compare("paged_decode_attention",
                    paged_decode_attention(qx, kpx, vpx, tx, lens_main),
                    ref.paged_decode_attention_ref(qx, kpx, vpx, tx,
                                                   lens_main), dtype, dcase)
            qe = rnd(8, 64, Hx, hdx, dtype=dt, g=g_fam)
            kn, vn = (rnd(8, 64, KVHx, hdx, dtype=dt, g=g_fam)
                      for _ in range(2))
            ecase = f"{case} C=64 pos={pos_tail.tolist()} ({label} extend)"
            compare("paged_extend_attention",
                    paged_extend_attention(qe, kpx, vpx, kn, vn, tx,
                                           pos_tail),
                    ref.paged_extend_attention_ref(qe, kpx, vpx, kn, vn, tx,
                                                   pos_tail), dtype, ecase)
            if dt is bf:
                timed("paged_decode_attention", dcase,
                      lambda: paged_decode_attention(qx, kpx, vpx, tx,
                                                     lens_main),
                      lambda: ref.paged_decode_attention_ref(
                          qx, kpx, vpx, tx, lens_main), None,
                      2 * 2 * qx.numel() + 2 * 2 * keys_pg * KVHx * hdx
                      + 4 * 8 + 4 * tx.numel(), 4.0 * Hx * hdx * keys_pg)
                timed("paged_extend_attention", ecase,
                      lambda: paged_extend_attention(qe, kpx, vpx, kn, vn,
                                                     tx, pos_tail),
                      lambda: ref.paged_extend_attention_ref(
                          qe, kpx, vpx, kn, vn, tx, pos_tail), None,
                      2 * 2 * qe.numel() + 2 * 2 * kn.numel()
                      + 2 * 2 * cached * KVHx * hdx + 4 * 8
                      + 4 * tx.numel(),
                      4.0 * Hx * hdx * (64 * cached + 8 * 64 * 65 / 2))
            del kpx, vpx, qx, qe, kn, vn
    torch.cuda.empty_cache()

    # kernels 1-5 at paligemma-3b's serving shapes (phase 9): hd 256, 8
    # query heads over one KV head (G = 8); kernel 1 with the 256 patch
    # positions as its bidirectional prefix before a 256- or 512-token
    # bucket; kernels 2, 3, 4 and 4-int8 at the decode shapes above (row 5
    # of the paged table all sentinel, lengths past the table), the int8
    # ones with the fresh token; kernel 5 a 1-, 16- and 64-token chunk
    # behind the prefix (the masked rows at pos 0). Each against its plain
    # version at bf16 and fp32, timed at bf16 (kernels 1 and 2 beside
    # SDPA). Their own generator, so every other input stays as it was
    g_vlm = torch.Generator(device=dev).manual_seed(SEED + 5)
    Hv, KVHv, hdv, Pv = 8, 1, 256, 256
    print("[kernels] paligemma-3b's shapes (hd 256, G = 8 over one KV "
          "head; kernels 1-5) vs their plain versions; times at bf16")
    for B, S in ((4, Pv + 256), (1, Pv + 512)):
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            qx = rnd(B, S, Hv, hdv, dtype=dt, g=g_vlm)
            kx, vx = (rnd(B, S, KVHv, hdv, dtype=dt, g=g_vlm)
                      for _ in range(2))
            case = (f"{dtype} B={B} Sq=Sk={S} H={Hv} KVH={KVHv} (G=8) "
                    f"hd={hdv} causal prefix={Pv} (paligemma-3b prefill)")
            compare("flash_attention",
                    flash_attention(qx, kx, vx, prefix_len=Pv),
                    ref.attention_ref(qx, kx, vx, prefix_len=Pv), dtype,
                    case)
            if dt is bf and B == 4:
                ar = torch.arange(S, device=dev)
                pmask = (ar[:, None] >= ar[None, :]) | (ar[None, :] < Pv)
                krx, vrx = sdpa_kv(kx, Hv // KVHv), sdpa_kv(vx, Hv // KVHv)
                qtx = qx.transpose(1, 2)
                timed("flash_attention", case,
                      lambda: flash_attention(qx, kx, vx, prefix_len=Pv),
                      lambda: ref.attention_ref(qx, kx, vx, prefix_len=Pv),
                      lambda: F.scaled_dot_product_attention(
                          qtx, krx, vrx, attn_mask=pmask),
                      2 * (2 * qx.numel() + kx.numel() + vx.numel()),
                      4.0 * B * Hv * hdv * sum(max(i + 1, Pv)
                                               for i in range(S)))
                del krx, vrx, qtx
            del qx, kx, vx
    keys_v = int(lens_main.clamp(max=S_dec).sum())
    keys_pv = int(lens_main.clamp(max=W * page).sum())
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        qx = rnd(8, Hv, hdv, dtype=dt, g=g_vlm)
        kx, vx = (rnd(8, S_dec, KVHv, hdv, dtype=dt, g=g_vlm)
                  for _ in range(2))
        kn, vn = (rnd(8, KVHv, hdv, dtype=dt, g=g_vlm) for _ in range(2))
        kq, ksq = Lyr.quantize_kv(kx.float())
        vq, vsq = Lyr.quantize_kv(vx.float())
        kpx, vpx = (rnd(P_pool + 1, page, KVHv, hdv, dtype=dt, g=g_vlm)
                    for _ in range(2))
        kp8, ks8 = Lyr.quantize_kv(kpx.float())
        vp8, vs8 = Lyr.quantize_kv(vpx.float())
        tx = torch.randperm(P_pool, generator=g_vlm, device=dev)[
            :8 * W].reshape(8, W).to(torch.int32)
        ts = tx.clone()
        ts[5] = P_pool                      # a free slot's row
        case = (f"{dtype} B=8 H={Hv} KVH={KVHv} (G=8) hd={hdv} lengths="
                f"{lens_main.tolist()}")
        dcase, pcase = (f"{case} S={S_dec} (paligemma-3b decode)",
                        f"{case} W={W} page={page} pool={P_pool}+1 "
                        f"(paligemma-3b paged decode)")
        compare("decode_attention", decode_attention(qx, kx, vx, lens_main),
                ref.decode_attention_ref(qx, kx, vx, lens_main), dtype,
                dcase)
        compare("decode_attention_int8",
                decode_attention_int8(qx, kq, vq, ksq, vsq, lens_main,
                                      k_new=kn, v_new=vn),
                ref.decode_attention_int8_ref(qx, kq, vq, ksq, vsq,
                                              lens_main, kn, vn), dtype,
                f"{dcase} int8 +fresh")
        compare("paged_decode_attention",
                paged_decode_attention(qx, kpx, vpx, ts, lens_main),
                ref.paged_decode_attention_ref(qx, kpx, vpx, ts, lens_main),
                dtype, f"{pcase} row 5 sentinel")
        compare("paged_decode_attention_int8",
                paged_decode_attention_int8(qx, kp8, vp8, ks8, vs8, ts,
                                            lens_main, k_new=kn, v_new=vn),
                ref.paged_decode_attention_ref(
                    qx, kp8, vp8, ts, lens_main, k_scale=ks8, v_scale=vs8,
                    k_new=kn, v_new=vn),
                dtype, f"{pcase} int8 +fresh row 5 sentinel")
        pos_v = torch.tensor([Pv + 256, 0, Pv + 512, 0, Pv + 128, 0,
                              Pv + 64, 0], dtype=torch.int32, device=dev)
        cached_v = int(pos_v.clamp(max=W * page).sum())
        ext = []
        for C in (1, 16, 64):
            qe = rnd(8, C, Hv, hdv, dtype=dt, g=g_vlm)
            ke, ve = (rnd(8, C, KVHv, hdv, dtype=dt, g=g_vlm)
                      for _ in range(2))
            ecase = (f"{dtype} B=8 C={C} W={W} page={page} H={Hv} "
                     f"KVH={KVHv} (G=8) hd={hdv} pos={pos_v.tolist()} "
                     f"(paligemma-3b extend)")
            compare("paged_extend_attention",
                    paged_extend_attention(qe, kpx, vpx, ke, ve, tx, pos_v),
                    ref.paged_extend_attention_ref(qe, kpx, vpx, ke, ve, tx,
                                                   pos_v), dtype, ecase)
            ext.append((C, ecase, qe, ke, ve))
        if dt is not bf:
            continue
        mask_v = (torch.arange(S_dec, device=dev)[None, :]
                  < lens_main[:, None])[:, None, None, :]
        krx, vrx = sdpa_kv(kx, Hv // KVHv), sdpa_kv(vx, Hv // KVHv)
        flops_v = 4.0 * Hv * hdv * keys_v
        timed("decode_attention", dcase,
              lambda: decode_attention(qx, kx, vx, lens_main),
              lambda: ref.decode_attention_ref(qx, kx, vx, lens_main),
              lambda: F.scaled_dot_product_attention(
                  qx[:, :, None, :], krx, vrx, attn_mask=mask_v),
              2 * (2 * qx.numel() + 2 * keys_v * KVHv * hdv) + 4 * 8,
              flops_v)
        fresh = 2 * 2 * kn.numel()
        timed("decode_attention_int8", f"{dcase} int8 +fresh",
              lambda: decode_attention_int8(qx, kq, vq, ksq, vsq, lens_main,
                                            k_new=kn, v_new=vn),
              lambda: ref.decode_attention_int8_ref(qx, kq, vq, ksq, vsq,
                                                    lens_main, kn, vn), None,
              2 * 2 * qx.numel() + 2 * keys_v * KVHv * (hdv + 4) + fresh
              + 4 * 8, 4.0 * Hv * hdv * (keys_v + 8))
        timed("paged_decode_attention", pcase,
              lambda: paged_decode_attention(qx, kpx, vpx, tx, lens_main),
              lambda: ref.paged_decode_attention_ref(qx, kpx, vpx, tx,
                                                     lens_main), None,
              2 * 2 * qx.numel() + 2 * 2 * keys_pv * KVHv * hdv + 4 * 8
              + 4 * tx.numel(), 4.0 * Hv * hdv * keys_pv)
        timed("paged_decode_attention_int8", f"{pcase} int8 +fresh",
              lambda: paged_decode_attention_int8(
                  qx, kp8, vp8, ks8, vs8, tx, lens_main, k_new=kn, v_new=vn),
              lambda: ref.paged_decode_attention_ref(
                  qx, kp8, vp8, tx, lens_main, k_scale=ks8, v_scale=vs8,
                  k_new=kn, v_new=vn), None,
              2 * 2 * qx.numel() + 2 * keys_pv * KVHv * (hdv + 4) + fresh
              + 4 * 8 + 4 * tx.numel(), 4.0 * Hv * hdv * (keys_pv + 8))
        for C, ecase, qe, ke, ve in ext:
            cut = extend_plan(bf, hdv, C, Hv, KVHv, W, page)
            timed("paged_extend_attention",
                  f"{ecase} ({cut['splits']} splits of {cut['split_len']} "
                  f"keys)",
                  lambda: paged_extend_attention(qe, kpx, vpx, ke, ve, tx,
                                                 pos_v),
                  lambda: ref.paged_extend_attention_ref(
                      qe, kpx, vpx, ke, ve, tx, pos_v), None,
                  2 * 2 * qe.numel() + 2 * 2 * ke.numel()
                  + 2 * 2 * cached_v * KVHv * hdv + 4 * 8 + 4 * tx.numel(),
                  4.0 * Hv * hdv * (C * cached_v + 8 * C * (C + 1) / 2))
        del krx, vrx
    del qx, kx, vx, kq, vq, kpx, vpx, kp8, vp8, ext, qe, ke, ve
    torch.cuda.empty_cache()

    # kernel 1 at deepseek-v2's expanded MLA prefill: q/k 192 over v 128,
    # 128 heads over 128 (G = 1), causal, against its plain version at
    # bf16 and fp32 and timed at bf16; the library call is SDPA where this
    # installation's takes a v width other than q's. Its own generator, so
    # every other input stays as it was
    g_mla = torch.Generator(device=dev).manual_seed(SEED + 6)
    Bm, Sm, Hm = 4, 512, 128
    print("[kernels] deepseek-v2's MLA prefill (kernel 1 at q/k 192 over v "
          "128, G = 1) vs its plain version; times at bf16")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        qx, kx = (rnd(Bm, Sm, Hm, 192, dtype=dt, g=g_mla) for _ in range(2))
        vx = rnd(Bm, Sm, Hm, 128, dtype=dt, g=g_mla)
        case = (f"{dtype} B={Bm} Sq=Sk={Sm} H=KVH={Hm} (G=1) q/k 192 v 128 "
                f"causal (deepseek-v2-236b prefill)")
        compare("flash_attention", flash_attention(qx, kx, vx),
                ref.attention_ref(qx, kx, vx), dtype, case)
        if dt is bf:
            qtx, ktx, vtx = (t.transpose(1, 2) for t in (qx, kx, vx))
            try:            # probing the yardstick, not the port
                F.scaled_dot_product_attention(qtx, ktx, vtx, is_causal=True)
                lib_fn = lambda: F.scaled_dot_product_attention(
                    qtx, ktx, vtx, is_causal=True)
            except RuntimeError as e:
                lib_fn = None
                print(f"  library: none, scaled_dot_product_attention "
                      f"refuses v 128 under q/k 192 here: {e}")
            timed("flash_attention", case,
                  lambda: flash_attention(qx, kx, vx),
                  lambda: ref.attention_ref(qx, kx, vx), lib_fn,
                  2 * Bm * Sm * Hm * (192 + 192 + 128 + 128),
                  2.0 * (192 + 128) * Bm * Hm * Sm * (Sm + 1) / 2)
            mla_flash_entry = extra_shapes["flash_attention"][-1]
            del qtx, ktx, vtx
        del qx, kx, vx
    torch.cuda.empty_cache()

    # kernels 1, 2 and 3 at zamba2-7b's shared attention: hd 112, 32 heads
    # over 32 (G = 1); kernel 1 causal at B=4 Sq=Sk=512, kernels 2 and 3 at
    # the decode shape above (B=8, S=1024, the ragged lengths; kernel 3
    # with the fresh token). Each against its plain version at bf16 and
    # fp32, timed at bf16 (kernels 1 and 2 beside SDPA). Their own
    # generator, so every other input stays as it was
    g_zam = torch.Generator(device=dev).manual_seed(SEED + 7)
    Bz, Sz, Hz, hdz = 4, 512, 32, 112
    zamba_entries = {}
    print("[kernels] zamba2-7b's shapes (kernels 1, 2, 3 at hd 112, G = 1) "
          "vs their plain versions; times at bf16")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        qx, kx, vx = (rnd(Bz, Sz, Hz, hdz, dtype=dt, g=g_zam)
                      for _ in range(3))
        case = (f"{dtype} B={Bz} Sq=Sk={Sz} H=KVH={Hz} (G=1) hd={hdz} "
                f"causal (zamba2-7b prefill)")
        compare("flash_attention", flash_attention(qx, kx, vx),
                ref.attention_ref(qx, kx, vx), dtype, case)
        if dt is bf:
            qtx, ktx, vtx = (t.transpose(1, 2) for t in (qx, kx, vx))
            timed("flash_attention", case,
                  lambda: flash_attention(qx, kx, vx),
                  lambda: ref.attention_ref(qx, kx, vx),
                  lambda: F.scaled_dot_product_attention(
                      qtx, ktx, vtx, is_causal=True),
                  2 * (2 * qx.numel() + kx.numel() + vx.numel()),
                  4.0 * Bz * Hz * hdz * Sz * (Sz + 1) / 2)
            zamba_entries["flash_attention"] = \
                extra_shapes["flash_attention"][-1]
            del qtx, ktx, vtx
        del qx, kx, vx
    keys_z = int(lens_main.clamp(max=S_dec).sum())
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        qx = rnd(8, Hz, hdz, dtype=dt, g=g_zam)
        kx, vx = (rnd(8, S_dec, Hz, hdz, dtype=dt, g=g_zam)
                  for _ in range(2))
        kn, vn = (rnd(8, Hz, hdz, dtype=dt, g=g_zam) for _ in range(2))
        kq, ksq = Lyr.quantize_kv(kx.float())
        vq, vsq = Lyr.quantize_kv(vx.float())
        dcase = (f"{dtype} B=8 S={S_dec} H=KVH={Hz} (G=1) hd={hdz} "
                 f"lengths={lens_main.tolist()} (zamba2-7b decode)")
        compare("decode_attention", decode_attention(qx, kx, vx, lens_main),
                ref.decode_attention_ref(qx, kx, vx, lens_main), dtype,
                dcase)
        compare("decode_attention_int8",
                decode_attention_int8(qx, kq, vq, ksq, vsq, lens_main,
                                      k_new=kn, v_new=vn),
                ref.decode_attention_int8_ref(qx, kq, vq, ksq, vsq,
                                              lens_main, kn, vn), dtype,
                f"{dcase} int8 +fresh")
        if dt is bf:
            mask_z = (torch.arange(S_dec, device=dev)[None, :]
                      < lens_main[:, None])[:, None, None, :]
            ktx, vtx = kx.transpose(1, 2), vx.transpose(1, 2)
            timed("decode_attention", dcase,
                  lambda: decode_attention(qx, kx, vx, lens_main),
                  lambda: ref.decode_attention_ref(qx, kx, vx, lens_main),
                  lambda: F.scaled_dot_product_attention(
                      qx[:, :, None, :], ktx, vtx, attn_mask=mask_z),
                  2 * (2 * qx.numel() + 2 * keys_z * Hz * hdz) + 4 * 8,
                  4.0 * Hz * hdz * keys_z)
            zamba_entries["decode_attention"] = \
                extra_shapes["decode_attention"][-1]
            timed("decode_attention_int8", f"{dcase} int8 +fresh",
                  lambda: decode_attention_int8(qx, kq, vq, ksq, vsq,
                                                lens_main, k_new=kn,
                                                v_new=vn),
                  lambda: ref.decode_attention_int8_ref(
                      qx, kq, vq, ksq, vsq, lens_main, kn, vn), None,
                  2 * 2 * qx.numel() + 2 * keys_z * Hz * (hdz + 4)
                  + 2 * 2 * kn.numel() + 4 * 8, 4.0 * Hz * hdz * (keys_z + 8))
            zamba_entries["decode_attention_int8"] = \
                extra_shapes["decode_attention_int8"][-1]
            del ktx, vtx
        del qx, kx, vx, kq, vq, kn, vn
    torch.cuda.empty_cache()

    # kernel 6 at phi3.5-moe's shapes: 16 experts, D 4096, F 6400 (gate/up;
    # down swaps them), C = T tokens with fill from a seeded top-2 routing
    E6, D6, F6 = 16, 4096, 6400

    def routed_fill(T):
        idx = torch.topk(torch.rand((T, E6), generator=gen, device=dev), 2,
                         dim=-1).indices
        return torch.bincount(idx.reshape(-1), minlength=E6).to(torch.int32)

    print("[kernels] expert_matmul vs expert_matmul_ref")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for E, C, D, F_, fill in [
                (E6, 8, D6, F6, routed_fill(8)),
                (E6, 8, F6, D6, routed_fill(8)),
                (E6, 2048, D6, F6, routed_fill(2048)),
                (4, 200, D6, 640, torch.tensor([0, 77, 200, 64],
                                               dtype=torch.int32,
                                               device=dev))]:
            xe = rnd(E, C, D, dtype=dt)
            w = (rnd(E, D, F_, dtype=torch.float32) / D ** 0.5).to(dt)
            got = expert_matmul(xe, w, fill)
            rows_past = (torch.arange(C, device=dev)[None, :]
                         >= fill[:, None])
            check(not got[rows_past].any(), f"expert_matmul E={E} C={C}: "
                  "rows past fill are not zero")
            compare("expert_matmul", got, ref.expert_matmul_ref(xe, w, fill),
                    dtype, f"{dtype} E={E} C={C} D={D} F={F_} fill="
                    f"{fill.tolist()}")
            del xe, w, got

    # kernel 7 at rwkv6-1.6b's heads (H 32, hd 64): the serving shape, a
    # ragged S, and the decay clamp over 64 tokens; a chained state
    def wkv_inputs(B, S, dt, logw=None, g=None):
        r, k, v = (0.5 * rnd(B, S, 32, 64, dtype=torch.float32, g=g)
                   for _ in range(3))
        w = (-1.5 * torch.rand((B, S, 32, 64), generator=g or gen, device=dev)
             if logw is None else torch.full((B, S, 32, 64), logw,
                                             device=dev))
        return (r.to(dt), k.to(dt), v.to(dt), w,
                0.3 * rnd(32, 64, dtype=torch.float32, g=g),
                0.1 * rnd(B, 32, 64, 64, dtype=torch.float32, g=g))

    print("[kernels] wkv6 vs wkv6_chunked_ref and wkv6_ref (outputs fp32)")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for B, S, logw in ((8, 512, None), (1, 512, None), (2, 100, None),
                           (1, 64, -1.5)):
            # B=1 draws from its own generator (see pos_full above)
            a = wkv_inputs(B, S, dt, logw, g=gen_full if B == 1 and S == 512
                           else None)
            o, st = wkv6(*a)
            for plain in (ref.wkv6_chunked_ref, ref.wkv6_ref):
                po, ps = plain(*a)
                case = (f"{dtype} inputs B={B} S={S} H=32 hd=64 logw="
                        f"{logw or 'U(-1.5, 0)'} vs {plain.__name__}")
                compare("wkv6", o, po, "float32", case + " out")
                compare("wkv6", st, ps, "float32", case + " state")
            h = S // 2 + 3
            o1, s1 = wkv6(*(t[:, :h].contiguous() for t in a[:4]), a[4], a[5])
            o2, s2 = wkv6(*(t[:, h:].contiguous() for t in a[:4]), a[4], s1)
            compare("wkv6", torch.cat([o1, o2], 1), o, "float32",
                    f"{dtype} B={B} S={h}+{S - h} chained vs one call out")
            compare("wkv6", s2, st, "float32",
                    f"{dtype} B={B} S={h}+{S - h} chained vs one call state")

    print("[kernels] times of kernels 6 and 7 (bf16, CUDA events, median of "
          "30, L2 flushed)")
    for ntok in (8, 2048):
        fill = routed_fill(ntok)
        xe = rnd(E6, ntok, D6, dtype=bf)
        w = (rnd(E6, D6, F6, dtype=torch.float32) / D6 ** 0.5).to(bf)
        ms = time_ms(lambda: expert_matmul(xe, w, fill), flush)
        plain = time_ms(lambda: ref.expert_matmul_ref(xe, w, fill), flush)
        lib = time_ms(lambda: torch.bmm(xe, w), flush)
        live_rows, live_e = int(fill.sum()), int((fill > 0).sum())
        nbytes = 2 * (live_rows * D6 + live_e * D6 * F6 + E6 * ntok * F6) + 4 * E6
        b_ms, b_by = bound(nbytes, 2.0 * live_rows * D6 * F6, BF16_FLOP_PER_S)
        shape = (f"bf16 E={E6} C=T={ntok} D={D6} F={F6} top-2 fill "
                 f"{fill.tolist()} ({live_e} live experts)")
        print(f"  expert_matmul T={ntok}: kernel {ms:.4f} ms, plain {plain:.4f}, "
              f"library (bmm, every row) {lib:.4f}, bound {b_ms:.5f} "
              f"({b_by}) -> {b_ms / ms:.1%} of bound, kernel / library "
              f"{ms / lib:.2f}")
        entry = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                     bound_by=b_by, shape=shape)
        if ntok == 8:      # the decode shape: most launches on the path
            rows["expert_matmul"].update(entry)
        else:
            extra_shapes["expert_matmul"] = [entry]
        del xe, w
    # kernel 6 at deepseek-v2's experts: E 160, D 5120, F 1536, top-6
    # fills from a seeded routing at a decode's 8 tokens and at one prefill
    # slice (moe.slice_tokens), gate/up and the down GEMM (D and F
    # swapped) of each; against the plain version at bf16 and fp32, timed
    # at bf16 beside torch.bmm over every row
    E10, D10, F10 = 160, 5120, 1536
    Tc10 = slice_tokens(E10, D10, bf)

    def routed_fill6(T):
        idx = torch.topk(torch.rand((T, E10), generator=g_mla, device=dev),
                         6, dim=-1).indices
        return torch.bincount(idx.reshape(-1), minlength=E10).to(torch.int32)

    print(f"[kernels] expert_matmul at deepseek-v2's 160 experts, top-6 "
          f"(T=8 and a prefill slice of T={Tc10})")
    mla_expert_entries = []
    for ntok in (8, Tc10):
        fill = routed_fill6(ntok)
        live_rows, live_e = int(fill.sum()), int((fill > 0).sum())
        for D_, F_ in ((D10, F10), (F10, D10)):
            for dtype in ("bfloat16", "float32"):
                dt = getattr(torch, dtype)
                xe = rnd(E10, ntok, D_, dtype=dt, g=g_mla)
                w = (rnd(E10, D_, F_, dtype=torch.float32, g=g_mla)
                     / D_ ** 0.5).to(dt)
                case = (f"{dtype} E={E10} C=T={ntok} D={D_} F={F_} top-6 "
                        f"({live_e} live experts, {live_rows} rows, at most "
                        f"{int(fill.max())} an expert)")
                got = expert_matmul(xe, w, fill)
                rows_past = (torch.arange(ntok, device=dev)[None, :]
                             >= fill[:, None])
                check(not got[rows_past].any(), f"expert_matmul {case}: "
                      "rows past fill are not zero")
                compare("expert_matmul", got,
                        ref.expert_matmul_ref(xe, w, fill), dtype, case)
                if dt is bf:
                    timed("expert_matmul", case,
                          lambda: expert_matmul(xe, w, fill),
                          lambda: ref.expert_matmul_ref(xe, w, fill),
                          lambda: torch.bmm(xe, w),
                          2 * (live_rows * D_ + live_e * D_ * F_
                               + E10 * ntok * F_) + 4 * E10,
                          2.0 * live_rows * D_ * F_)
                    mla_expert_entries.append(extra_shapes["expert_matmul"][-1])
                del xe, w, got
    torch.cuda.empty_cache()

    # the serving shape, a short segment, and one long prompt admitted
    # alone (B=1: the value columns split over 8 blocks a head). Kernel 6's
    # timings above hold the card at its power limit and pull the SM clock
    # down (1380 MHz against 1980 idle on a 700 W H100): idle first, so
    # that kernel 7 is timed at the clock the serving path gives it
    print(f"  after kernel 6: {clocks()}")
    time.sleep(2.0)
    print(f"  after 2 s idle: {clocks()}")
    for B, S in ((8, 512), (8, 64), (1, 512)):
        a = wkv_inputs(B, S, bf, g=gen_full if B == 1 else None)
        ms = time_ms(lambda: wkv6(*a), flush)
        plain = time_ms(lambda: ref.wkv6_chunked_ref(*a), flush)
        n = B * S * 32 * 64
        nbytes = 3 * 2 * n + 2 * 4 * n + 4 * 32 * 64 + 2 * 4 * B * 32 * 64 * 64
        b_ms, b_by = bound(nbytes, 4.0 * 64 * n, BF16_FLOP_PER_S)
        shape = f"bf16 r/k/v, fp32 logw B={B} S={S} H=32 hd=64"
        print(f"  wkv6 B={B} S={S} ({wkv6_plan(bf, 64, B, 32)['slices']} "
              f"blocks a head): kernel {ms:.4f} ms, plain (chunked) "
              f"{plain:.4f}, bound {b_ms:.5f} ({b_by}) -> {b_ms / ms:.1%} of "
              f"bound")
        entry = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                     bound_by=b_by, shape=shape)
        if (B, S) == (8, 512):
            rows["wkv6"].update(entry)
        else:
            extra_shapes.setdefault("wkv6", []).append(entry)
        del a
    torch.cuda.empty_cache()
    backward_kernels(dev, flush, compare, rows, extra_shapes)
    expert_backward_kernels(dev, flush, compare, rows, extra_shapes)
    wkv6_backward_kernels(dev, flush, rows, extra_shapes)
    del l2
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 4. serve
    cfg = llama32_1b
    L = cfg.num_layers
    # uniform site weights, not Heron's: the same traffic as every earlier
    # run of these phases
    serve_kw = dict(num_requests=16, num_sites=2, seed=SEED,
                    site_weights=(1.0, 1.0),
                    prompt_len=(16, 701), new_tokens=(8, 33))
    torch.cuda.reset_peak_memory_stats(dev)
    reset(*kernel_fns.values())
    out = serve_demo(cfg, max_batch=8, max_seq=1024, device="cuda",
                     **serve_kw)
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    others = {k: f.launches for k, f in kernel_fns.items()
              if k not in launches and f.launches}
    check(not others, f"the dense path launched other kernels: {others}")
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

    # ----------------------------------------------------- 4b. paged serve
    # the default pool (dense capacity, 512 pages of 16 tokens per site)
    # and 224 pages (7/16 of it): site 0's first eight requests need 241
    # pages, so its admission waits for pages to come back
    paged_runs = {}
    for num_pages in (None, 224):
        reset(*kernel_fns.values())
        pout = serve_demo(cfg, max_batch=8, max_seq=1024, device="cuda",
                          paged=True, num_pages=num_pages, **serve_kw)
        plaunch = {k: f.launches for k, f in kernel_fns.items()}
        psites = pout["per_site"]
        tag = f"num_pages={num_pages or 'default'}"
        check(pout["completed"] == pout["submitted"] == 16,
              f"paged {tag}: served {pout['completed']}/{pout['submitted']}")
        check(pout["free_pages"] == pout["num_pages"],
              f"paged {tag}: pages not returned: free {pout['free_pages']} "
              f"of {pout['num_pages']}")
        p_decode = sum(s["decode_steps"] for s in psites)
        p_extend = sum(s["extend_chunks"] for s in psites)
        p_prefill = sum(s["prefill_calls"] - s["extend_chunks"]
                        for s in psites)
        check(plaunch["paged_decode_attention"] == L * p_decode > 0,
              f"paged {tag}: kernel 4 launches "
              f"{plaunch['paged_decode_attention']} != {L} x {p_decode}")
        check(plaunch["paged_extend_attention"] == L * p_extend > 0,
              f"paged {tag}: kernel 5 launches "
              f"{plaunch['paged_extend_attention']} != {L} x {p_extend}")
        check(plaunch["flash_attention"] == L * p_prefill,
              f"paged {tag}: flash launches {plaunch['flash_attention']} != "
              f"{L} x {p_prefill}")
        check(plaunch["decode_attention"] == 0,
              f"paged {tag}: the dense decode kernel ran")
        waits = [s["page_waits"] for s in psites]
        if num_pages is not None:
            check(any(waits), f"paged {tag}: admission never waited")
        served_p = sum(s["served_tokens"] for s in psites)
        check(served_p == served, f"paged {tag}: served {served_p} tokens")
        paged_runs[tag] = plaunch
        if num_pages is None:
            paged_tokens = pout["tokens"]
        print(f"[paged] {tag}: 16/16 requests, {served_p} tokens in "
              f"{pout['wall_seconds']:.3f} s "
              f"({served_p / pout['wall_seconds']:.1f} tok/s), pages free "
              f"after {pout['free_pages']} of {pout['num_pages']}, "
              f"admission waits for pages {waits}")
        for i, s in enumerate(psites):
            print(f"  site {i}: prefill calls "
                  f"{s['prefill_calls'] - s['extend_chunks']}, extend chunks "
                  f"{s['extend_chunks']}, decode steps {s['decode_steps']}, "
                  f"TTFT mean {s['mean_ttft'] * 1e3:.1f} / p99 "
                  f"{s['p99_ttft'] * 1e3:.1f} ms, TBT mean "
                  f"{s['mean_tbt'] * 1e3:.2f} / p99 "
                  f"{s['p99_tbt'] * 1e3:.2f} ms")
        print(f"  launches: {plaunch}")

    def paged_first_logits(model, prompt):
        """Request 0's admission on a paged cache: bucket prefill, then
        descending power-of-2 extend chunks, as the engine runs it."""
        S = prompt.shape[1]
        bucket = 1 << (S.bit_length() - 1)
        logits, pre = model.prefill_fn(params, {"tokens": prompt[:, :bucket]})
        cache = T.make_paged_decode_cache(cfg, 1, 1024, dev, num_pages=64)
        cache["table"] = torch.randperm(64, generator=gen, device=dev)[
            None].to(torch.int32)
        insert_cache_pages(cache["kv"], pre["kv"],
                           cache["table"][:, :-(-bucket // 16)].long())
        cache["pos"] = pre["pos"].clone()
        done = bucket
        while done < S:
            C = 1 << ((S - done).bit_length() - 1)
            logits, cache = model.extend_fn(
                params, {"tokens": prompt[:, done:done + C]}, cache)
            done += C
        return logits

    with torch.no_grad():
        got = paged_first_logits(build_model(cfg), prompt)
        want = paged_first_logits(build_model(cfg, reference=True), prompt)
    torch.cuda.synchronize()
    check(got.shape == (1, cfg.vocab_size) and bool(torch.isfinite(got).all()),
          f"paged logits shape {tuple(got.shape)} or non-finite")
    lerr_p = (got.float() - want.float()).abs().max().item()
    check(lerr_p <= LOGIT_BOUND,
          f"paged logits differ by {lerr_p:.3g} > {LOGIT_BOUND}")
    print(f"[paged] request 0 first-token logits through paged extends, "
          f"kernel path vs plain path: max |diff| {lerr_p:.4g} (bound "
          f"{LOGIT_BOUND}), argmax {int(got.argmax())} vs "
          f"{int(want.argmax())}")

    # reduced depth, full width, fp32: paged and dense streams are equal
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    streams = {}
    for paged in (False, True):
        o = serve_demo(cfg32, max_batch=8, max_seq=1024, device="cuda",
                       paged=paged, verbose=False, **serve_kw)
        check(o["completed"] == 16, f"fp32 paged={paged}: {o['completed']}")
        streams[paged] = o["tokens"]
    check(streams[True] == streams[False],
          "fp32 2-layer paged and dense greedy streams differ")
    print(f"[paged] {cfg32.num_layers}-layer fp32 at full width: paged and "
          f"dense greedy streams equal over 16 requests "
          f"({sum(len(t) for t in streams[True].values())} tokens)")

    # ----------------------------------------------------------- 4c. int8
    # a prefilled batch of 4 x 256 tokens in a dense cache and in a paged
    # one, quantized; one 32-token extend chunk and 4 decode steps, the
    # kernel path and the plain path each on its own copy
    B8, S8, C8, steps = 4, 256, 32, 4
    toks = torch.randint(0, cfg.vocab_size, (B8, S8 + C8 + steps),
                         generator=gen, device=dev).to(torch.int32)
    model = build_model(cfg)
    with torch.no_grad():
        _, pre = model.prefill_fn(params, {"tokens": toks[:, :S8]})
    dense = T.make_decode_cache(cfg, B8, 1024, dev)
    for n in ("k", "v"):
        dense["kv"][n][:, :, :S8] = pre["kv"][n]
    dense["pos"] = pre["pos"].clone()
    pg = T.make_paged_decode_cache(cfg, B8, 1024, dev, num_pages=B8 * 64)
    pg["table"] = torch.randperm(B8 * 64, generator=gen, device=dev).reshape(
        B8, 64).to(torch.int32)
    insert_cache_pages(pg["kv"], pre["kv"], pg["table"][:, :S8 // 16].long())
    pg["pos"] = pre["pos"].clone()
    int8_caches = {"dense": T.quantize_decode_cache(dense),
                   "paged": T.quantize_decode_cache(pg)}
    del dense, pg, pre

    def int8_run(m, cache):
        cache = {**cache, "kv": {n: t.clone() for n, t in
                                 cache["kv"].items()},
                 "pos": cache["pos"].clone()}
        out = []
        logits, cache = m.extend_fn(
            params, {"tokens": toks[:, S8:S8 + C8]}, cache)
        out.append(logits)
        for i in range(steps):           # the same tokens on both paths
            logits, cache = m.decode_fn(
                params, {"token": toks[:, S8 + C8 + i]}, cache)
            out.append(logits)
        return out

    int8_launches = {}
    for kind, c in int8_caches.items():
        with torch.no_grad():
            reset(*kernel_fns.values())
            got = int8_run(model, c)
            torch.cuda.synchronize()
            k8 = {k: f.launches for k, f in kernel_fns.items() if f.launches}
            want = int8_run(build_model(cfg, reference=True), c)
        kname = ("decode_attention_int8" if kind == "dense"
                 else "paged_decode_attention_int8")
        check(k8 == {kname: L * steps},
              f"int8 {kind}: launches {k8} != {{{kname}: {L} x {steps}}}")
        int8_launches[kname] = k8[kname]
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(got, want)]
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"int8 {kind}: non-finite logits")
        check(max(errs) <= LOGIT_BOUND,
              f"int8 {kind}: logits differ by {max(errs):.3g} > "
              f"{LOGIT_BOUND}")
        print(f"[int8] {kind}: extend C={C8} then {steps} decode steps at "
              f"B={B8}, pos {S8}..{S8 + C8 + steps}: launches {k8}; kernel "
              f"path vs plain path max |logit diff| per call "
              f"{[round(e, 4) for e in errs]} (bound {LOGIT_BOUND})")
    launches.update(int8_launches)
    launches.update(
        paged_decode_attention=paged_runs["num_pages=default"][
            "paged_decode_attention"],
        paged_extend_attention=paged_runs["num_pages=default"][
            "paged_extend_attention"])
    del params, model, int8_caches, got, want
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 4d. async
    # the same 16 requests through async admission at the default budget
    # (max_seq = 1024 prompt tokens a step): prompt tails become extend
    # chunks interleaved with decode steps, the pending rows masked out of
    # the decode. Its streams equal the batched run's (phase 4 dense, 4b
    # paged at the default pool) at bf16; the cut of the prompts into
    # prefill batches and chunks differs, so at bf16 that holds only as
    # far as the roundings agree: the 2-layer fp32 model at full width (as
    # in 4b) holds async to batched where rounding cannot decide
    for paged in (False, True):
        kind = "paged" if paged else "dense"
        reset(*kernel_fns.values())
        aout = serve_demo(cfg, max_batch=8, max_seq=1024, device="cuda",
                          paged=paged, admit_mode="async", **serve_kw)
        al = {k: f.launches for k, f in kernel_fns.items() if f.launches}
        asites = aout["per_site"]
        check(aout["completed"] == aout["submitted"] == 16,
              f"async {kind}: served {aout['completed']}/{aout['submitted']}")
        a_chunks = sum(s["extend_chunks"] for s in asites)
        a_steps = sum(s["decode_steps"] for s in asites)
        a_prefills = sum(s["prefill_calls"] for s in asites) - a_chunks
        if paged:
            want_l = {"flash_attention": L * a_prefills,
                      "paged_extend_attention": L * a_chunks,
                      "paged_decode_attention": L * a_steps}
            check(aout["free_pages"] == aout["num_pages"],
                  f"async paged: pages not returned: free "
                  f"{aout['free_pages']} of {aout['num_pages']}")
        else:
            want_l = {"flash_attention": L * a_prefills,
                      "decode_attention": L * a_steps}
        check(al == want_l and all(want_l.values()),
              f"async {kind}: launches {al} != {want_l}")
        served_a = sum(s["served_tokens"] for s in asites)
        check(served_a == served, f"async {kind}: served {served_a} tokens")
        base = paged_tokens if paged else out["tokens"]
        check(aout["tokens"] == base,
              f"async {kind}: bf16 streams differ from the batched run's: "
              f"rids {[k for k in base if aout['tokens'][k] != base[k]]}")
        print(f"[async] {kind}: 16/16 requests, {served_a} tokens in "
              f"{aout['wall_seconds']:.3f} s "
              f"({served_a / aout['wall_seconds']:.1f} tok/s), streams equal "
              f"to the batched run's; launches {al}")
        for i, s in enumerate(asites):
            print(f"  site {i}: prefill calls "
                  f"{s['prefill_calls'] - s['extend_chunks']}, extend chunks "
                  f"{s['extend_chunks']}, decode steps {s['decode_steps']}, "
                  f"admission steps with no live row "
                  f"{s['admit_stall_steps']}, TTFT mean "
                  f"{s['mean_ttft'] * 1e3:.1f} / p99 "
                  f"{s['p99_ttft'] * 1e3:.1f} ms, TBT mean "
                  f"{s['mean_tbt'] * 1e3:.2f} / p99 "
                  f"{s['p99_tbt'] * 1e3:.2f} ms")
    for paged in (False, True):
        o = serve_demo(cfg32, max_batch=8, max_seq=1024, device="cuda",
                       paged=paged, admit_mode="async", verbose=False,
                       **serve_kw)
        check(o["completed"] == 16, f"fp32 async paged={paged}: "
              f"{o['completed']}")
        check(o["tokens"] == streams[False],
              f"fp32 2-layer async paged={paged}: streams differ from the "
              f"batched dense run's")
    print(f"[async] {cfg32.num_layers}-layer fp32 at full width: async "
          f"streams, dense and paged, equal the batched run's over 16 "
          f"requests ({sum(len(t) for t in streams[False].values())} tokens)")

    # ------------------------------------------------- 5-6. moe and ssm
    # the same traffic at each arch's full width: phi3.5-moe at 8 of its 32
    # layers, as its 1.30 B parameters a layer (2.60 GB in bf16) make 83.7 GB
    # of weights at 32 layers, more than one 80 GB card holds beside the
    # caches (8 layers: 21.3 GB); rwkv6-1.6b whole
    for arch, depth in (("phi3.5-moe-42b-a6.6b", 8), ("rwkv6-1.6b", None)):
        fcfg = full_width_config(arch, depth)
        Lf = fcfg.num_layers
        torch.cuda.reset_peak_memory_stats(dev)
        reset(*kernel_fns.values())
        fout = serve_demo(fcfg, max_batch=8, max_seq=1024, device="cuda",
                          **serve_kw)
        fl = {k: f.launches for k, f in kernel_fns.items() if f.launches}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        fsites = fout["per_site"]
        check(fout["completed"] == fout["submitted"] == 16,
              f"{arch}: served {fout['completed']}/{fout['submitted']}")
        calls = sum(s["prefill_calls"] for s in fsites)   # buckets + chunks
        chunks = sum(s["extend_chunks"] for s in fsites)
        steps = sum(s["decode_steps"] for s in fsites)
        if fcfg.is_moe:
            want_l = {"expert_matmul": 3 * Lf * (calls + steps),
                      "flash_attention": Lf * (calls - chunks),
                      "decode_attention": Lf * steps}
        else:
            want_l = {"wkv6": Lf * calls}
        check(fl == want_l, f"{arch}: launches {fl} != {want_l} ({calls} "
              f"admission calls, {chunks} of them extend chunks, {steps} "
              f"decode steps, {Lf} layers)")
        freqs = demo_requests(fcfg, **serve_kw)
        served_f = sum(s["served_tokens"] for s in fsites)
        check(served_f == sum(r.max_new_tokens for _, r in freqs),
              f"{arch}: served {served_f} tokens")
        print(f"[{fcfg.family}] {arch} L={Lf} of {get_config(arch).num_layers} "
              f"d={fcfg.d_model} V={fcfg.vocab_size} bf16: 16/16 requests, "
              f"{served_f} tokens in {fout['wall_seconds']:.3f} s "
              f"({served_f / fout['wall_seconds']:.1f} tok/s), peak memory "
              f"{peak_gb:.2f} GB")
        for i, s in enumerate(fsites):
            print(f"  site {i}: {s['num_completed']} requests, prefill calls "
                  f"{s['prefill_calls'] - s['extend_chunks']}, extend chunks "
                  f"{s['extend_chunks']}, decode steps {s['decode_steps']}, "
                  f"TTFT mean {s['mean_ttft'] * 1e3:.1f} / p99 "
                  f"{s['p99_ttft'] * 1e3:.1f} ms, TBT mean "
                  f"{s['mean_tbt'] * 1e3:.2f} / p99 {s['p99_tbt'] * 1e3:.2f} ms")
        print(f"  launches on the serving path: {fl}")
        launches.update({k: v for k, v in fl.items()
                         if k in ("expert_matmul", "wkv6")})

        # request 0's first-token logits, kernel path vs plain path: the
        # moe model at bf16, bounded as in phase 4; the ssm model at fp32,
        # and at bf16 within SPREAD_FACTOR_BF16 times the plain path's own
        # spread between 16- and 32-token chunks
        fprompt = torch.as_tensor(freqs[0][1].prompt[None, :])
        runs = [fcfg]
        if fcfg.family == "ssm":
            runs.append(dataclasses.replace(fcfg, dtype="float32"))
        for ccfg in runs:
            cparams = build_model(ccfg).init_params(
                torch.Generator(device=dev).manual_seed(SEED))
            with torch.no_grad():
                got, _ = build_model(ccfg).prefill_fn(cparams,
                                                      {"tokens": fprompt})
                want, _ = build_model(ccfg, reference=True).prefill_fn(
                    cparams, {"tokens": fprompt})
                spread_txt = ""
                if fcfg.family != "ssm":
                    lbound = LOGIT_BOUND
                elif ccfg.dtype == "float32":
                    lbound = LOGIT_BOUND_FP32
                else:
                    alt, _ = build_model(ccfg, reference=True,
                                         wkv_chunk=16).prefill_fn(
                        cparams, {"tokens": fprompt})
                    spread = (alt.float() - want.float()).abs().max().item()
                    lbound = SPREAD_FACTOR_BF16 * spread
                    spread_txt = (f"; plain path with 16-token chunks vs 32: "
                                  f"{spread:.4g}, argmax {int(alt.argmax())}")
            torch.cuda.synchronize()
            check(got.shape == (1, ccfg.vocab_size)
                  and bool(torch.isfinite(got).all()),
                  f"{arch}: logits shape {tuple(got.shape)} or non-finite")
            ferr = (got.float() - want.float()).abs().max().item()
            check(ferr <= lbound, f"{arch} {ccfg.dtype}: logits differ by "
                  f"{ferr:.3g} > {lbound:.3g}")
            print(f"[{fcfg.family}] request 0 (prompt {fprompt.shape[1]} "
                  f"tokens) first-token logits at {ccfg.dtype}, kernel path "
                  f"vs plain path: max |diff| {ferr:.4g} (bound "
                  f"{lbound:.4g}), argmax {int(got.argmax())} vs "
                  f"{int(want.argmax())}{spread_txt}")
            del cparams, got, want
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- 7. co-sim
    # the fleet co-sim at full width on the card, each run beside its twin
    # on the CPU (1 layer, fp32, the plain path): the engines run on the
    # virtual clock with no end token, so the counters must be equal
    def record(res):
        d = res.to_json()
        d.pop("planner")                    # solver wall times
        return d

    twin_cfg = reduced(llama32_1b, num_layers=1, dtype="float32")
    cosim_runs = (("7a", dict(scenario="grid_trip")),
                  ("7b", dict(scenario="site_failure", site=0, paged=True)))
    for tag, kw in cosim_runs:
        torch.cuda.reset_peak_memory_stats(dev)
        reset(*kernel_fns.values())
        run = run_cosim(cfg, device="cuda", seed=SEED, **kw)
        cl = {k: f.launches for k, f in kernel_fns.items() if f.launches}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        twin = run_cosim(twin_cfg, device="cpu", seed=SEED, **kw)
        res, c = run.result, run.counts
        got, want = record(res), record(twin.result)
        ticks, wall = run.fleet.now, run.wall_seconds
        kind = "paged" if kw.get("paged") else "dense"
        print(f"[cosim] {tag} {res.name} {kind} {cfg.name} L={L} bf16 on "
              f"the card: {json.dumps(got)}")
        print(f"  engines {c['engines']}, prefills {c['prefills']}, extend "
              f"chunks {c['extend_chunks']}, decode steps "
              f"{c['decode_steps']}; {ticks:.0f} ticks, {wall:.3f} s wall "
              f"({wall / ticks * 1e3:.2f} ms a tick, "
              f"{c['engine_steps'] / wall:.1f} engine "
              f"steps/s), Planner-L {sum(res.planner['solve_s']):.3f} s; "
              f"hand-written kernel launches {cl} "
              f"({sum(cl.values()) / ticks:.1f} a tick); peak "
              f"memory {peak_gb:.2f} GB; CPU twin {twin.wall_seconds:.3f} s")
        diff = {k: (got[k], want.get(k)) for k in got if got[k] != want.get(k)}
        check(not diff, f"co-sim {tag}: counters differ from the CPU twin: "
              f"{diff}")
        check(c == twin.counts, f"co-sim {tag}: engine counts {c} != the "
              f"CPU twin's {twin.counts}")
        check(res.duplicated_tokens == 0,
              f"co-sim {tag}: {res.duplicated_tokens} duplicated tokens")
        check(res.completed == res.offered_requests > 0,
              f"co-sim {tag}: completed {res.completed} of "
              f"{res.offered_requests}")
        live = [e for e in run.fleet.engines if e is not None]
        for eng in live:
            books = eng.reconcile()
            check(books["balanced"], f"co-sim {tag}: ledger {books}")
        if kw.get("paged"):
            want_l = {"flash_attention": L * c["prefills"],
                      "paged_decode_attention": L * c["decode_steps"],
                      "paged_extend_attention": L * c["extend_chunks"]}
            check(res.resumes > 0, f"co-sim {tag}: nothing resumed")
            free = [(len(e._free_pages), e.num_pages) for e in live]
            check(all(f == n for f, n in free),
                  f"co-sim {tag}: pages not returned: {free}")
        else:
            want_l = {"flash_attention": L * c["prefills"],
                      "decode_attention": L * c["decode_steps"]}
        check(cl == want_l and all(want_l.values()),
              f"co-sim {tag}: launches {cl} != {want_l}")
        del run, twin
        torch.cuda.empty_cache()

    # 7c: resume through the kernels. A 2-layer fp32 model at full width,
    # 8 requests (greedy and sampled) on 6 slots: drained after 3 steps and
    # resumed on an engine with another seed, the streams are the
    # uninterrupted serial run's
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init_params(
        torch.Generator(device=dev).manual_seed(SEED))
    for paged in (False, True):
        def engine(seed, mode="batched"):
            return ServingEngine(model32, params32, max_batch=6,
                                 max_seq=1024, seed=seed, admit_mode=mode,
                                 paged=paged)

        def requests():
            reqs = [r for _, r in demo_requests(
                cfg32, num_requests=8, num_sites=1, seed=SEED,
                prompt_len=(16, 200), new_tokens=(8, 33))]
            for r in reqs[1::2]:
                r.temperature = 0.8
            return reqs

        with torch.no_grad():
            ref_eng = engine(SEED, "serial")
            for r in requests():
                ref_eng.submit(r)
            want = {r.rid: r.tokens for r in ref_eng.run().completed}
            e1 = engine(SEED)
            for r in requests():
                e1.submit(r)
            for _ in range(3):
                e1.step()
            snaps = e1.drain()
            e2 = engine(SEED + 91)
            for snap in snaps:
                check(e2.resume(snap) is not None, "7c: resume refused")
            got = {r.rid: r.tokens for r in e2.run().completed}
        carried = sum(len(snap.tokens) for snap in snaps)
        kind = "paged" if paged else "dense"
        check(len(snaps) == 8 and e1.metrics.preemptions == 6,
              f"7c {kind}: {len(snaps)} snapshots, "
              f"{e1.metrics.preemptions} preempted")
        check(e2.metrics.recovered_tokens == carried > 0,
              f"7c {kind}: recovered {e2.metrics.recovered_tokens} of "
              f"{carried} carried tokens")
        check(got == want, f"7c {kind}: resumed streams differ from the "
              f"uninterrupted run: rids "
              f"{[k for k in want if got.get(k) != want[k]]}")
        check(e1.reconcile()["balanced"] and e2.reconcile()["balanced"],
              f"7c {kind}: ledgers do not balance")
        print(f"[cosim] 7c {kind} {cfg32.num_layers}-layer fp32 at full "
              f"width: 8 requests drained after 3 steps "
              f"({e1.metrics.preemptions} live, {carried} tokens carried), "
              f"resumed on seed "
              f"{SEED + 91}: streams equal the uninterrupted serial run's "
              f"({sum(len(t) for t in got.values())} tokens)")
    del model32, params32
    torch.cuda.empty_cache()
    print(f"[cosim] card: {smi}")

    # --------------------------------------------------- 8. new families
    # qwen3-14b whole (40 layers, d 5120, 40 heads over 8 KV heads, hd 128,
    # qk-norm: 14.8 B parameters, 29.5 GB in bf16) and seamless-m4t-medium
    # whole (12 encoder + 12 decoder layers, d 1024, 16 heads, hd 64), the
    # same 16 requests over dense and paged caches. Launches: a prefill
    # call runs kernel 1 in every self-attention layer, and for seamless in
    # every encoder layer and every cross-attention layer too; an extend
    # chunk runs kernel 5 when paged (a dense extend is plain PyTorch) and,
    # for seamless, kernel 1 in every cross-attention layer; a decode step
    # runs kernel 2 (dense) or 4 (paged) per layer, and for seamless
    # kernel 2 again per cross-attention layer, every row at 160 keys
    for arch in ("qwen3-14b", "seamless-m4t-medium"):
        fcfg = full_width_config(arch)
        Lf, encdec = fcfg.num_layers, fcfg.family == "encdec"
        freqs = demo_requests(fcfg, **serve_kw)
        for paged in (False, True):
            kind = "paged" if paged else "dense"
            torch.cuda.reset_peak_memory_stats(dev)
            reset(*kernel_fns.values())
            fout = serve_demo(fcfg, max_batch=8, max_seq=1024, device="cuda",
                              paged=paged, **serve_kw)
            fl = {k: f.launches for k, f in kernel_fns.items() if f.launches}
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            fsites = fout["per_site"]
            check(fout["completed"] == fout["submitted"] == 16,
                  f"{arch} {kind}: served {fout['completed']}/"
                  f"{fout['submitted']}")
            chunks = sum(s["extend_chunks"] for s in fsites)
            steps = sum(s["decode_steps"] for s in fsites)
            prefills = sum(s["prefill_calls"] for s in fsites) - chunks
            want_l = {"flash_attention": Lf * prefills}
            if paged:
                want_l["paged_extend_attention"] = Lf * chunks
                want_l["paged_decode_attention"] = Lf * steps
            else:
                want_l["decode_attention"] = Lf * steps
            if encdec:
                want_l["flash_attention"] += ((fcfg.encoder_layers + Lf)
                                              * prefills + Lf * chunks)
                want_l["decode_attention"] = (want_l.get("decode_attention", 0)
                                              + Lf * steps)
            check(fl == want_l and all(want_l.values()),
                  f"{arch} {kind}: launches {fl} != {want_l} ({prefills} "
                  f"prefill calls, {chunks} extend chunks, {steps} decode "
                  f"steps)")
            if paged:
                check(fout["free_pages"] == fout["num_pages"],
                      f"{arch} paged: pages not returned: free "
                      f"{fout['free_pages']} of {fout['num_pages']}")
            served_f = sum(s["served_tokens"] for s in fsites)
            check(served_f == sum(r.max_new_tokens for _, r in freqs),
                  f"{arch} {kind}: served {served_f} tokens")
            print(f"[{fcfg.family}] {arch} {kind} L={Lf}"
                  f"{f'+{fcfg.encoder_layers}' if encdec else ''} "
                  f"d={fcfg.d_model} H={fcfg.num_heads} "
                  f"KVH={fcfg.num_kv_heads} V={fcfg.vocab_size} bf16: 16/16 "
                  f"requests, {served_f} tokens in "
                  f"{fout['wall_seconds']:.3f} s "
                  f"({served_f / fout['wall_seconds']:.1f} tok/s), peak "
                  f"memory {peak_gb:.2f} GB; launches {fl}")
            for i, s in enumerate(fsites):
                print(f"  site {i}: prefill calls "
                      f"{s['prefill_calls'] - s['extend_chunks']}, extend "
                      f"chunks {s['extend_chunks']}, decode steps "
                      f"{s['decode_steps']}, TTFT mean "
                      f"{s['mean_ttft'] * 1e3:.1f} / p99 "
                      f"{s['p99_ttft'] * 1e3:.1f} ms, TBT mean "
                      f"{s['mean_tbt'] * 1e3:.2f} / p99 "
                      f"{s['p99_tbt'] * 1e3:.2f} ms")

        # request 0 through its admission and two greedy decode steps (the
        # kernel path's tokens fed to both paths), kernel path vs plain
        # path, over a dense cache (one prefill) and a paged one (a prefill
        # of the prompt's largest power of 2 below its length, the rest as
        # descending power-of-2 extend chunks, as the engine admits it, on
        # a shuffled table); seamless with random frames, so that its
        # encoder and cross-attention carry values
        fparams = build_model(fcfg).init_params(
            torch.Generator(device=dev).manual_seed(SEED))
        prompt = torch.as_tensor(freqs[0][1].prompt[None, :], device=dev)
        inputs = {"tokens": prompt}
        if encdec:
            inputs["frames"] = rnd(1, fcfg.num_prefix_embeddings,
                                   fcfg.d_model, dtype=bf)
        S0 = prompt.shape[1]
        bucket = 1 << ((S0 - 1).bit_length() - 1)
        ftable = torch.randperm(64, generator=gen, device=dev)[None].to(
            torch.int32)

        def admit(m, kind):
            if kind == "dense":
                logits, pre = m.prefill_fn(fparams, inputs)
                cache = T.make_decode_cache(fcfg, 1, 1024, dev)
                insert_cache_rows(cache, pre, numpy.zeros(1, numpy.int32))
                return logits, cache, 0
            logits, pre = m.prefill_fn(
                fparams, {**inputs, "tokens": prompt[:, :bucket]})
            cache = T.make_paged_decode_cache(fcfg, 1, 1024, dev,
                                              num_pages=64)
            cache["table"] = ftable.clone()
            insert_cache_pages(cache["kv"], pre["kv"],
                               ftable[:, :-(-bucket // 16)].long())
            for n, t in cache.get("enc_kv", {}).items():
                t.copy_(pre["enc_kv"][n])
            cache["pos"] = pre["pos"].clone()
            done, chunks = bucket, 0
            while done < S0:
                C = 1 << ((S0 - done).bit_length() - 1)
                logits, cache = m.extend_fn(
                    fparams, {"tokens": prompt[:, done:done + C]}, cache)
                done, chunks = done + C, chunks + 1
            return logits, cache, chunks

        runs = {}
        with torch.no_grad():
            for kind in ("dense", "paged"):
                for plain in (False, True):
                    m = build_model(fcfg, reference=plain)
                    logits, cache, fchunks = admit(m, kind)
                    seq = [logits]
                    for i in range(2):
                        tok = (runs[kind, False][i].argmax(-1) if plain
                               else logits.argmax(-1)).to(torch.int32)
                        logits, cache = m.decode_fn(fparams, {"token": tok},
                                                    cache)
                        seq.append(logits)
                    runs[kind, plain] = seq
                    del cache
        torch.cuda.synchronize()
        for kind in ("dense", "paged"):
            got, want = runs[kind, False], runs[kind, True]
            check(all(a.shape == (1, fcfg.vocab_size)
                      and bool(torch.isfinite(a).all()) for a in got),
                  f"{arch} {kind}: logits shape or non-finite")
            errs = [(a.float() - b.float()).abs().max().item()
                    for a, b in zip(got, want)]
            check(max(errs) <= LOGIT_BOUND, f"{arch} {kind}: logits differ "
                  f"by {max(errs):.3g} > {LOGIT_BOUND}")
            admitted = ("prefill" if kind == "dense" else
                        f"prefill of {bucket} + {fchunks} extend chunks")
            print(f"[{fcfg.family}] {arch} {kind} request 0 (prompt {S0} "
                  f"tokens{', random frames' if encdec else ''}): "
                  f"{admitted} and 2 decode steps, kernel path vs plain path "
                  f"max |logit diff| per call "
                  f"{[round(e, 4) for e in errs]} (bound {LOGIT_BOUND}), "
                  f"argmax {[int(a.argmax()) for a in got]} vs "
                  f"{[int(b.argmax()) for b in want]}")
        del fparams, runs, got, want, logits
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ 9. vlm
    # paligemma-3b whole (18 layers, d 2048, 8 heads over one KV head, hd
    # 256, d_ff 16384, V 257216, tied embeddings: 2.51 B parameters, 5.0 GB
    # in bf16), the same 16 requests, each prompt behind 256 zero patches
    # (the vision stub), dense and paged, batched and async. The patches
    # take cache positions: a request whose patches + prompt +
    # max_new_tokens - 1 pass max_seq is rejected. Launches: a prefill call
    # runs kernel 1 in every layer (the 256 patch keys seen by every
    # query), a paged extend chunk kernel 5 (a dense one is plain PyTorch),
    # a decode step kernel 2 (dense) or 4 (paged)
    vcfg = full_width_config("paligemma-3b")
    Lv, Pv = vcfg.num_layers, vcfg.num_prefix_embeddings
    vreqs = [r for _, r in demo_requests(vcfg, **serve_kw)]
    v_rej = {r.rid for r in vreqs
             if Pv + len(r.prompt) + r.max_new_tokens - 1 > 1024}
    v_tokens = sum(r.max_new_tokens for r in vreqs if r.rid not in v_rej)
    print(f"[vlm] {vcfg.name}: {Pv} patches + prompts of "
          f"{min(len(r.prompt) for r in vreqs)}-"
          f"{max(len(r.prompt) for r in vreqs)} tokens, longest contract "
          f"{max(Pv + len(r.prompt) + r.max_new_tokens - 1 for r in vreqs)}"
          f" positions of max_seq 1024: {len(v_rej)} to reject")
    v_streams = {}
    for mode in ("batched", "async"):
        for paged in (False, True):
            kind = f"{mode} {'paged' if paged else 'dense'}"
            torch.cuda.reset_peak_memory_stats(dev)
            reset(*kernel_fns.values())
            vout = serve_demo(vcfg, max_batch=8, max_seq=1024, device="cuda",
                              paged=paged, admit_mode=mode, **serve_kw)
            vl = {k: f.launches for k, f in kernel_fns.items() if f.launches}
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            vsites = vout["per_site"]
            rejected = sum(s["rejected"] for s in vsites)
            check(vout["completed"] == 16 - len(v_rej)
                  and rejected == len(v_rej)
                  and set(vout["tokens"]) == {r.rid for r in vreqs} - v_rej,
                  f"vlm {kind}: completed {vout['completed']}, rejected "
                  f"{rejected}; the rule rejects {sorted(v_rej)}")
            chunks = sum(s["extend_chunks"] for s in vsites)
            steps = sum(s["decode_steps"] for s in vsites)
            prefills = sum(s["prefill_calls"] for s in vsites) - chunks
            want_l = {"flash_attention": Lv * prefills}
            if paged:
                want_l["paged_extend_attention"] = Lv * chunks
                want_l["paged_decode_attention"] = Lv * steps
                check(vout["free_pages"] == vout["num_pages"],
                      f"vlm {kind}: pages not returned: free "
                      f"{vout['free_pages']} of {vout['num_pages']}")
            else:
                want_l["decode_attention"] = Lv * steps
            check(vl == want_l and all(want_l.values()),
                  f"vlm {kind}: launches {vl} != {want_l} ({prefills} "
                  f"prefill calls, {chunks} extend chunks, {steps} decode "
                  f"steps)")
            served_v = sum(s["served_tokens"] for s in vsites)
            check(served_v == v_tokens, f"vlm {kind}: served {served_v} "
                  f"tokens, not {v_tokens}")
            v_streams[mode, paged] = vout["tokens"]
            base = v_streams["batched", False]
            same = sum(vout["tokens"][k] == base[k] for k in base)
            print(f"[vlm] {vcfg.name} {kind} L={Lv} d={vcfg.d_model} "
                  f"H={vcfg.num_heads} KVH={vcfg.num_kv_heads} "
                  f"hd={vcfg.head_dim} V={vcfg.vocab_size} bf16: "
                  f"{vout['completed']}/16 requests ({rejected} rejected), "
                  f"{served_v} tokens in {vout['wall_seconds']:.3f} s "
                  f"({served_v / vout['wall_seconds']:.1f} tok/s), "
                  f"{prefills + chunks + steps} model calls, peak memory "
                  f"{peak_gb:.2f} GB; launches {vl}; streams equal to the "
                  f"batched dense run's: {same} of {len(base)}")
            for i, s in enumerate(vsites):
                print(f"  site {i}: prefill calls "
                      f"{s['prefill_calls'] - s['extend_chunks']}, "
                      f"extend chunks {s['extend_chunks']}, decode steps "
                      f"{s['decode_steps']}, TTFT mean "
                      f"{s['mean_ttft'] * 1e3:.1f} / p99 "
                      f"{s['p99_ttft'] * 1e3:.1f} ms, TBT mean "
                      f"{s['mean_tbt'] * 1e3:.2f} / p99 "
                      f"{s['p99_tbt'] * 1e3:.2f} ms")
    torch.cuda.empty_cache()

    # request 0 with random patches through a prefill of its largest power
    # of 2 below its length, the rest as descending power-of-2 extend
    # chunks and two greedy decode steps (the kernel path's tokens fed to
    # both), kernel path vs plain path, over a dense cache and a paged one
    # on a shuffled table
    vparams = build_model(vcfg).init_params(
        torch.Generator(device=dev).manual_seed(SEED))
    vprompt = torch.as_tensor(vreqs[0].prompt[None, :], device=dev)
    patches = rnd(1, Pv, vcfg.d_model, dtype=bf, g=g_vlm)
    S0 = vprompt.shape[1]
    vbucket = 1 << ((S0 - 1).bit_length() - 1)
    vtable = torch.randperm(64, generator=g_vlm, device=dev)[None].to(
        torch.int32)

    def vlm_admit(m, kind):
        logits, pre = m.prefill_fn(vparams, {"tokens": vprompt[:, :vbucket],
                                             "patches": patches})
        if kind == "dense":
            cache = T.make_decode_cache(vcfg, 1, 1024, dev)
            insert_cache_rows(cache, pre, numpy.zeros(1, numpy.int32))
        else:
            cache = T.make_paged_decode_cache(vcfg, 1, 1024, dev,
                                              num_pages=64)
            cache["table"] = vtable.clone()
            insert_cache_pages(cache["kv"], pre["kv"], vtable[
                :, :-(-(Pv + vbucket) // 16)].long())
            cache["pos"] = pre["pos"].clone()
        done, n = vbucket, 0
        while done < S0:
            C = 1 << ((S0 - done).bit_length() - 1)
            logits, cache = m.extend_fn(
                vparams, {"tokens": vprompt[:, done:done + C]}, cache)
            done, n = done + C, n + 1
        return logits, cache, n

    vruns = {}
    with torch.no_grad():
        for kind in ("dense", "paged"):
            for plain in (False, True):
                m = build_model(vcfg, reference=plain)
                logits, cache, vchunks = vlm_admit(m, kind)
                seq = [logits]
                for i in range(2):
                    tok = (vruns[kind, False][i].argmax(-1) if plain
                           else logits.argmax(-1)).to(torch.int32)
                    logits, cache = m.decode_fn(vparams, {"token": tok},
                                                cache)
                    seq.append(logits)
                vruns[kind, plain] = seq
                del cache
    torch.cuda.synchronize()
    for kind in ("dense", "paged"):
        got, want = vruns[kind, False], vruns[kind, True]
        check(all(a.shape == (1, vcfg.vocab_size)
                  and bool(torch.isfinite(a).all()) for a in got),
              f"vlm {kind}: logits shape or non-finite")
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(got, want)]
        check(max(errs) <= LOGIT_BOUND, f"vlm {kind}: logits differ by "
              f"{max(errs):.3g} > {LOGIT_BOUND}")
        print(f"[vlm] {kind} request 0 ({Pv} random patches + prompt {S0} "
              f"tokens): prefill of {vbucket} + {vchunks} extend chunks and "
              f"2 decode steps, kernel path vs plain path max |logit diff| "
              f"per call {[round(e, 4) for e in errs]} (bound "
              f"{LOGIT_BOUND}), argmax {[int(a.argmax()) for a in got]} vs "
              f"{[int(b.argmax()) for b in want]}")
    del vruns, got, want, logits

    # int8 at hd 256: a batch of 4 prompts of 256 tokens behind zero
    # patches, prefilled into a dense and a paged cache and quantized; one
    # 32-token extend chunk and 4 decode steps through kernels 3 and
    # 4-int8, the kernel path and the plain path each on its own copy
    B8, S8, C8, steps8 = 4, 256, 32, 4
    N8 = Pv + S8                          # cache positions after prefill
    toks8 = torch.randint(0, vcfg.vocab_size, (B8, S8 + C8 + steps8),
                          generator=g_vlm, device=dev).to(torch.int32)
    vmodel = build_model(vcfg)
    with torch.no_grad():
        _, pre = vmodel.prefill_fn(vparams, {
            "tokens": toks8[:, :S8],
            "patches": torch.zeros((B8, Pv, vcfg.d_model), dtype=bf,
                                   device=dev)})
    dense8 = T.make_decode_cache(vcfg, B8, 1024, dev)
    insert_cache_rows(dense8, pre, numpy.arange(B8, dtype=numpy.int32))
    pg8 = T.make_paged_decode_cache(vcfg, B8, 1024, dev, num_pages=B8 * 64)
    pg8["table"] = torch.randperm(B8 * 64, generator=g_vlm,
                                  device=dev).reshape(B8, 64).to(torch.int32)
    insert_cache_pages(pg8["kv"], pre["kv"], pg8["table"][:, :N8 // 16].long())
    pg8["pos"] = pre["pos"].clone()
    vint8 = {"dense": T.quantize_decode_cache(dense8),
             "paged": T.quantize_decode_cache(pg8)}
    del dense8, pg8, pre

    def vlm_int8_run(m, cache):
        cache = {**cache, "kv": {n: t.clone() for n, t in
                                 cache["kv"].items()},
                 "pos": cache["pos"].clone()}
        logits, cache = m.extend_fn(
            vparams, {"tokens": toks8[:, S8:S8 + C8]}, cache)
        out = [logits]
        for i in range(steps8):           # the same tokens on both paths
            logits, cache = m.decode_fn(
                vparams, {"token": toks8[:, S8 + C8 + i]}, cache)
            out.append(logits)
        return out

    for kind, c in vint8.items():
        with torch.no_grad():
            reset(*kernel_fns.values())
            got = vlm_int8_run(vmodel, c)
            torch.cuda.synchronize()
            k8 = {k: f.launches for k, f in kernel_fns.items() if f.launches}
            want = vlm_int8_run(build_model(vcfg, reference=True), c)
        kname = ("decode_attention_int8" if kind == "dense"
                 else "paged_decode_attention_int8")
        check(k8 == {kname: Lv * steps8},
              f"vlm int8 {kind}: launches {k8} != {{{kname}: {Lv} x "
              f"{steps8}}}")
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(got, want)]
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"vlm int8 {kind}: non-finite logits")
        check(max(errs) <= LOGIT_BOUND, f"vlm int8 {kind}: logits differ "
              f"by {max(errs):.3g} > {LOGIT_BOUND}")
        print(f"[vlm] int8 {kind}: extend C={C8} then {steps8} decode steps "
              f"at B={B8}, pos {N8}..{N8 + C8 + steps8} ({Pv} of them "
              f"patches): launches {k8}; kernel path vs plain path max "
              f"|logit diff| per call {[round(e, 4) for e in errs]} (bound "
              f"{LOGIT_BOUND})")
    del vparams, vmodel, vint8, got, want
    torch.cuda.empty_cache()

    # a 2-layer fp32 copy at full width: dense and paged, batched and
    # async give one set of streams (bf16 roundings cannot decide there)
    vcfg32 = dataclasses.replace(vcfg, num_layers=2, dtype="float32")
    v32 = {}
    for mode in ("batched", "async"):
        for paged in (False, True):
            o = serve_demo(vcfg32, max_batch=8, max_seq=1024, device="cuda",
                           paged=paged, admit_mode=mode, verbose=False,
                           **serve_kw)
            check(o["completed"] == 16 - len(v_rej),
                  f"vlm fp32 {mode} paged={paged}: {o['completed']}")
            v32[mode, paged] = o["tokens"]
    check(all(t == v32["batched", False] for t in v32.values()),
          "vlm fp32 2-layer: streams differ between dense/paged or "
          "batched/async: " + str({k: sum(t[r] != v32["batched", False][r]
                                          for r in t)
                                   for k, t in v32.items()}))
    print(f"[vlm] {vcfg32.num_layers}-layer fp32 at full width: dense and "
          f"paged, batched and async streams equal over "
          f"{len(v32['batched', False])} requests "
          f"({sum(len(t) for t in v32['batched', False].values())} tokens)")
    torch.cuda.empty_cache()
    print(f"[vlm] card: {smi}")

    # ------------------------------------------------------------ 10. mla
    # deepseek-v2-236b at its published width (d 5120, 128 heads, MLA with
    # q_lora 1536 and kv_lora 512, q/k 128 + 64 over v 128; 160 routed
    # experts top-6 and 2 shared of 1536 in every layer; V 102400), 6 of
    # its 60 layers: one layer is 3.97 B parameters, so 6 layers and the
    # untied embeddings make 24.9 B (49.8 GB in bf16), the whole model 239 B,
    # far past one 80 GB card. The same 16 requests, batched and async, over
    # the dense latent cache (an engine asked for pages stays dense).
    # Launches: a prefill call runs kernel 1 (the expanded form) in every
    # layer; every model call runs kernel 6 three times a layer for each
    # slice of its tokens (moe.slice_tokens: a prefill batch of up to 8 x
    # 512 tokens takes several); the absorbed extend and decode are plain
    # matmuls, so kernels 2-5 never launch
    mcfg = full_width_config("deepseek-v2-236b", 6)
    Lm = mcfg.num_layers
    mreqs = [r for _, r in demo_requests(mcfg, **serve_kw)]
    m_tokens = sum(r.max_new_tokens for r in mreqs)
    print(f"[mla] {mcfg.name} at full width, {Lm} of "
          f"{get_config(mcfg.name).num_layers} layers: "
          f"{mcfg.param_count() / 1e9:.2f} B parameters "
          f"({2 * mcfg.param_count() / 1e9:.1f} GB in bf16); the whole "
          f"model {get_config(mcfg.name).param_count() / 1e9:.1f} B; "
          f"kernel 6 slices of {slice_tokens(160, 5120, bf)} tokens")
    m_launch = {}
    m_streams = {}
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    for mode in ("batched", "async"):
        torch.cuda.reset_peak_memory_stats(dev)
        reset(*kernel_fns.values())
        mout = serve_demo(mcfg, max_batch=8, max_seq=1024, device="cuda",
                          admit_mode=mode, **serve_kw)
        ml = {k: f.launches for k, f in kernel_fns.items() if f.launches}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        msites = mout["per_site"]
        check(mout["completed"] == mout["submitted"] == 16
              and set(mout["tokens"]) == {r.rid for r in mreqs},
              f"mla {mode}: served {mout['completed']}/{mout['submitted']}")
        chunks = sum(s["extend_chunks"] for s in msites)
        steps = sum(s["decode_steps"] for s in msites)
        prefills = sum(s["prefill_calls"] for s in msites) - chunks
        calls = prefills + chunks + steps
        k6 = ml.get("expert_matmul", 0)
        check(set(ml) == {"flash_attention", "expert_matmul"}
              and ml["flash_attention"] == Lm * prefills
              and k6 % (3 * Lm) == 0 and k6 >= 3 * Lm * calls,
              f"mla {mode}: launches {ml}; want kernel 1 {Lm} x {prefills} "
              f"prefill calls, kernel 6 3 x {Lm} x (slices >= {calls} model "
              f"calls), no other kernel")
        served_m = sum(s["served_tokens"] for s in msites)
        check(served_m == m_tokens, f"mla {mode}: served {served_m} tokens, "
              f"not {m_tokens}")
        check(peak_gb < card_gb, f"mla {mode}: peak {peak_gb:.2f} GB")
        m_launch[mode] = ml
        m_streams[mode] = mout["tokens"]
        same = sum(mout["tokens"][k] == m_streams["batched"][k]
                   for k in m_streams["batched"])
        print(f"[mla] {mcfg.name} {mode} L={Lm} d={mcfg.d_model} "
              f"H={mcfg.num_heads} bf16: 16/16 requests, {served_m} tokens "
              f"in {mout['wall_seconds']:.3f} s "
              f"({served_m / mout['wall_seconds']:.1f} tok/s), {calls} model "
              f"calls ({prefills} prefill, {chunks} extend, {steps} decode), "
              f"kernel 6 slices {k6 // (3 * Lm)}; peak memory {peak_gb:.2f} "
              f"GB of {card_gb:.2f}; launches {ml} (kernels 2-5: 0); "
              f"streams equal to the batched run's: {same} of 16")
        for i, s in enumerate(msites):
            print(f"  site {i}: prefill calls "
                  f"{s['prefill_calls'] - s['extend_chunks']}, extend chunks "
                  f"{s['extend_chunks']}, decode steps {s['decode_steps']}, "
                  f"TTFT mean {s['mean_ttft'] * 1e3:.1f} / p99 "
                  f"{s['p99_ttft'] * 1e3:.1f} ms, TBT mean "
                  f"{s['mean_tbt'] * 1e3:.2f} / p99 {s['p99_tbt'] * 1e3:.2f} "
                  f"ms")
        torch.cuda.empty_cache()
    mla_flash_entry["launches"] = m_launch["batched"]["flash_attention"]
    for e in mla_expert_entries:
        e["launches"] = m_launch["batched"]["expert_matmul"]

    # request 0 through a prefill of its largest power of 2 below its
    # length, the rest as descending power-of-2 extend chunks and two greedy
    # decode steps (the kernel path's tokens fed to every run), kernel path
    # vs plain path; an engine asked for pages keeps the dense latent cache.
    # The top-6 routing over 160 experts flips between near-tied experts
    # under one bf16 rounding (the tokens whose expert set differs between
    # the two paths are counted per layer of the prefill), so the plain path
    # differs from itself between two cuts of the same prompt (its prefill
    # at that power of 2, or at half of it) by more than LOGIT_BOUND. As for
    # rwkv6 at bf16 (phase 6), the kernel path is held within
    # SPREAD_FACTOR_BF16 times that spread (the bound at least LOGIT_BOUND),
    # with the plain path's argmax at every call
    mparams = build_model(mcfg).init_params(
        torch.Generator(device=dev).manual_seed(SEED))
    check(not ServingEngine(build_model(mcfg), mparams, max_batch=8,
                            max_seq=1024, paged=True).paged,
          "mla: an engine asked for pages is paged")
    mprompt = torch.as_tensor(mreqs[0].prompt[None, :], device=dev)
    S0 = mprompt.shape[1]
    mbucket = 1 << ((S0 - 1).bit_length() - 1)
    route, routes = MOE._route, {}

    def mla_admit(plain, bucket, toks):
        """Logits of each call; the greedy tokens, unless ``toks``."""
        def recording(x32, w, k):
            out = route(x32, w, k)
            routes.setdefault((plain, bucket), []).append(out[1])
            return out

        m = build_model(mcfg, reference=plain)
        MOE._route = recording
        try:
            logits, pre = m.prefill_fn(mparams,
                                       {"tokens": mprompt[:, :bucket]})
            cache = T.make_decode_cache(mcfg, 1, 1024, dev)
            insert_cache_rows(cache, pre, numpy.zeros(1, numpy.int32))
            del pre
            seq, done = [logits], bucket
            while done < S0:
                C = 1 << ((S0 - done).bit_length() - 1)
                logits, cache = m.extend_fn(
                    mparams, {"tokens": mprompt[:, done:done + C]}, cache)
                seq.append(logits)
                done += C
            toks = toks or []
            for i in range(2):
                if len(toks) == i:
                    toks.append(logits.argmax(-1).to(torch.int32))
                logits, cache = m.decode_fn(mparams, {"token": toks[i]},
                                            cache)
                seq.append(logits)
        finally:
            MOE._route = route
        return seq, toks

    with torch.no_grad():
        got, mtoks = mla_admit(False, mbucket, None)
        want, _ = mla_admit(True, mbucket, mtoks)
        alt, _ = mla_admit(True, mbucket // 2, mtoks)
    torch.cuda.synchronize()
    check(all(a.shape == (1, mcfg.vocab_size)
              and bool(torch.isfinite(a).all()) for a in got),
          "mla: logits shape or non-finite")
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(got, want)]
    # the calls both cuts share: the last extend chunk, two decode steps
    spread = max((a.float() - b.float()).abs().max().item()
                 for a, b in zip(want[-3:], alt[-3:]))
    lbound = max(LOGIT_BOUND, SPREAD_FACTOR_BF16 * spread)
    flips = [int((a.sort(-1)[0] != b.sort(-1)[0]).any(-1).sum())
             for a, b in zip(routes[False, mbucket][:Lm],
                             routes[True, mbucket][:Lm])]
    check(max(errs) <= lbound and all(
        int(a.argmax()) == int(b.argmax()) for a, b in zip(got, want)),
          f"mla: logits differ by {max(errs):.3g} (bound {lbound:.3g}) or "
          f"argmax {[int(a.argmax()) for a in got]} != "
          f"{[int(b.argmax()) for b in want]}")
    print(f"[mla] request 0 (prompt {S0} tokens): prefill of {mbucket}, "
          f"{len(got) - 3} extend chunks and 2 decode steps, kernel path vs "
          f"plain path max |logit diff| per call {[round(e, 4) for e in errs]}"
          f" (bound {lbound:.4g}), argmax {[int(a.argmax()) for a in got]} "
          f"vs {[int(b.argmax()) for b in want]}; plain path, prefill of "
          f"{mbucket} vs {mbucket // 2}: {spread:.4g} over the last 3 calls; "
          f"prefill tokens whose top-6 experts differ between the paths, by "
          f"layer: {flips} of {mbucket}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    del mparams, got, want, alt, routes
    torch.cuda.empty_cache()

    # a 1-layer fp32 copy at full width (15.9 GB of layer, 4.2 of
    # embeddings): batched and async give one set of streams
    mcfg32 = dataclasses.replace(mcfg, num_layers=1, dtype="float32")
    m32 = {}
    for mode in ("batched", "async"):
        o = serve_demo(mcfg32, max_batch=8, max_seq=1024, device="cuda",
                       admit_mode=mode, verbose=False, **serve_kw)
        check(o["completed"] == 16, f"mla fp32 {mode}: {o['completed']}")
        m32[mode] = o["tokens"]
    check(m32["async"] == m32["batched"], "mla fp32 1-layer: async streams "
          "differ from batched: " + str(sum(
              m32["async"][r] != m32["batched"][r] for r in m32["batched"])))
    print(f"[mla] {mcfg32.num_layers}-layer fp32 at full width: batched and "
          f"async streams equal over 16 requests "
          f"({sum(len(t) for t in m32['batched'].values())} tokens)")
    torch.cuda.empty_cache()
    print(f"[mla] card: {smi}")

    # --------------------------------------------------------- 11. hybrid
    # zamba2-7b whole: 81 Mamba2 layers (d 3584, inner 7168, SSM state 64
    # over 112 heads of 64, conv 4), 13 groups of (the shared attention +
    # MLP block, 32 heads over 32 at hd 112, with the group's rank-128 LoRA
    # on q/k/v, then 6 Mamba2 layers) and 3 tail layers; V 32000: 6.78 B
    # parameters, 13.6 GB in bf16. lora_b (zero in the reference's init),
    # A_log and dt_bias are perturbed from a seed, so that the LoRA delta
    # and the decay clamp (dt * A past 1.5) take part. The same 16
    # requests, batched and async, over the dense state + attn caches (an
    # engine asked for pages stays dense). Launches: a prefill call runs
    # kernel 1 once a group, a decode step kernel 2 once a group; the dense
    # extend is plain PyTorch and the SSD has no kernel (the reference
    # computes it in XLA), so kernels 3-7 never launch
    from repro_torch.models import mamba2 as M2
    zcfg = full_width_config("zamba2-7b")
    Gz = zcfg.num_layers // zcfg.shared_attn_every
    zreqs = [r for _, r in demo_requests(zcfg, **serve_kw)]
    z_tokens = sum(r.max_new_tokens for r in zreqs)

    def zamba_params(cfg):
        """Weights from SEED, lora_b, A_log and dt_bias perturbed."""
        return perturb_hybrid(build_model(cfg).init_params(
            torch.Generator(device=dev).manual_seed(SEED)), dev)

    zparams = zamba_params(zcfg)
    print(f"[hybrid] {zcfg.name} whole: {zcfg.num_layers} Mamba2 layers in "
          f"{Gz} groups of {zcfg.shared_attn_every} + "
          f"{zcfg.num_layers - Gz * zcfg.shared_attn_every} tail, shared "
          f"attention H={zcfg.num_heads} KVH={zcfg.num_kv_heads} "
          f"hd={zcfg.head_dim}: {zcfg.param_count() / 1e9:.2f} B parameters "
          f"({2 * zcfg.param_count() / 1e9:.1f} GB in bf16); lora_b, A_log, "
          f"dt_bias perturbed")
    check(not ServingEngine(build_model(zcfg), zparams, max_batch=1,
                            max_seq=16, paged=True).paged,
          "hybrid: an engine asked for pages is paged")
    z_launch, z_streams = {}, {}
    for mode in ("batched", "async"):
        torch.cuda.reset_peak_memory_stats(dev)
        reset(*kernel_fns.values())
        zout = serve_demo(zcfg, max_batch=8, max_seq=1024, device="cuda",
                          admit_mode=mode, params=zparams, **serve_kw)
        zl = {k: f.launches for k, f in kernel_fns.items() if f.launches}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        zsites = zout["per_site"]
        check(zout["completed"] == zout["submitted"] == 16
              and set(zout["tokens"]) == {r.rid for r in zreqs},
              f"hybrid {mode}: served {zout['completed']}/"
              f"{zout['submitted']}")
        chunks = sum(s["extend_chunks"] for s in zsites)
        steps = sum(s["decode_steps"] for s in zsites)
        prefills = sum(s["prefill_calls"] for s in zsites) - chunks
        want_l = {"flash_attention": Gz * prefills,
                  "decode_attention": Gz * steps}
        check(zl == want_l and all(want_l.values()),
              f"hybrid {mode}: launches {zl} != {want_l} ({prefills} prefill "
              f"calls, {chunks} extend chunks, {steps} decode steps)")
        served_z = sum(s["served_tokens"] for s in zsites)
        check(served_z == z_tokens, f"hybrid {mode}: served {served_z} "
              f"tokens, not {z_tokens}")
        z_launch[mode], z_streams[mode] = zl, zout["tokens"]
        same = sum(zout["tokens"][k] == z_streams["batched"][k]
                   for k in z_streams["batched"])
        print(f"[hybrid] {zcfg.name} {mode} bf16: 16/16 requests, {served_z} "
              f"tokens in {zout['wall_seconds']:.3f} s "
              f"({served_z / zout['wall_seconds']:.1f} tok/s), "
              f"{prefills + chunks + steps} model calls ({prefills} prefill, "
              f"{chunks} extend, {steps} decode), peak memory {peak_gb:.2f} "
              f"GB; launches {zl} (kernels 3-7: 0); streams equal to the "
              f"batched run's: {same} of 16")
        for i, s in enumerate(zsites):
            print(f"  site {i}: prefill calls "
                  f"{s['prefill_calls'] - s['extend_chunks']}, extend chunks "
                  f"{s['extend_chunks']}, decode steps {s['decode_steps']}, "
                  f"TTFT mean {s['mean_ttft'] * 1e3:.1f} / p99 "
                  f"{s['p99_ttft'] * 1e3:.1f} ms, TBT mean "
                  f"{s['mean_tbt'] * 1e3:.2f} / p99 {s['p99_tbt'] * 1e3:.2f} "
                  f"ms")
        torch.cuda.empty_cache()
    for name in ("flash_attention", "decode_attention"):
        zamba_entries[name]["launches"] = z_launch["batched"][name]

    # request 0 through a prefill of its largest power of 2 below its
    # length, the rest as descending power-of-2 extend chunks and two greedy
    # decode steps (the kernel path's tokens fed to every run), kernel path
    # vs plain path; the share of (token, SSM head) pairs of the prefill
    # whose dt * A reaches the decay clamp is counted over every layer. At
    # bf16 the 81 recurrent layers re-round their outputs and carry the
    # rounding through the prompt, and this random model's logits (std ~1)
    # decorrelate under one rounding's difference: the plain path differs
    # from itself, with the SSD at 16-token chunks in place of 32 (the same
    # math, the same calls), by as much as from the kernel path. As for
    # rwkv6 (phase 6) the kernel path is held within SPREAD_FACTOR_BF16
    # times that spread (the bound at least LOGIT_BOUND); the whole model
    # at fp32 then holds the kernel path to LOGIT_BOUND_FP32 with argmax
    # equal at every call, and carries the int8 segment
    zprompt = torch.as_tensor(zreqs[0].prompt[None, :], device=dev)
    S0 = zprompt.shape[1]
    zbucket = 1 << ((S0 - 1).bit_length() - 1)
    chunked, clamp = M2.ssd_chunked, []

    def counting(x, dt_v, Bm, Cm, A, state0, chunk=M2.CHUNK):
        clamp.append(float((dt_v.float() * A >= -M2.LOG_A_MIN).float()
                           .mean()))
        return chunked(x, dt_v, Bm, Cm, A, state0, chunk)

    def zamba_admit(m, params, toks):
        logits, pre = m.prefill_fn(params, {"tokens": zprompt[:, :zbucket]})
        cache = T.make_decode_cache(m.cfg, 1, 1024, dev)
        insert_cache_rows(cache, pre, numpy.zeros(1, numpy.int32))
        del pre
        seq, done = [logits], zbucket
        while done < S0:
            C = 1 << ((S0 - done).bit_length() - 1)
            logits, cache = m.extend_fn(
                params, {"tokens": zprompt[:, done:done + C]}, cache)
            seq.append(logits)
            done += C
        for i in range(2):
            if len(toks) == i:
                toks.append(logits.argmax(-1).to(torch.int32))
            logits, cache = m.decode_fn(params, {"token": toks[i]}, cache)
            seq.append(logits)
        return seq

    def max_diffs(xs, ys):
        return [(a.float() - b.float()).abs().max().item()
                for a, b in zip(xs, ys)]

    amax = lambda seq: [int(a.argmax()) for a in seq]
    ztoks = []
    with torch.no_grad():
        M2.ssd_chunked = counting
        try:
            got = zamba_admit(build_model(zcfg), zparams, ztoks)
        finally:
            M2.ssd_chunked = chunked
        want = zamba_admit(build_model(zcfg, reference=True), zparams, ztoks)
        chunk0 = M2.CHUNK
        M2.set_ssd_chunk(16)
        try:
            alt = zamba_admit(build_model(zcfg, reference=True), zparams,
                              ztoks)
        finally:
            M2.set_ssd_chunk(chunk0)
    torch.cuda.synchronize()
    check(all(a.shape == (1, zcfg.vocab_size)
              and bool(torch.isfinite(a).all()) for a in got),
          "hybrid: logits shape or non-finite")
    errs, spreads = max_diffs(got, want), max_diffs(alt, want)
    lbound = max(LOGIT_BOUND, SPREAD_FACTOR_BF16 * max(spreads))
    check(max(errs) <= lbound, f"hybrid: logits differ by {max(errs):.3g} "
          f"(bound {lbound:.3g})")
    print(f"[hybrid] request 0 (prompt {S0} tokens) at bf16: prefill of "
          f"{zbucket}, {len(got) - 3} extend chunks and 2 decode steps, "
          f"kernel path vs plain path max |logit diff| per call "
          f"{[round(e, 4) for e in errs]} (bound {lbound:.4g}); plain path "
          f"with 16-token SSD chunks vs 32: {[round(e, 4) for e in spreads]}"
          f"; logit std {want[0].float().std().item():.3f}; argmax kernel "
          f"{amax(got)}, plain {amax(want)}, plain at 16 {amax(alt)}; "
          f"(token, SSM head) pairs of the prefill at the decay clamp: "
          f"{min(clamp[:zcfg.num_layers]):.3f}-"
          f"{max(clamp[:zcfg.num_layers]):.3f} by layer")
    del zparams, got, want, alt
    torch.cuda.empty_cache()

    # the whole model at fp32 (27.1 GB), the same perturbations: request 0
    # as above, kernel path vs plain path within LOGIT_BOUND_FP32 and argmax
    # equal at every call; then an int8 attn cache at B=4
    # (make_decode_cache(dtype="int8"), the only way the reference reaches
    # int8 for the hybrid) filled by a 256- and a 32-token extend chunk
    # (plain PyTorch), then 4 decode steps through kernel 3, the kernel
    # path and the plain path each on its own cache
    zcfg32w = dataclasses.replace(zcfg, dtype="float32")
    zp32w = zamba_params(zcfg32w)
    ztoks = []
    with torch.no_grad():
        got = zamba_admit(build_model(zcfg32w), zp32w, ztoks)
        want = zamba_admit(build_model(zcfg32w, reference=True), zp32w,
                           ztoks)
    errs = max_diffs(got, want)
    check(all(bool(torch.isfinite(a).all()) for a in got)
          and max(errs) <= LOGIT_BOUND_FP32 and amax(got) == amax(want),
          f"hybrid fp32: logits differ by {max(errs):.3g} (bound "
          f"{LOGIT_BOUND_FP32}) or argmax {amax(got)} != {amax(want)}")
    print(f"[hybrid] request 0 at fp32, the whole model: kernel path vs "
          f"plain path max |logit diff| per call {[f'{e:.2e}' for e in errs]}"
          f" (bound {LOGIT_BOUND_FP32}), argmax equal at all {len(got)} "
          f"calls: {amax(got)}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    del got, want
    B8z, S8z, C8z, steps8z = 4, 256, 32, 4
    toks8z = torch.randint(0, zcfg.vocab_size, (B8z, S8z + C8z + steps8z),
                           generator=g_zam, device=dev).to(torch.int32)

    def zamba_int8_run(m):
        cache = T.make_decode_cache(zcfg32w, B8z, 1024, dev, dtype="int8")
        out = []
        for a, b in ((0, S8z), (S8z, S8z + C8z)):
            logits, cache = m.extend_fn(zp32w, {"tokens": toks8z[:, a:b]},
                                        cache)
            out.append(logits)
        for i in range(steps8z):
            logits, cache = m.decode_fn(
                zp32w, {"token": toks8z[:, S8z + C8z + i]}, cache)
            out.append(logits)
        return out

    with torch.no_grad():
        reset(*kernel_fns.values())
        got = zamba_int8_run(build_model(zcfg32w))
        torch.cuda.synchronize()
        k8 = {k: f.launches for k, f in kernel_fns.items() if f.launches}
        want = zamba_int8_run(build_model(zcfg32w, reference=True))
    check(k8 == {"decode_attention_int8": Gz * steps8z},
          f"hybrid int8: launches {k8} != {{decode_attention_int8: {Gz} x "
          f"{steps8z}}}")
    zamba_entries["decode_attention_int8"]["launches"] = k8[
        "decode_attention_int8"]
    errs = max_diffs(got, want)
    check(all(bool(torch.isfinite(a).all()) for a in got)
          and max(errs) <= LOGIT_BOUND_FP32, f"hybrid int8: logits differ "
          f"by {max(errs):.3g} > {LOGIT_BOUND_FP32}")
    print(f"[hybrid] int8 attn cache at B={B8z}, fp32 model: extends of "
          f"{S8z} and {C8z}, then {steps8z} decode steps: launches {k8}; "
          f"kernel path vs plain path max |logit diff| per call "
          f"{[f'{e:.2e}' for e in errs]} (bound {LOGIT_BOUND_FP32})")
    del zp32w, got, want
    torch.cuda.empty_cache()

    # a 7-layer fp32 copy at full width (one group and one tail layer,
    # 4.1 GB), the same perturbations, served: the kernel path's greedy
    # streams are the plain path's, and the plain path launches no kernel
    zcfg32 = dataclasses.replace(zcfg, num_layers=7, dtype="float32")
    zp32 = zamba_params(zcfg32)
    z32 = {}
    for plain in (False, True):
        reset(*kernel_fns.values())
        o = serve_demo(zcfg32, max_batch=8, max_seq=1024, device="cuda",
                       params=zp32, reference=plain, verbose=False,
                       **serve_kw)
        zl = {k: f.launches for k, f in kernel_fns.items() if f.launches}
        check(o["completed"] == 16, f"hybrid fp32 plain={plain}: "
              f"{o['completed']}")
        check(not zl if plain else set(zl) == {"flash_attention",
                                               "decode_attention"},
              f"hybrid fp32 plain={plain}: launches {zl}")
        z32[plain] = o["tokens"]
    check(z32[False] == z32[True], "hybrid fp32 7-layer: kernel path streams "
          "differ from the plain path's: " + str(sum(
              z32[False][r] != z32[True][r] for r in z32[True])))
    print(f"[hybrid] {zcfg32.num_layers}-layer fp32 at full width: kernel "
          f"path and plain path streams equal over 16 requests "
          f"({sum(len(t) for t in z32[False].values())} tokens)")
    del zp32
    torch.cuda.empty_cache()
    print(f"[hybrid] card: {smi}")

    # -------------------------------------------------------- 12. trainer
    launches.update(trainer(dev, smi))

    # ---------------------------------------------------- 13. moe trainer
    launches.update(moe_trainer(dev, smi))

    # ------------------------------------------------- 14. encdec trainer
    encdec_trainer(dev, smi)

    # ---------------------------------------------------- 15. ssm trainer
    launches.update(ssm_trainer(dev, smi, rows["wkv6_bwd"]["ms"]))

    # ------------------------------------------------- 16. hybrid trainer
    hybrid_trainer(dev, smi, extra_shapes)

    # ---------------------------------------------------- 17. vlm trainer
    vlm_trainer(dev, smi, extra_shapes)

    # ---------------------------------------------------------- report
    # the backward kernels replace no TPU kernel (the reference takes
    # attention's gradient from XLA): each names kernel 1, whose backward
    # it is
    port_only = {"flash_attention_bwd_dot", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq"}
    expert_bwd = {"expert_matmul_bwd_dx", "expert_matmul_bwd_dw"}
    src = {"flash_attention": ("flash_attention.py:96", "flash_attention"),
           **{k: ("flash_attention.py:96", "flash_attention")
              for k in port_only},
           **{k: ("grouped_matmul.py:56", "expert_matmul")
              for k in expert_bwd},
           "decode_attention": ("decode_attention.py:92", "decode_attention"),
           "decode_attention_int8": ("decode_attention.py:139",
                                     "decode_attention_int8"),
           "paged_decode_attention": ("decode_attention.py:263",
                                      "paged_decode_attention"),
           "paged_decode_attention_int8": ("decode_attention.py:263",
                                           "paged_decode_attention"),
           "paged_extend_attention": ("flash_attention.py:209",
                                      "paged_extend_attention"),
           "expert_matmul": ("grouped_matmul.py:56", "expert_matmul"),
           "wkv6": ("wkv6.py:74", "wkv6"),
           "wkv6_bwd": ("wkv6.py:74", "wkv6")}
    csrc = {"paged_decode_attention_int8": "paged_decode_attention",
            **{k: "flash_attention_bwd" for k in port_only},
            **{k: "expert_matmul_bwd" for k in expert_bwd}}
    table = []
    for name, r in rows.items():
        tpu_line, fn = src[name]
        table.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/"
                      f"{csrc.get(name, name)}.cu",
            "replaces": f"src/repro/kernels/{tpu_line}",
            "tpu_source": f"src/repro/kernels/{tpu_line.split(':')[0]}:{fn}",
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "other_shapes": extra_shapes.get(name, [])})
        if name in port_only:
            table[-1]["note"] = (
                "port-only backward of kernel 1: no TPU kernel computes it "
                "(the reference differentiates XLA attention, "
                "src/repro/models/layers.py:137)")
        if name in expert_bwd:
            table[-1]["note"] = (
                "port-only backward of kernel 6: no TPU kernel computes it "
                "(the reference differentiates the expert FFN's einsums in "
                "XLA, src/repro/models/moe.py:64)")
        if name == "wkv6_bwd":
            table[-1]["passes"] = {
                p: {"launches": launches["wkv6_bwd_passes"][p], "ms": t}
                for p, t in r["passes_ms"].items()}
            table[-1]["note"] = (
                "port-only backward of kernel 7: the reference "
                "differentiates wkv6_chunked in XLA, "
                "src/repro/models/rwkv6.py:97")
    print(smi)                        # the card, as nvidia-smi gives it
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
