"""The hand-written CUDA kernels against their plain PyTorch versions, and
the model's kernel path against its plain path, on the card.

Marked ``cuda``: every test skips where there is no GPU (the kernels have
no CPU mode). This file imports neither JAX nor the reference package, so
it runs on a machine that has only PyTorch for CUDA and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: bf16 outputs round once to 8 mantissa bits on each side, so
2e-2 (abs + rel); fp32 differs only in the order of sums of up to 1024
products and in fused multiply-adds, so 2e-5. The int8 kernels dequantize
in fp32 as their plain versions do, so they are held to the same bounds.
The expert GEMM sums up to 4096 fp32 products (2e-5 still holds at unit-
variance inputs scaled by 1/sqrt(D)); the WKV6 kernel reads bf16 inputs
but computes and writes fp32, so it is held to 2e-5 at both dtypes. The
backward kernels (kernel 1's and kernel 6's) are also held by the
relative norm of their error over a whole output, ||kernel - plain|| /
||plain|| (1e-2 at bf16: a few units of its 2^-9 rounding; 1e-5 at fp32),
which bounds the bulk where the abs + rel bound holds each element.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs import (get_config, llama32_1b, phi35_moe_42b,
                                 reduced, rwkv6_1b6)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention_int8 import decode_attention_int8
from repro_torch.kernels.expert_matmul import expert_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels import paged_decode_attention as PD
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_int8)
from repro_torch.kernels import paged_extend_attention as PE
from repro_torch.kernels import wkv6 as W6
from repro_torch.kernels.paged_extend_attention import paged_extend_attention
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import layers as Lyr
from repro_torch.models import transformer as T
from repro_torch.models.api import build

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd,causal,prefix", [
    (2, 5, 5, 32, 8, 64, True, 0),
    (2, 300, 300, 32, 8, 64, True, 0),
    (1, 77, 77, 32, 8, 128, True, 0),
    (2, 130, 130, 32, 8, 64, True, 40),
    (1, 33, 33, 6, 2, 64, True, 0),       # G = 3
    (1, 40, 70, 8, 1, 64, False, 0),      # G = 8, Sq != Sk, bidirectional
    (4, 512, 512, 32, 8, 64, True, 0),    # llama3.2-1b's largest bucket
    (4, 512, 512, 32, 8, 128, True, 0),   # phi3.5-moe's heads
    (2, 200, 200, 32, 8, 64, True, 70),   # Sq % 64 != 0, prefix past a tile
    (1, 150, 150, 32, 8, 128, True, 100),
    (4, 512, 512, 40, 8, 128, True, 0),   # qwen3-14b: G = 5
    (8, 160, 160, 16, 16, 64, False, 0),  # seamless encoder: G = 1
    (8, 64, 160, 16, 16, 64, False, 0),   # seamless cross-attention chunk
    (2, 1, 160, 16, 16, 64, False, 0),    # a 1-token cross-attention chunk
    # paligemma-3b: hd 256, G = 8 over one KV head; prefix 9 (inside the
    # first 32-key tile), none, and its 256 patches before a text bucket
    (2, 100, 100, 8, 1, 256, True, 9),
    (2, 77, 77, 8, 1, 256, True, 0),
    (1, 320, 320, 8, 1, 256, True, 256),
])
def test_flash_kernel_matches_plain(gen, dtype, B, Sq, Sk, H, KVH, hd,
                                    causal, prefix):
    q = _rnd(gen, (B, Sq, H, hd), dtype)
    k, v = (_rnd(gen, (B, Sk, KVH, hd), dtype) for _ in range(2))
    got = flash_attention(q, k, v, causal=causal, prefix_len=prefix)
    want = ref.attention_ref(q, k, v, causal=causal, prefix_len=prefix)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_flash_kernel_takes_strided_views(gen):
    """q/k/v as they come out of one fused projection: strided views."""
    B, S, H, KVH, hd = 2, 50, 32, 8, 64
    qkv = _rnd(gen, (B, S, (H + 2 * KVH) * hd), torch.bfloat16)
    q = qkv[..., :H * hd].view(B, S, H, hd)
    k = qkv[..., H * hd:(H + KVH) * hd].view(B, S, KVH, hd)
    v = qkv[..., (H + KVH) * hd:].view(B, S, KVH, hd)
    torch.testing.assert_close(
        flash_attention(q, k, v).float(),
        ref.attention_ref(q, k, v).float(), **TOL[torch.bfloat16])


@pytest.mark.parametrize("hd", [64, 256])
def test_flash_kernel_takes_unaligned_rows(gen, hd):
    """Row starts off the 16-byte grid (a view one element into its
    storage) go through the kernel's scalar loads, with the same result."""
    B, S, H, KVH = 2, 70, 8, 2
    buf = _rnd(gen, (B, S, (H + 2 * KVH) * hd + 1), torch.bfloat16)
    q = buf[..., 1:1 + H * hd].view(B, S, H, hd)
    k = buf[..., 1 + H * hd:1 + (H + KVH) * hd].view(B, S, KVH, hd)
    v = buf[..., 1 + (H + KVH) * hd:].view(B, S, KVH, hd)
    assert q.data_ptr() % 16 and q.stride(1) % 8
    torch.testing.assert_close(
        flash_attention(q, k, v, prefix_len=9).float(),
        ref.attention_ref(q, k, v, prefix_len=9).float(),
        **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,prefix", [(64, 0), (128, 80)])
def test_flash_kernel_rows_do_not_depend_on_the_batch(gen, dtype, hd, prefix):
    """Batch element 0 of a B=4 call equals the B=1 call bit for bit."""
    S, H, KVH = 200, 32, 8
    q = _rnd(gen, (4, S, H, hd), dtype)
    k, v = (_rnd(gen, (4, S, KVH, hd), dtype) for _ in range(2))
    whole = flash_attention(q, k, v, prefix_len=prefix)
    one = flash_attention(q[:1], k[:1], v[:1], prefix_len=prefix)
    assert torch.equal(whole[:1], one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KVH,hd,lengths", [
    (4, 1024, 32, 8, 64, (1, 333, 1024, 1031)),
    (4, 1024, 32, 8, 128, (1, 333, 1024, 1031)),
    (2, 64, 8, 1, 64, (64, 5)),           # G = 8: two blocks per KV head
    (3, 50, 6, 2, 64, (0, 49, 50)),       # G = 3; length 0 gives 0
    (8, 160, 16, 16, 64, (160,) * 8),     # seamless cross-attention decode
    (4, 1024, 40, 8, 128, (1, 333, 1024, 1031)),   # qwen3-14b: G = 5
    (4, 1024, 32, 32, 128, (1, 333, 1024, 1031)),  # deepseek-7b: G = 1
    (4, 1024, 8, 1, 256, (1, 333, 1024, 1031)),    # paligemma-3b: G = 8
])
def test_decode_kernel_matches_plain(gen, dtype, B, S, H, KVH, hd, lengths):
    q = _rnd(gen, (B, H, hd), dtype)
    kc, vc = (_rnd(gen, (B, S, KVH, hd), dtype) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = decode_attention(q, kc, vc, lens)
    want = ref.decode_attention_ref(q, kc, vc, lens)
    live = lens > 0        # the plain version spreads a length-0 row evenly
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])
    assert (got[~live] == 0).all()


def test_model_kernel_path_matches_plain_path(gen):
    """prefill + decode at fp32 through the kernels vs the plain versions."""
    cfg = reduced(llama32_1b, num_kv_heads=2, head_dim=64, dtype="float32")
    params = build(cfg).init_params(gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 37), generator=gen,
                         device="cuda")
    out = {}
    for reference in (False, True):
        m = build(cfg, reference=reference)
        lp, cache = m.prefill_fn(params, {"tokens": toks})
        full = {"kv": {n: torch.zeros((cfg.num_layers, 2, 64,
                                       cfg.num_kv_heads, 64),
                                      device="cuda") for n in ("k", "v")},
                "pos": cache["pos"].clone()}
        for n in ("k", "v"):
            full["kv"][n][:, :, :37] = cache["kv"][n]
        ld, _ = m.decode_fn(params, {"token": lp.argmax(-1)}, full)
        out[reference] = (lp, ld)
    for a, b in zip(out[False], out[True]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _pools(gen, P, page, KVH, hd, dtype):
    """Random page pools [P + 1, page, KVH, hd] (the last is the trash
    page) and, for int8, their fp32 scales [P + 1, page, KVH]."""
    if dtype != torch.int8:
        return [_rnd(gen, (P + 1, page, KVH, hd), dtype) for _ in range(2)]
    out = []
    for _ in range(2):
        out += list(Lyr.quantize_kv(_rnd(gen, (P + 1, page, KVH, hd),
                                         torch.float32)))
    return out[0], out[2], out[1], out[3]


def _heads(hd):
    """(H, KVH) of the cases at ``hd``: paligemma-3b's 8 heads over one
    KV head at hd 256, llama3.2-1b's 32 over 8 otherwise."""
    return (8, 1) if hd == 256 else (32, 8)


def _table(gen, B, W, P, sentinel_rows=()):
    perm = torch.randperm(P, generator=gen, device="cuda")[:B * W]
    table = perm.reshape(B, W).to(torch.int32)
    for b in sentinel_rows:
        table[b] = P
    return table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H,KVH", [(64, 32, 8), (128, 32, 8),
                                      (128, 40, 8), (128, 32, 32),
                                      (256, 8, 1)])
def test_paged_decode_kernel_matches_plain(gen, dtype, hd, H, KVH):
    """Rows of every kind: short, page-aligned, past the table's width, and
    all sentinel with a length (a free slot), which reads the trash page
    on both sides; at G = 4, 5 (qwen3-14b), 1 (deepseek-7b) and 8 over
    one KV head at hd 256 (paligemma-3b)."""
    B, page, P, W = 6, 16, 512, 64
    q = _rnd(gen, (B, H, hd), dtype)
    kp, vp = _pools(gen, P, page, KVH, hd, dtype)
    table = _table(gen, B, W, P, sentinel_rows=(4,))
    lens = torch.tensor([1, 16, 333, 1024, 40, 5000], dtype=torch.int32,
                        device="cuda")
    for w in (W, 8):
        t = table[:, :w]
        got = paged_decode_attention(q, kp, vp, t, lens)
        want = ref.paged_decode_attention_ref(q, kp, vp, t, lens)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("hd", [64, 256])
def test_paged_decode_int8_kernel_matches_plain(gen, dtype, fresh, hd):
    (H, KVH), B, page, P, W = _heads(hd), 5, 16, 320, 64
    q = _rnd(gen, (B, H, hd), dtype)
    kp, vp, ks, vs = _pools(gen, P, page, KVH, hd, torch.int8)
    table = _table(gen, B, W, P, sentinel_rows=(3,))
    lens = torch.tensor([1, 17, 1000, 77, 4096], dtype=torch.int32,
                        device="cuda")
    kn, vn = ((_rnd(gen, (B, KVH, hd), dtype) for _ in range(2)) if fresh
              else (None, None))
    got = paged_decode_attention_int8(q, kp, vp, ks, vs, table, lens,
                                      k_new=kn, v_new=vn)
    want = ref.paged_decode_attention_ref(q, kp, vp, table, lens,
                                          k_scale=ks, v_scale=vs, k_new=kn,
                                          v_new=vn)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_decode_int8_kernel_matches_plain(gen, dtype, hd):
    """Dense int8 with the fresh token: lengths 0 (the fresh token alone),
    ragged, full and past the cache."""
    (H, KVH), B, S = _heads(hd), 4, 1024
    q = _rnd(gen, (B, H, hd), dtype)
    kc, ks = Lyr.quantize_kv(_rnd(gen, (B, S, KVH, hd), torch.float32))
    vc, vs = Lyr.quantize_kv(_rnd(gen, (B, S, KVH, hd), torch.float32))
    kn, vn = (_rnd(gen, (B, KVH, hd), dtype) for _ in range(2))
    lens = torch.tensor([0, 333, S, S + 9], dtype=torch.int32, device="cuda")
    got = decode_attention_int8(q, kc, vc, ks, vs, lens, k_new=kn, v_new=vn)
    want = ref.decode_attention_int8_ref(q, kc, vc, ks, vs, lens, kn, vn)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


DECODE_KINDS = ["dense", "dense_int8", "paged", "paged_int8"]


def _decode_inputs(gen, kind, dtype, lengths, cap, hd=64, page=16):
    """Inputs of one decode entry point, B = len(lengths), ``_heads(hd)``:
    dense caches of ``cap`` tokens, or pools behind a [B, cap // page]
    table (one page per table slot, plus the trash page); the int8 kinds
    carry fp32 scales and a fresh token of q's dtype."""
    B, (H, KVH) = len(lengths), _heads(hd)
    x = dict(q=_rnd(gen, (B, H, hd), dtype), table=None, ks=None, vs=None,
             kn=None, vn=None,
             lens=torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    if kind.startswith("dense"):
        shape = (B, cap, KVH, hd)
    else:
        W = cap // page
        shape = (B * W + 1, page, KVH, hd)
        x["table"] = _table(gen, B, W, B * W)
    if kind.endswith("int8"):
        x["k"], x["ks"] = Lyr.quantize_kv(_rnd(gen, shape, torch.float32))
        x["v"], x["vs"] = Lyr.quantize_kv(_rnd(gen, shape, torch.float32))
        x["kn"], x["vn"] = (_rnd(gen, (B, KVH, hd), dtype) for _ in range(2))
    else:
        x["k"], x["v"] = (_rnd(gen, shape, dtype) for _ in range(2))
    return x


def _decode(kind, x, rows=slice(None), width=None, plain=False):
    """The kernel of ``kind`` (or its plain version) on batch rows
    ``rows``, through the first ``width`` table columns if given."""
    def pick(name):
        t = x[name]
        return None if t is None else t[rows]
    q, lens, kn, vn = pick("q"), pick("lens"), pick("kn"), pick("vn")
    if kind == "dense":
        fn = ref.decode_attention_ref if plain else decode_attention
        return fn(q, pick("k"), pick("v"), lens)
    if kind == "dense_int8":
        if plain:
            return ref.decode_attention_int8_ref(q, pick("k"), pick("v"),
                                                 pick("ks"), pick("vs"),
                                                 lens, kn, vn)
        return decode_attention_int8(q, pick("k"), pick("v"), pick("ks"),
                                     pick("vs"), lens, k_new=kn, v_new=vn)
    table = pick("table")[:, :width]
    if plain:
        return ref.paged_decode_attention_ref(
            q, x["k"], x["v"], table, lens, k_scale=x["ks"],
            v_scale=x["vs"], k_new=kn, v_new=vn)
    if kind == "paged":
        return paged_decode_attention(q, x["k"], x["v"], table, lens)
    return paged_decode_attention_int8(q, x["k"], x["v"], x["ks"], x["vs"],
                                       table, lens, k_new=kn, v_new=vn)


def _decode_plan(kind, dtype, cap, hd=64, page=16):
    cdtype = torch.int8 if kind.endswith("int8") else dtype
    if kind.startswith("dense"):
        return PD.plan(cdtype, hd, 32, 8, 1, cap)
    return PD.plan(cdtype, hd, 32, 8, cap // page, page)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_decode_kernels_rows_do_not_depend_on_the_batch(gen, kind, dtype):
    """Kernels 2, 3, 4 and 4-int8: row 2 alone (B=1) equals row 2 of a
    B=8 call bit for bit, and of a second B=8 call where every other
    row's length differs."""
    x = _decode_inputs(gen, kind, dtype,
                       [5, 77, 1000, 1024, 0, 300, 12, 640], cap=1024)
    one = _decode(kind, x, rows=slice(2, 3))
    for lens in ([5, 77, 1000, 1024, 0, 300, 12, 640],
                 [900, 3, 1000, 0, 512, 1, 1024, 64]):
        x["lens"] = torch.tensor(lens, dtype=torch.int32, device="cuda")
        assert torch.equal(_decode(kind, x)[2:3], one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["paged", "paged_int8"])
def test_paged_decode_kernel_bits_do_not_depend_on_the_table_width(
        gen, kind, dtype):
    """A row of length 300 gives the same bits through a 32-column and a
    64-column table (page 16): 4 and 8 splits of 128 keys."""
    x = _decode_inputs(gen, kind, dtype, [300, 17, 512, 129], cap=1024)
    plans = [_decode_plan(kind, dtype, w * 16) for w in (32, 64)]
    assert [p["splits"] for p in plans] == [4, 8]
    assert {p["split_len"] for p in plans} == {128}
    assert torch.equal(_decode(kind, x, width=32), _decode(kind, x, width=64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", DECODE_KINDS)
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_decode_kernels_long_rows_take_several_splits(gen, kind, dtype, hd):
    """At 1024 keys of capacity every kernel cuts a row into 8 clusters'
    splits of 128 keys; rows near, at and past the capacity, and one split
    boundary, match the plain version."""
    assert _decode_plan(kind, dtype, 1024, hd)["splits"] == 8
    x = _decode_inputs(gen, kind, dtype, [1024, 1023, 129, 2000], cap=1024,
                       hd=hd)
    torch.testing.assert_close(_decode(kind, x).float(),
                               _decode(kind, x, plain=True).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_decode_kernels_above_eight_splits_of_128_keys(gen, kind, dtype):
    """Capacity 4096 (dense S=4096; paged W=256 at page 16): 8 splits of
    512 keys, each streamed through the ring in several rounds, match the
    plain version."""
    plan = _decode_plan(kind, dtype, 4096)
    assert (plan["splits"], plan["split_len"]) == (8, 512)
    x = _decode_inputs(gen, kind, dtype, [4096, 4000, 1234, 1], cap=4096)
    torch.testing.assert_close(_decode(kind, x).float(),
                               _decode(kind, x, plain=True).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,hd,H,KVH", [
    (1, 64, 32, 8), (7, 64, 32, 8), (64, 64, 32, 8), (33, 128, 32, 8),
    (256, 128, 32, 8),
    (1, 128, 40, 8), (64, 128, 40, 8),      # qwen3-14b: G = 5
    (1, 128, 32, 32), (64, 128, 32, 32),    # deepseek-7b: G = 1
    (1, 256, 8, 1), (16, 256, 8, 1), (64, 256, 8, 1),   # paligemma-3b
])
def test_paged_extend_kernel_matches_plain(gen, dtype, C, hd, H, KVH):
    """Cached pages below pos, then the chunk's causal triangle; one row
    masked (all sentinel, pos 0) and one with pos past the table."""
    B, page, P, W = 4, 16, 256, 64
    q = _rnd(gen, (B, C, H, hd), dtype)
    kp, vp = _pools(gen, P, page, KVH, hd, dtype)
    kn, vn = (_rnd(gen, (B, C, KVH, hd), dtype) for _ in range(2))
    table = _table(gen, B, W, P, sentinel_rows=(2,))
    pos = torch.tensor([0, 300, 0, 2000], dtype=torch.int32, device="cuda")
    got = paged_extend_attention(q, kp, vp, kn, vn, table, pos)
    want = ref.paged_extend_attention_ref(q, kp, vp, kn, vn, table, pos)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,hd", [(1, 64), (16, 64), (33, 64), (5, 128),
                                  (1, 256), (16, 256)])
def test_paged_extend_kernel_long_rows_take_several_splits(gen, dtype, C, hd):
    """Rows whose pos is at or near the table's width (W * page): at these
    C the bf16 kernel splits every row's keys over a cluster of blocks and
    combines the partials."""
    (H, KVH), B, page, P, W = _heads(hd), 4, 16, 300, 64
    if dtype == torch.bfloat16:
        assert PE.plan(dtype, hd, C, H, KVH, W, page)["splits"] > 1
    q = _rnd(gen, (B, C, H, hd), dtype)
    kp, vp = _pools(gen, P, page, KVH, hd, dtype)
    kn, vn = (_rnd(gen, (B, C, KVH, hd), dtype) for _ in range(2))
    table = _table(gen, B, W, P)
    pos = torch.tensor([W * page, W * page - 1, W * page - 37, 700],
                       dtype=torch.int32, device="cuda")
    got = paged_extend_attention(q, kp, vp, kn, vn, table, pos)
    want = ref.paged_extend_attention_ref(q, kp, vp, kn, vn, table, pos)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 256])
def test_paged_extend_kernel_takes_unaligned_rows(gen, dtype, hd):
    """q/k_new/v_new as views one element into a fused buffer (row starts
    off the 16-byte grid, odd strides) take the kernel's scalar-copy
    instantiation, with the same result."""
    (H, KVH), B, C, page, P, W = _heads(hd), 3, 20, 16, 200, 64
    buf = _rnd(gen, (B, C, (H + 2 * KVH) * hd + 1), dtype)
    q = buf[..., 1:1 + H * hd].view(B, C, H, hd)
    kn = buf[..., 1 + H * hd:1 + (H + KVH) * hd].view(B, C, KVH, hd)
    vn = buf[..., 1 + (H + KVH) * hd:].view(B, C, KVH, hd)
    assert q.data_ptr() % 16 and q.stride(1) % 8
    kp, vp = _pools(gen, P, page, KVH, hd, dtype)
    table = _table(gen, B, W, P)
    for pos in ([0, 1000, 33], [1024, 17, 512]):
        pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
        torch.testing.assert_close(
            paged_extend_attention(q, kp, vp, kn, vn, table, pos).float(),
            ref.paged_extend_attention_ref(q, kp, vp, kn, vn, table,
                                           pos).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,hd", [(1, 64), (16, 64), (64, 64), (33, 128)])
def test_paged_extend_kernel_rows_do_not_depend_on_the_batch(gen, dtype, C,
                                                             hd):
    """Row 2 alone (B=1) equals row 2 of a B=8 call bit for bit, and of a
    second B=8 call where every other row's pos differs."""
    B, H, KVH, page, P, W = 8, 32, 8, 16, 600, 64
    q = _rnd(gen, (B, C, H, hd), dtype)
    kp, vp = _pools(gen, P, page, KVH, hd, dtype)
    kn, vn = (_rnd(gen, (B, C, KVH, hd), dtype) for _ in range(2))
    table = _table(gen, B, W, P)
    pos = torch.tensor([5, 77, 1000, 1024, 0, 300, 12, 640],
                       dtype=torch.int32, device="cuda")
    other = torch.tensor([900, 3, 1000, 0, 512, 1, 1024, 64],
                         dtype=torch.int32, device="cuda")
    one = paged_extend_attention(q[2:3], kp, vp, kn[2:3], vn[2:3],
                                 table[2:3], pos[2:3])
    for p in (pos, other):
        whole = paged_extend_attention(q, kp, vp, kn, vn, table, p)
        assert torch.equal(whole[2:3], one)


@pytest.mark.parametrize("kind", ["paged", "int8", "paged_int8"])
def test_model_paged_and_int8_kernel_paths_match_plain_path(gen, kind):
    """extend + decode at fp32 over paged and int8 caches, through the
    kernels vs through the plain versions."""
    cfg = reduced(llama32_1b, num_kv_heads=2, head_dim=64, dtype="float32")
    params = build(cfg).init_params(gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 21), generator=gen,
                         device="cuda")
    out = {}
    for reference in (False, True):
        m = build(cfg, reference=reference)
        dtype = "int8" if "int8" in kind else None
        if "paged" in kind:
            cache = T.make_paged_decode_cache(cfg, 2, 64, "cuda",
                                              page_size=16, dtype=dtype)
            cache["table"] = torch.tensor([[3, 0, 6, 1], [5, 2, 7, 4]],
                                          dtype=torch.int32, device="cuda")
        else:
            cache = T.make_decode_cache(cfg, 2, 64, "cuda", dtype=dtype)
        le, cache = m.extend_fn(params, {"tokens": toks}, cache)
        ld, _ = m.decode_fn(params, {"token": le.argmax(-1).to(torch.int32)},
                            cache)
        out[reference] = (le, ld)
    for a, b in zip(out[False], out[True]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F,fill", [
    (16, 8, 4096, 640, [0, 2, 1, 1, 2, 0, 1, 0, 1, 1, 1, 2, 1, 0, 1, 2]),
    (4, 70, 200, 300, [0, 5, 64, 70]),       # ragged C, D, F; partial tile
    (3, 130, 256, 128, None),                 # fill defaults to C
])
def test_expert_matmul_kernel_matches_plain(gen, dtype, E, C, D, F, fill):
    xe = _rnd(gen, (E, C, D), dtype)
    w = (_rnd(gen, (E, D, F), torch.float32) / D ** 0.5).to(dtype)
    f = None if fill is None else torch.tensor(fill, dtype=torch.int32,
                                               device="cuda")
    got = expert_matmul(xe, w, f)
    want = ref.expert_matmul_ref(xe, w, f)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if f is not None:
        rows = torch.arange(C, device="cuda")[None, :]
        assert (got[rows.expand(E, C) >= f[:, None]] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("small,large,exact", [
    (1, 8, True),         # both at or below the decode threshold (C <= 16)
    (256, 2048, True),    # both above it
    (8, 256, False),      # across it: another tiling, the same function
])
def test_expert_matmul_rows_do_not_depend_on_the_bucket(gen, dtype, small,
                                                        large, exact):
    """A live row's result is the same in a small bucket and in a larger
    one whose other rows and fills differ: bit for bit on one side of the
    decode/prefill threshold, to the dtype's tolerance across it."""
    E, D, F = 4, 512, 384
    w = (_rnd(gen, (E, D, F), torch.float32) / D ** 0.5).to(dtype)
    xs = _rnd(gen, (E, small, D), dtype)
    xl = _rnd(gen, (E, large, D), dtype)
    xl[:, :small] = xs
    fs = torch.tensor([small, small // 2, 0, small], dtype=torch.int32,
                      device="cuda")
    fl = torch.tensor([large, small + (large - small) // 3, large // 2,
                       small], dtype=torch.int32, device="cuda")
    got_s = expert_matmul(xs, w, fs)
    got_l = expert_matmul(xl, w, fl)[:, :small]
    live = torch.arange(small, device="cuda")[None, :] < fs[:, None]
    if exact:
        assert torch.equal(got_s[live], got_l[live])
    else:
        torch.testing.assert_close(got_s[live].float(), got_l[live].float(),
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,logw", [
    (2, 100, 4, 64, None),      # ragged last chunk
    (2, 33, 3, 16, None),
    (1, 64, 2, 64, -1.5),       # the decay clamp over 64 tokens
    (1, 5, 2, 16, None),
    (1, 512, 32, 64, None),     # one long prompt admitted alone
    (2, 1, 32, 64, None),
    (2, 31, 32, 64, None),
    (2, 33, 32, 64, None),
])
def test_wkv6_kernel_matches_plain(gen, dtype, B, S, H, hd, logw):
    r, k, v = (0.5 * _rnd(gen, (B, S, H, hd), dtype) for _ in range(3))
    if logw is None:
        w = -torch.rand((B, S, H, hd), generator=gen, device="cuda") * 1.5
    else:
        w = torch.full((B, S, H, hd), logw, device="cuda")
    u = 0.3 * _rnd(gen, (H, hd), torch.float32)
    s0 = 0.1 * _rnd(gen, (B, H, hd, hd), torch.float32)
    o, s = wkv6(r, k, v, w, u, s0)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    for plain in (ref.wkv6_chunked_ref, ref.wkv6_ref):
        po, ps = plain(r, k, v, w, u, s0)
        torch.testing.assert_close(o, po, **TOL[torch.float32])
        torch.testing.assert_close(s, ps, **TOL[torch.float32])
    # two calls chained through the state equal one call
    o1, s1 = wkv6(r[:, :S // 2].contiguous(), k[:, :S // 2].contiguous(),
                  v[:, :S // 2].contiguous(), w[:, :S // 2].contiguous(), u,
                  s0)
    o2, s2 = wkv6(r[:, S // 2:].contiguous(), k[:, S // 2:].contiguous(),
                  v[:, S // 2:].contiguous(), w[:, S // 2:].contiguous(), u,
                  s1)
    torch.testing.assert_close(torch.cat([o1, o2], 1), o,
                               **TOL[torch.float32])
    torch.testing.assert_close(s2, s, **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_rows_do_not_depend_on_the_batch(gen, dtype):
    """Row 2 alone (B=1, the value columns split over 8 blocks a head)
    equals row 2 of a B=8 call (one block a head) bit for bit."""
    B, S, H, hd = 8, 100, 32, 64
    r, k, v = (0.5 * _rnd(gen, (B, S, H, hd), dtype) for _ in range(3))
    w = -torch.rand((B, S, H, hd), generator=gen, device="cuda") * 1.5
    u = 0.3 * _rnd(gen, (H, hd), torch.float32)
    s0 = 0.1 * _rnd(gen, (B, H, hd, hd), torch.float32)
    assert W6.plan(dtype, hd, 1, H)["slices"] != W6.plan(dtype, hd, B,
                                                         H)["slices"]
    o, s = wkv6(r, k, v, w, u, s0)
    o1, s1 = wkv6(*(t[2:3].contiguous() for t in (r, k, v, w)), u,
                  s0[2:3].contiguous())
    assert torch.equal(o[2:3], o1) and torch.equal(s[2:3], s1)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "rwkv6-1.6b"])
def test_moe_and_rwkv6_kernel_paths_match_plain_path(gen, arch):
    """prefill, extend and decode at fp32 through kernels 6 / 7 (and the
    attention kernels, hd 64) vs the plain versions."""
    base = {"phi3.5-moe-42b-a6.6b": phi35_moe_42b,
            "rwkv6-1.6b": rwkv6_1b6}[arch]
    cfg = reduced(base, d_model=256, head_dim=64, dtype="float32")
    params = build(cfg).init_params(gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 45), generator=gen,
                         device="cuda").to(torch.int32)
    out = {}
    for reference in (False, True):
        m = build(cfg, reference=reference)
        lp, _ = m.prefill_fn(params, {"tokens": toks[:, :32]})
        cache = T.make_decode_cache(cfg, 2, 64, "cuda")
        le, cache = m.extend_fn(params, {"tokens": toks[:, :40]}, cache)
        ld, _ = m.decode_fn(params, {"token": toks[:, 40]}, cache)
        out[reference] = (lp, le, ld)
    for a, b in zip(out[False], out[True]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-14b", "seamless-m4t-medium",
                                  "paligemma-3b"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_new_families_kernel_paths_match_plain_path(gen, arch, paged):
    """prefill, extend and decode at fp32 through the kernels vs the plain
    versions: qk-norm at G = 5 (qwen3-14b, 10 heads over 2); the encoder
    (kernel 1 unmasked over 160 random frames), cross-attention chunks
    (kernel 1, Sq != Sk) and cross-attention decode (kernel 2 at 160 keys a
    row) of seamless-m4t-medium, at hd 64; and paligemma-3b's 8 heads over
    one KV head at hd 256, its prefill through kernel 1 with 40 random
    patches as the bidirectional prefix (past one 32-key tile, not a
    multiple of it)."""
    over = {"qwen3-14b": dict(num_heads=10, num_kv_heads=2),
            "seamless-m4t-medium": dict(num_prefix_embeddings=160),
            "paligemma-3b": dict(num_heads=8, num_kv_heads=1, head_dim=256,
                                 num_prefix_embeddings=40)}[arch]
    cfg = reduced(get_config(arch), **{"d_model": 256, "head_dim": 64,
                                       "dtype": "float32", **over})
    params = build(cfg).init_params(gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 45), generator=gen,
                         device="cuda").to(torch.int32)
    frames = _rnd(gen, (2, 160, cfg.d_model), torch.float32)
    patches = _rnd(gen, (2, 40, cfg.d_model), torch.float32)
    out = {}
    for reference in (False, True):
        m = build(cfg, reference=reference)
        lp, pre = m.prefill_fn(params, {"tokens": toks[:, :32],
                                        "frames": frames,
                                        "patches": patches})
        if paged:
            cache = T.make_paged_decode_cache(cfg, 2, 64, "cuda",
                                              page_size=16)
            cache["table"] = torch.tensor([[3, 0, 6, 1], [5, 2, 7, 4]],
                                          dtype=torch.int32, device="cuda")
        else:
            cache = T.make_decode_cache(cfg, 2, 64, "cuda")
        if "enc_kv" in pre:
            for n in ("k", "v"):
                cache["enc_kv"][n].copy_(pre["enc_kv"][n])
        le, cache = m.extend_fn(params, {"tokens": toks[:, :40]}, cache)
        ld, _ = m.decode_fn(params, {"token": toks[:, 40]}, cache)
        out[reference] = (lp, le, ld)
    for a, b in zip(out[False], out[True]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_async_engine_on_the_card_gives_the_batched_streams(gen, paged):
    """Async admission through the kernels (pending rows masked out of the
    decode) gives the batched engine's streams at fp32, sampled rows
    included."""
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = reduced(llama32_1b, num_kv_heads=2, head_dim=64, dtype="float32")
    params = build(cfg).init_params(gen)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device="cuda").cpu().numpy()
               for n in (8, 45, 5, 30, 17, 9)]
    streams = {}
    for mode in ("batched", "async"):
        eng = ServingEngine(build(cfg), params, max_batch=4, max_seq=64,
                            admit_mode=mode, admit_token_budget=8,
                            paged=paged)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6,
                               temperature=0.7 * (i % 2)))
        m = eng.run()
        assert eng.reconcile()["balanced"]
        streams[mode] = {r.rid: r.tokens for r in m.completed}
    assert len(streams["async"]) == 6
    assert streams["async"] == streams["batched"]


# deepseek-v2's MLA: kernel 1 at q/k 192 over v 128 (its expanded prefill,
# 128 heads over 128 at G = 1), and kernel 6 at 160 experts
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,causal", [
    (2, 77, 77, 8, 8, True),              # G = 1, S not a multiple of 64
    (1, 300, 300, 16, 16, True),
    (2, 50, 130, 8, 2, True),             # G = 4, Sq < Sk
    (2, 90, 90, 8, 8, False),
    (1, 33, 200, 8, 2, False),            # G = 4, Sq < Sk, non-causal
    (4, 128, 128, 128, 128, True),        # deepseek-v2's heads
])
def test_flash_kernel_mla_widths_match_plain(gen, dtype, B, Sq, Sk, H, KVH,
                                             causal):
    q = _rnd(gen, (B, Sq, H, 192), dtype)
    k = _rnd(gen, (B, Sk, KVH, 192), dtype)
    v = _rnd(gen, (B, Sk, KVH, 128), dtype)
    got = flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    assert got.shape == (B, Sq, H, 128)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_flash_kernel_mla_widths_take_unaligned_rows_and_views(gen):
    """q/k at 192 and v at 128 as views one element into their storage
    (the scalar-copy instantiation), and k as MLA builds it: a 128-wide
    part per head beside a 64-wide part shared by every head."""
    B, S, H = 2, 70, 8
    buf = _rnd(gen, (B, S, H * (2 * 192 + 128) + 1), torch.bfloat16)
    q = buf[..., 1:1 + H * 192].view(B, S, H, 192)
    k = buf[..., 1 + H * 192:1 + 2 * H * 192].view(B, S, H, 192)
    v = buf[..., 1 + 2 * H * 192:].view(B, S, H, 128)
    assert q.data_ptr() % 16 and q.stride(1) % 8
    torch.testing.assert_close(flash_attention(q, k, v).float(),
                               ref.attention_ref(q, k, v).float(),
                               **TOL[torch.bfloat16])
    kn, kr = _rnd(gen, (B, S, H, 128), torch.bfloat16), _rnd(
        gen, (B, S, 64), torch.bfloat16)
    k = torch.cat([kn, kr[:, :, None].expand(B, S, H, 64)], dim=-1)
    v = _rnd(gen, (B, S, H, 128), torch.bfloat16)
    q = q.contiguous()
    torch.testing.assert_close(flash_attention(q, k, v).float(),
                               ref.attention_ref(q, k, v).float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_mla_rows_do_not_depend_on_the_batch(gen, dtype):
    S, H = 150, 16
    q, k = (_rnd(gen, (4, S, H, 192), dtype) for _ in range(2))
    v = _rnd(gen, (4, S, H, 128), dtype)
    assert torch.equal(flash_attention(q, k, v)[1:2],
                       flash_attention(q[1:2], k[1:2], v[1:2]))


@pytest.mark.parametrize("kind", DECODE_KINDS + ["extend", "flash"])
def test_kernels_refuse_other_width_pairs(gen, kind):
    """Kernels 2-5 keep refusing head dim 192 (MLA decodes and extends in
    the absorbed form, outside them); kernel 1 takes v narrower than q/k
    only at 192 over 128."""
    if kind in DECODE_KINDS:
        x = _decode_inputs(gen, kind, torch.bfloat16, (5, 9), 64, hd=192)
        with pytest.raises(ValueError, match="192"):
            _decode(kind, x)
        return
    if kind == "extend":
        kp, vp = _pools(gen, 8, 16, 8, 192, torch.bfloat16)
        q = _rnd(gen, (2, 4, 32, 192), torch.bfloat16)
        kn, vn = (_rnd(gen, (2, 4, 8, 192), torch.bfloat16) for _ in range(2))
        with pytest.raises(ValueError, match="192"):
            paged_extend_attention(q, kp, vp, kn, vn, _table(gen, 2, 4, 8),
                                   torch.tensor([3, 0], dtype=torch.int32,
                                                device="cuda"))
        return
    for qd, vd in ((192, 192), (128, 64), (192, 64)):
        q, k = (_rnd(gen, (1, 8, 4, qd), torch.bfloat16) for _ in range(2))
        v = _rnd(gen, (1, 8, 4, vd), torch.bfloat16)
        with pytest.raises(ValueError, match="head dims"):
            flash_attention(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,D,F", [(8, 5120, 1536), (20, 512, 384),
                                   (20, 384, 512)])
def test_expert_matmul_kernel_at_160_experts(gen, dtype, C, D, F):
    """deepseek-v2's 160 experts: empty, partial and full buckets (a
    top-6 decode of 8 tokens fills at most 48 of them), at its gate/up
    width and at small ragged ones."""
    E = 160
    fill = torch.randint(0, C + 1, (E,), generator=gen, device="cuda")
    fill[::3] = 0
    fill[1::7] = C
    fill = fill.to(torch.int32)
    xe = _rnd(gen, (E, C, D), dtype)
    w = (_rnd(gen, (E, D, F), torch.float32) / D ** 0.5).to(dtype)
    got = expert_matmul(xe, w, fill)
    torch.testing.assert_close(got.float(),
                               ref.expert_matmul_ref(xe, w, fill).float(),
                               **TOL[dtype])
    rows = torch.arange(C, device="cuda")[None, :].expand(E, C)
    assert (got[rows >= fill[:, None]] == 0).all()


def test_deepseek_v2_kernel_path_matches_plain_path(gen):
    """One layer of deepseek-v2 at its published width, fp32: a prefill
    through kernel 1 at 192 over 128 and kernel 6 at 160 experts top-6,
    then an absorbed extend and decode (kernel 6 only), against the plain
    versions."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), num_layers=1,
                              dtype="float32")
    params = build(cfg).init_params(gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 45), generator=gen,
                         device="cuda").to(torch.int32)
    out = {}
    for reference in (False, True):
        m = build(cfg, reference=reference)
        flash_attention.launches = expert_matmul.launches = 0
        lp, pre = m.prefill_fn(params, {"tokens": toks[:, :32]})
        cache = T.make_decode_cache(cfg, 2, 64, "cuda")
        for n in ("ckv", "kr"):
            cache["kv"][n][:, :, :32] = pre["kv"][n]
        cache["pos"][:] = 32
        le, cache = m.extend_fn(params, {"tokens": toks[:, 32:40]}, cache)
        ld, _ = m.decode_fn(params, {"token": toks[:, 40]}, cache)
        out[reference] = (lp, le, ld)
        launched = (flash_attention.launches, expert_matmul.launches)
        assert launched == ((0, 0) if reference else (1, 9))
    for a, b in zip(out[False], out[True]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------- hd 112 (zamba2)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,causal,prefix", [
    (4, 512, 512, 32, 32, True, 0),       # zamba2-7b's prefill: G = 1
    (2, 77, 77, 32, 32, True, 0),         # ragged: Sq % 64 != 0
    (3, 1, 1, 4, 4, True, 0),             # one-key rows
    (2, 130, 130, 8, 2, True, 40),        # G = 4, a prefix past a tile
    (1, 40, 70, 8, 8, False, 0),          # Sq != Sk, bidirectional
])
def test_flash_kernel_hd112_matches_plain(gen, dtype, B, Sq, Sk, H, KVH,
                                          causal, prefix):
    """Kernel 1 at hd 112: 14 16-byte chunks a row, copied by the flat
    (row, chunk) index, V fragments 7 at a time (bf16); lanes 16-31 own
    no fourth output column (fp32)."""
    q = _rnd(gen, (B, Sq, H, 112), dtype)
    k, v = (_rnd(gen, (B, Sk, KVH, 112), dtype) for _ in range(2))
    got = flash_attention(q, k, v, causal=causal, prefix_len=prefix)
    want = ref.attention_ref(q, k, v, causal=causal, prefix_len=prefix)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_flash_kernel_hd112_takes_unaligned_rows_and_views(gen):
    """hd 112 rows off the 16-byte grid (scalar copies), and strided
    views of one fused projection (cp.async), batch-independent."""
    B, S, H, KVH, hd = 2, 70, 8, 2, 112
    for off in (1, 0):
        buf = _rnd(gen, (B, S, (H + 2 * KVH) * hd + off), torch.bfloat16)
        q = buf[..., off:off + H * hd].view(B, S, H, hd)
        k = buf[..., off + H * hd:off + (H + KVH) * hd].view(B, S, KVH, hd)
        v = buf[..., off + (H + KVH) * hd:].view(B, S, KVH, hd)
        assert bool(q.data_ptr() % 16) == bool(off)
        got = flash_attention(q, k, v, prefix_len=9)
        torch.testing.assert_close(
            got.float(), ref.attention_ref(q, k, v, prefix_len=9).float(),
            **TOL[torch.bfloat16])
        assert torch.equal(got[1:], flash_attention(q[1:], k[1:], v[1:],
                                                    prefix_len=9))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KVH,lengths", [
    (8, 1024, 32, 32, (1, 7, 333, 1024, 1033, 512, 100, 999)),  # zamba2-7b
    (3, 50, 4, 4, (0, 1, 50)),            # length 0, a one-key row
    (2, 61, 8, 2, (61, 17)),              # G = 4, S off any split length
])
def test_decode_kernel_hd112_matches_plain(gen, dtype, B, S, H, KVH,
                                           lengths):
    """Kernel 2 at hd 112: lanes laid out as at 128, the row's last 16
    columns predicated off."""
    q = _rnd(gen, (B, H, 112), dtype)
    kc, vc = (_rnd(gen, (B, S, KVH, 112), dtype) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = decode_attention(q, kc, vc, lens)
    want = ref.decode_attention_ref(q, kc, vc, lens)
    live = lens > 0
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KVH,lengths", [
    (8, 1024, 32, 32, (0, 7, 333, 1024, 1033, 512, 100, 999)),
    (3, 50, 4, 4, (0, 1, 50)),
])
def test_decode_int8_kernel_hd112_matches_plain(gen, dtype, B, S, H, KVH,
                                                lengths):
    """Kernel 3 at hd 112 (int8 rows of 7 16-byte chunks, padded to 8 in
    shared memory) with the fresh token: lengths 0 (the fresh token
    alone), one key, ragged, full and past the cache."""
    q = _rnd(gen, (B, H, 112), dtype)
    kc, ks = Lyr.quantize_kv(_rnd(gen, (B, S, KVH, 112), torch.float32))
    vc, vs = Lyr.quantize_kv(_rnd(gen, (B, S, KVH, 112), torch.float32))
    kn, vn = (_rnd(gen, (B, KVH, 112), dtype) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = decode_attention_int8(q, kc, vc, ks, vs, lens, k_new=kn, v_new=vn)
    want = ref.decode_attention_int8_ref(q, kc, vc, ks, vs, lens, kn, vn)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["dense", "dense_int8"])
def test_decode_kernels_hd112_rows_do_not_depend_on_the_batch(gen, kind,
                                                             dtype):
    """Kernels 2 and 3 at hd 112 (8 splits of 128 keys at S=1024): row 2
    alone equals row 2 of a B=8 call bit for bit, whatever the other
    rows' lengths."""
    x = _decode_inputs(gen, kind, dtype,
                       [5, 77, 1000, 1024, 0, 300, 12, 640], cap=1024,
                       hd=112)
    assert _decode_plan(kind, dtype, 1024, hd=112)["splits"] == 8
    one = _decode(kind, x, rows=slice(2, 3))
    for lens in ([5, 77, 1000, 1024, 0, 300, 12, 640],
                 [900, 3, 1000, 0, 512, 1, 1024, 64]):
        x["lens"] = torch.tensor(lens, dtype=torch.int32, device="cuda")
        assert torch.equal(_decode(kind, x)[2:3], one)
    # the plain dense version spreads a row of length 0 evenly
    live = (x["lens"] > 0) | (kind == "dense_int8")
    want = _decode(kind, x, plain=True)
    torch.testing.assert_close(_decode(kind, x)[live].float(),
                               want[live].float(), **TOL[dtype])


@pytest.mark.parametrize("kind", ["paged", "paged_int8", "extend"])
def test_paged_kernels_refuse_hd_112(gen, kind):
    """Kernels 4, 4-int8 and 5 are not built at hd 112 (no paged path
    runs it): a CUDA tensor there raises, and launches nothing."""
    before = (paged_decode_attention.launches,
              paged_decode_attention_int8.launches,
              paged_extend_attention.launches)
    with pytest.raises(ValueError, match="112"):
        if kind == "extend":
            kp, vp = _pools(gen, 8, 16, 8, 112, torch.bfloat16)
            q = _rnd(gen, (2, 4, 32, 112), torch.bfloat16)
            kn, vn = (_rnd(gen, (2, 4, 8, 112), torch.bfloat16)
                      for _ in range(2))
            paged_extend_attention(q, kp, vp, kn, vn, _table(gen, 2, 4, 8),
                                   torch.tensor([3, 0], dtype=torch.int32,
                                                device="cuda"))
        else:
            x = _decode_inputs(gen, kind, torch.bfloat16, (5, 9), 64, hd=112)
            _decode(kind, x)
    assert before == (paged_decode_attention.launches,
                      paged_decode_attention_int8.launches,
                      paged_extend_attention.launches)


def test_zamba2_layer_group_kernel_path_matches_plain_path(gen):
    """One group of zamba2-7b at its published width, fp32 (the shared
    attention at hd 112 with its LoRA delta, 6 Mamba2 layers; lora_b and
    the decay perturbed): a prefill through kernel 1, a plain extend and
    two decode steps through kernel 2, against the plain versions."""
    cfg = dataclasses.replace(get_config("zamba2-7b"), num_layers=6,
                              dtype="float32")
    params = build(cfg).init_params(gen)
    sh = params["shared"]
    sh["lora_b"] += 0.02 * _rnd(gen, tuple(sh["lora_b"].shape), torch.float32)
    for p in params["mamba"]:
        p["A_log"] += 0.5 * _rnd(gen, tuple(p["A_log"].shape), torch.float32)
        p["dt_bias"] += _rnd(gen, tuple(p["dt_bias"].shape), torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 42), generator=gen,
                         device="cuda").to(torch.int32)
    out = {}
    for reference in (False, True):
        m = build(cfg, reference=reference)
        flash_attention.launches = decode_attention.launches = 0
        lp, pre = m.prefill_fn(params, {"tokens": toks[:, :32]})
        cache = T.make_decode_cache(cfg, 2, 64, "cuda")
        for n in ("k", "v"):
            cache["attn"][n][:, :, :32] = pre["attn"][n]
        for n in ("ssm", "conv"):
            cache["state"][n].copy_(pre["state"][n])
        cache["pos"][:] = 32
        le, cache = m.extend_fn(params, {"tokens": toks[:, 32:40]}, cache)
        ld = []
        for i in (40, 41):
            logits, cache = m.decode_fn(params, {"token": toks[:, i]}, cache)
            ld.append(logits)
        out[reference] = (lp, le, *ld, cache["state"]["ssm"])
        launched = (flash_attention.launches, decode_attention.launches)
        assert launched == ((0, 0) if reference else (1, 2))
    for a, b in zip(out[False], out[True]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ------------------------------------------- kernel 1's LSE and backward

BWD_SHAPES = [          # B, Sq, Sk, H, KVH, causal, prefix (hd 64)
    (2, 1, 1, 32, 8, True, 0),
    (2, 63, 63, 32, 8, True, 0),
    (1, 257, 257, 32, 8, True, 0),
    (2, 300, 300, 32, 8, True, 70),     # a prefix past the first tile
    (1, 200, 200, 8, 2, True, 130),     # the prefix's edge inside a tile
    (1, 100, 150, 8, 2, False, 0),      # non-causal, Sq != Sk
    (1, 130, 130, 4, 4, True, 0),       # G = 1
    (1, 96, 96, 6, 2, True, 0),         # G = 3
    (2, 512, 512, 32, 8, True, 0),
]
# the bf16 backward's tiles (128 keys or query rows a block, 64 a
# warpgroup, 64 a streamed tile): lengths and prefixes at their edges
BWD_EDGES = [
    (1, 127, 127, 8, 2, True, 0),
    (1, 128, 128, 8, 2, True, 0),
    (1, 129, 129, 8, 2, True, 0),
    (1, 300, 300, 8, 2, True, 127),
    (1, 300, 300, 8, 2, True, 128),
    (1, 300, 300, 8, 2, True, 129),
    (1, 300, 300, 8, 2, True, 64),
    (1, 257, 257, 8, 1, True, 0),       # G = 8
    (1, 256, 256, 4, 4, True, 0),       # G = 1, whole tiles
    (1, 129, 127, 8, 2, False, 0),      # non-causal, Sq > Sk
    (2, 127, 385, 8, 2, False, 0),      # non-causal, Sq < Sk
]


def _bwd_inputs(gen, dtype, B, Sq, Sk, H, KVH, causal, prefix, hd=64):
    """q, k, v and a random output gradient; the output and LSE from
    kernel 1, which both sides of a backward comparison take."""
    q, do = (_rnd(gen, (B, Sq, H, hd), dtype) for _ in range(2))
    k, v = (_rnd(gen, (B, Sk, KVH, hd), dtype) for _ in range(2))
    lse = torch.empty((B, H, Sq), device="cuda")
    o = flash_attention(q, k, v, causal=causal, prefix_len=prefix, lse=lse)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,causal,prefix", BWD_SHAPES)
def test_flash_kernel_lse_matches_plain(gen, dtype, B, Sq, Sk, H, KVH,
                                        causal, prefix):
    """Kernel 1's LSE output against ``attention_lse_ref`` (fp32 LSE:
    2e-5 at fp32; at bf16 the kernel sums bf16-rounded probabilities,
    2e-3 relative to a row sum), and its output bit for bit the same as
    without the LSE."""
    q, k, v, o, lse, _ = _bwd_inputs(gen, dtype, B, Sq, Sk, H, KVH, causal,
                                     prefix)
    _, want = ref.attention_lse_ref(q, k, v, causal=causal,
                                    prefix_len=prefix)
    tol = 2e-5 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(lse, want, atol=tol, rtol=tol)
    assert torch.equal(o, flash_attention(q, k, v, causal=causal,
                                          prefix_len=prefix))


def test_flash_kernel_lse_of_rows_with_no_key(gen):
    q = _rnd(gen, (1, 5, 8, 64), torch.bfloat16)
    k = v = torch.zeros((1, 0, 2, 64), dtype=torch.bfloat16, device="cuda")
    lse = torch.zeros((1, 8, 5), device="cuda")
    o = flash_attention(q, k, v, lse=lse)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.equal(lse, torch.full_like(lse, ref.LSE_EMPTY))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,causal,prefix",
                         BWD_SHAPES + BWD_EDGES)
def test_flash_bwd_kernels_match_plain(gen, dtype, B, Sq, Sk, H, KVH,
                                       causal, prefix):
    """Each backward kernel against ``attention_bwd_ref`` on the same
    inputs (the forward kernel's output and LSE): D to 2e-5 (fp32 sums in
    another order), dq/dk/dv to the bounds of the file's header."""
    q, k, v, o, lse, do = _bwd_inputs(gen, dtype, B, Sq, Sk, H, KVH,
                                      causal, prefix)
    kw = dict(causal=causal, prefix_len=prefix)
    D = FA.flash_attention_bwd_dot(o, do)
    torch.testing.assert_close(
        D, (o.float() * do.float()).sum(-1).transpose(1, 2),
        atol=2e-5, rtol=2e-5)
    dk, dv = FA.flash_attention_bwd_dkdv(q, k, v, do, lse, D, **kw)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, D, **kw)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), w.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_are_deterministic(gen, dtype):
    """No float atomics: two backward passes are bitwise equal."""
    q, k, v, o, lse, do = _bwd_inputs(gen, dtype, 2, 700, 700, 32, 8, True,
                                      0)
    a = FA.flash_attention_bwd(q, k, v, o, lse, do)
    b = FA.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("causal,prefix", [(True, 0), (True, 20),
                                           (False, 0)])
def test_flash_attention_fn_grads_match_plain_path(gen, causal, prefix):
    """Autograd through ``ops.flash_attention`` on the card (kernel 1 with
    its LSE, then the three backward kernels, each launched once) against
    autograd through the plain version, fp32 to 2e-5."""
    B, S, H, KVH, hd = 2, 77, 8, 2, 64
    ins = [_rnd(gen, s, torch.float32) for s in
           ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd))]
    do = _rnd(gen, (B, S, H, hd), torch.float32)
    kernels = (flash_attention, FA.flash_attention_bwd_dot,
               FA.flash_attention_bwd_dkdv, FA.flash_attention_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    out = {}
    for name, attend in (("kernel", ops.flash_attention),
                         ("plain", ref.attention_ref)):
        ts = [t.clone().requires_grad_() for t in ins]
        o = attend(*ts, causal=causal, prefix_len=prefix)
        out[name] = (o, *torch.autograd.grad(o, ts, do))
    assert [fn.launches for fn in kernels] == [1, 1, 1, 1]
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def test_ops_flash_attention_builds_no_graph_without_grad(gen):
    """Serving's dispatch: under ``torch.no_grad()``, or with no input
    that requires grad, ``ops.flash_attention`` launches the forward
    kernel alone and builds no graph."""
    q = _rnd(gen, (1, 40, 8, 64), torch.bfloat16).requires_grad_()
    k, v = (_rnd(gen, (1, 40, 2, 64), torch.bfloat16) for _ in range(2))
    kernels = (flash_attention, FA.flash_attention_bwd_dot,
               FA.flash_attention_bwd_dkdv, FA.flash_attention_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    with torch.no_grad():
        o1 = ops.flash_attention(q, k, v)
    o2 = ops.flash_attention(q.detach(), k, v)
    assert o1.grad_fn is None and o2.grad_fn is None
    assert [fn.launches for fn in kernels] == [2, 0, 0, 0]
    assert torch.equal(o1, o2)


def test_flash_attention_fn_refuses_widths_without_a_backward(gen):
    """MLA's q/k 192 over v 128 runs forward on the card but has no
    backward kernels: the Function refuses it before any graph is built,
    and (a) refuses a row of 192."""
    q = _rnd(gen, (1, 8, 4, 192), torch.bfloat16).requires_grad_()
    k = _rnd(gen, (1, 8, 4, 192), torch.bfloat16)
    v = _rnd(gen, (1, 8, 4, 128), torch.bfloat16)
    with pytest.raises(ValueError, match="backward kernels are built for"):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="built for"):
        FA.flash_attention_bwd_dot(q.detach(), q.detach())


def test_dense_loss_grads_kernel_path_match_plain_path(gen):
    """``loss_fn`` and its gradient at a small fp32 dense model with head
    dim 64 (2 layers, d 256, 4 heads over 2): the kernel path against the
    plain path (``build(cfg, reference=True)``), every leaf to 1e-4."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.tree import leaves
    cfg = reduced(llama32_1b, d_model=256, num_heads=4, num_kv_heads=2,
                  head_dim=64, d_ff=512, vocab_size=512, dtype="float32")
    params = build(cfg).init_params(gen)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=96,
                        global_batch=2).batch(0, "cuda")
    flash_attention.launches = FA.flash_attention_bwd_dq.launches = 0
    got = value_and_grad(build(cfg).loss_fn, params, batch)
    assert (flash_attention.launches,
            FA.flash_attention_bwd_dq.launches) == (2, 2)
    want = value_and_grad(build(cfg, reference=True).loss_fn, params, batch)
    assert abs(float(got[0]) - float(want[0])) <= 1e-5
    for a, b in zip(leaves(got[1]), leaves(want[1])):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_train_config_refuses_head_dims_without_a_backward(gen):
    """``launch/train.py`` on the card: the published widths train (hd
    64, and hd 128 for phi3.5-moe and qwen3-14b); ``--d-model 768`` over
    the reduced config's 4 heads is hd 192, which the backward kernels do
    not take, and is refused up front."""
    from repro_torch.launch.train import train_config
    assert train_config("llama3.2-1b", "cuda").resolved_head_dim == 64
    for arch in ("phi3.5-moe-42b-a6.6b", "qwen3-14b"):
        assert train_config(arch, "cuda",
                            num_layers=2).resolved_head_dim == 128
    assert train_config("llama3.2-1b", "cuda",
                        d_model=256).resolved_head_dim == 64
    with pytest.raises(ValueError, match="head dim 192"):
        train_config("llama3.2-1b", "cuda", d_model=768)


# --------------------------------------- kernel 1's backward at hd 128

def _rel_norm(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


REL_NORM = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the hd-128 bf16 bodies stream 32 queries (dK/dV) or 32 keys (dQ) a tile
# beside the 128 keys or rows a block: lengths and prefixes at those
# edges too, and G = 5 (qwen3-14b's 40 heads over 8)
BWD_EDGES_128 = BWD_EDGES + [
    (1, 31, 31, 8, 2, True, 0),
    (1, 33, 33, 8, 2, True, 0),
    (1, 300, 300, 8, 2, True, 31),
    (1, 300, 300, 8, 2, True, 33),
    (1, 200, 200, 10, 2, True, 0),      # G = 5
    (2, 257, 257, 40, 8, True, 0),      # qwen3-14b's heads
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,causal,prefix", BWD_EDGES_128)
def test_flash_bwd_kernels_hd128_match_plain(gen, dtype, B, Sq, Sk, H, KVH,
                                             causal, prefix):
    """Kernel 1's three backward kernels at hd 128 against
    ``attention_bwd_ref``, by element and by relative norm."""
    q, k, v, o, lse, do = _bwd_inputs(gen, dtype, B, Sq, Sk, H, KVH,
                                      causal, prefix, hd=128)
    kw = dict(causal=causal, prefix_len=prefix)
    D = FA.flash_attention_bwd_dot(o, do)
    torch.testing.assert_close(
        D, (o.float() * do.float()).sum(-1).transpose(1, 2),
        atol=2e-5, rtol=2e-5)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])
        if Sq > 1:
            assert _rel_norm(g, w) <= REL_NORM[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_hd128_are_deterministic(gen, dtype):
    q, k, v, o, lse, do = _bwd_inputs(gen, dtype, 1, 700, 700, 32, 8, True,
                                      0, hd=128)
    a = FA.flash_attention_bwd(q, k, v, o, lse, do)
    b = FA.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("B,Sq,H", [(1, 1, 1), (3, 37, 5), (2, 15, 32),
                                    (1, 4099, 8)])
def test_flash_bwd_dot_ragged_rows(gen, dtype, hd, B, Sq, H):
    """(a) at row counts that fill no block: Sq not a multiple of the 16
    positions a block takes, and odd head counts."""
    o, do = (_rnd(gen, (B, Sq, H, hd), dtype) for _ in range(2))
    D = FA.flash_attention_bwd_dot(o, do)
    torch.testing.assert_close(
        D, (o.float() * do.float()).sum(-1).transpose(1, 2),
        atol=2e-5, rtol=2e-5)


def test_flash_attention_fn_hd128_grads_match_plain_path(gen):
    """Autograd through ``ops.flash_attention`` at hd 128, G = 4, fp32:
    the kernels against the plain version's autograd."""
    B, S, H, KVH, hd = 1, 77, 8, 2, 128
    ins = [_rnd(gen, s, torch.float32) for s in
           ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd))]
    do = _rnd(gen, (B, S, H, hd), torch.float32)
    out = {}
    for name, attend in (("kernel", ops.flash_attention),
                         ("plain", ref.attention_ref)):
        ts = [t.clone().requires_grad_() for t in ins]
        o = attend(*ts)
        out[name] = (o, *torch.autograd.grad(o, ts, do))
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


# ------------------------------------------------- kernel 6's backward

def _routed_fill(gen, E, tokens, k):
    """Each expert's count when ``tokens`` tokens each pick k distinct
    experts at random: fills 0 and small ones, as top-k routing gives."""
    pick = torch.rand((tokens, E), generator=gen, device="cuda").topk(
        k, dim=1).indices
    return torch.bincount(pick.reshape(-1), minlength=E).to(torch.int32)


# E, C, D, F, fill: C at the bf16 tiles' 128 rows and either side, D and F
# not multiples of 8 (the mma.sync body), every fill edge. The wgmma body
# (128 x 256 tiles, 64 rows a warpgroup, 64-deep slabs): fills at and
# either side of 64, 128, 192 and 256 in one expert, C past one tile with
# every expert full, every fill 0, D not a multiple of 256 (640, 1536), F a
# multiple of 8 but not of 64 (the k tail zero-filled by TMA), 160 experts
# top-6. Every input is random and non-zero past fill too.
EXPERT_BWD_CASES = [
    (16, 128, 512, 640, [0, 1, 128, 64, 127, 2, 0, 100, 5, 128, 33, 1, 0,
                         77, 128, 9]),
    (4, 127, 203, 300, [0, 1, 64, 127]),
    (4, 129, 256, 384, [0, 1, 129, 100]),
    (2, 64, 64, 64, [0, 0]),
    (3, 130, 256, 128, None),
    (160, 48, 512, 384, "top6"),        # 8 tokens over 160 experts, top-6
    (8, 300, 640, 1536, [63, 64, 65, 127, 129, 191, 257, 300]),
    (4, 520, 1536, 640, None),
    (3, 256, 640, 200, [0, 0, 0]),
    (3, 256, 640, 200, [255, 17, 256]),
]


def _expert_bwd_inputs(gen, dtype, E, C, D, F, fill):
    xe = _rnd(gen, (E, C, D), dtype)
    w = (_rnd(gen, (E, D, F), torch.float32) / D ** 0.5).to(dtype)
    dy = _rnd(gen, (E, C, F), dtype)
    if fill == "top6":
        f = _routed_fill(gen, E, C // 6, 6)
    elif fill is None:
        f = torch.full((E,), C, dtype=torch.int32, device="cuda")
    else:
        f = torch.tensor(fill, dtype=torch.int32, device="cuda")
    return xe, w, f, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F,fill", EXPERT_BWD_CASES)
def test_expert_matmul_bwd_kernels_match_plain(gen, dtype, E, C, D, F, fill):
    """Kernel 6-bwd dX and dW against ``expert_matmul_bwd_ref``, by element
    and by relative norm; dX zero past fill, dW zero for an empty
    expert."""
    from repro_torch.kernels.expert_matmul import (expert_matmul_bwd_dw,
                                                   expert_matmul_bwd_dx)
    xe, w, f, dy = _expert_bwd_inputs(gen, dtype, E, C, D, F, fill)
    dxe = expert_matmul_bwd_dx(dy, w, f)
    dw = expert_matmul_bwd_dw(xe, dy, f)
    want = ref.expert_matmul_bwd_ref(xe, w, f, dy)
    for got, wt in zip((dxe, dw), want):
        assert got.dtype == dtype and got.shape == wt.shape
        torch.testing.assert_close(got.float(), wt.float(), **TOL[dtype])
        if wt.any():
            assert _rel_norm(got, wt) <= REL_NORM[dtype]
    rows = torch.arange(C, device="cuda")[None, :].expand(E, C)
    assert not dxe[rows >= f[:, None]].any()
    assert not dw[f == 0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F,fill", [
    EXPERT_BWD_CASES[0],
    # top-2 of 4096 tokens: ~4.5 live row tiles an expert, several tiles
    # of dX and of dW for each of the persistent bf16 blocks
    (16, 1024, 2048, 1024, "top2x4096")])
def test_expert_matmul_bwd_kernels_are_deterministic(gen, dtype, E, C, D, F,
                                                     fill):
    """No atomics and one block a dW tile: two runs bitwise equal."""
    from repro_torch.kernels.expert_matmul import (expert_matmul_bwd_dw,
                                                   expert_matmul_bwd_dx)
    if fill == "top2x4096":
        fill = _routed_fill(gen, E, 4096, 2).clamp(max=C).tolist()
    xe, w, f, dy = _expert_bwd_inputs(gen, dtype, E, C, D, F, fill)
    for fn, args in ((expert_matmul_bwd_dx, (dy, w, f)),
                     (expert_matmul_bwd_dw, (xe, dy, f))):
        assert torch.equal(fn(*args), fn(*args))


def test_expert_matmul_bwd_body_by_shape(gen):
    """The library's dispatch by shape: bf16 rows that TMA can address
    (16-byte aligned bases, D and F multiples of 8) take the wgmma body,
    others the mma.sync body, fp32 the FMA body; an unaligned base, through
    the wrapper, still matches the plain version."""
    from repro_torch.kernels import expert_matmul as EM
    bf = torch.bfloat16
    E, C, D, F = 4, 129, 256, 384
    xe, w, f, dy = _expert_bwd_inputs(gen, bf, E, C, D, F, [0, 1, 129, 100])
    dxe = torch.empty((E, C, D), dtype=bf, device="cuda")
    dw = torch.empty((E, D, F), dtype=bf, device="cuda")
    assert EM.bwd_body(dy, w, dxe, D, F) == "wgmma"
    assert EM.bwd_body(xe, dy, dw, D, F) == "wgmma"
    assert EM.bwd_body(dy.float(), w.float(), dxe.float(), D, F) == "fma"
    # D 203, F 300: rows not 16-byte multiples
    x2, w2, f2, dy2 = _expert_bwd_inputs(gen, bf, 4, 127, 203, 300,
                                         [0, 1, 64, 127])
    assert EM.bwd_body(dy2, w2, torch.empty((4, 127, 203), dtype=bf,
                                            device="cuda"), 203, 300) == \
        "mma.sync"
    # dy one element into its storage: contiguous, its base 2 bytes off
    dy_off = torch.empty(dy.numel() + 1, dtype=bf,
                         device="cuda")[1:].view(dy.shape)
    dy_off.copy_(dy)
    assert dy_off.is_contiguous() and dy_off.data_ptr() % 16 == 2
    assert EM.bwd_body(dy_off, w, dxe, D, F) == "mma.sync"
    want = ref.expert_matmul_bwd_ref(xe, w, f, dy)
    for got, wt in ((EM.expert_matmul_bwd_dx(dy_off, w, f), want[0]),
                    (EM.expert_matmul_bwd_dw(xe, dy_off, f), want[1])):
        torch.testing.assert_close(got.float(), wt.float(), **TOL[bf])
        assert _rel_norm(got, wt) <= REL_NORM[bf]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_matmul_fn_grads_match_plain_path(gen, dtype):
    """Autograd through ``ops.expert_matmul`` on the card (the forward
    kernel, then dX and dW, each launched once) against autograd through
    the plain version; without grad, the forward kernel alone."""
    from repro_torch.kernels import expert_matmul as EM
    xe, w, f, dy = _expert_bwd_inputs(gen, dtype, 4, 129, 256, 384,
                                      [0, 1, 129, 100])
    kernels = (EM.expert_matmul, EM.expert_matmul_bwd_dx,
               EM.expert_matmul_bwd_dw)
    for fn in kernels:
        fn.launches = 0
    out = {}
    for name, gemm in (("kernel", ops.expert_matmul),
                       ("plain", ref.expert_matmul_ref)):
        a, b = xe.clone().requires_grad_(), w.clone().requires_grad_()
        y = gemm(a, b, f)
        out[name] = (y, *torch.autograd.grad(y, (a, b), dy))
    assert [fn.launches for fn in kernels] == [1, 1, 1]
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype])
    with torch.no_grad():
        y = ops.expert_matmul(xe.clone().requires_grad_(), w, f)
    assert y.grad_fn is None
    assert [fn.launches for fn in kernels] == [2, 1, 1]


def test_moe_loss_grads_kernel_path_match_plain_path(gen):
    """``loss_fn`` of a small fp32 moe model with head dim 64 (2 layers, d
    256, 4 heads over 2, 4 experts top-2) and its gradient: the kernel
    path (kernels 1 and 6 and their backward kernels) against the plain
    path, every leaf (the router's included) to 1e-4."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import expert_matmul as EM
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.tree import leaves
    cfg = reduced(phi35_moe_42b, d_model=256, num_heads=4, num_kv_heads=2,
                  head_dim=64, moe_d_ff=512, vocab_size=512, dtype="float32")
    params = build(cfg).init_params(gen)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=96,
                        global_batch=2).batch(0, "cuda")
    kernels = (EM.expert_matmul, EM.expert_matmul_bwd_dx,
               EM.expert_matmul_bwd_dw, FA.flash_attention_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    got = value_and_grad(build(cfg).loss_fn, params, batch)
    assert [fn.launches for fn in kernels] == [6, 6, 6, 2]
    want = value_and_grad(build(cfg, reference=True).loss_fn, params, batch)
    assert abs(float(got[0]) - float(want[0])) <= 1e-5
    for a, b in zip(leaves(got[1]), leaves(want[1])):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------ kernel 7's backward
# bf16 outputs (dr, dk, dv at bf16 inputs) take bf16's bound by element;
# fp32 outputs 2e-5 with the abs part scaled by the output's largest
# magnitude: each is a sum of signed fp32 terms taken in another order
# than the plain version's (dS over up to 512 tokens that do not decay,
# du over B and S, dlogw a difference of running sums), whose rounding
# follows the largest terms, not the entry; each output's ||kernel -
# plain|| / ||plain|| within REL_NORM too, which holds the bulk

def _wkv_bwd_inputs(gen, dtype, B, S, H, hd, logw=None, state0=True):
    r, k, v = (0.5 * _rnd(gen, (B, S, H, hd), dtype) for _ in range(3))
    if logw is None:
        w = (-torch.rand((B, S, H, hd), generator=gen, device="cuda")
             * 1.5).clamp(max=-1e-6)
    else:
        w = torch.full((B, S, H, hd), logw, device="cuda")
    u = 0.3 * _rnd(gen, (H, hd), torch.float32)
    s0 = 0.1 * _rnd(gen, (B, H, hd, hd), torch.float32)
    if not state0:
        s0.zero_()
    dout = _rnd(gen, (B, S, H, hd), torch.float32)
    dstate = _rnd(gen, (B, H, hd, hd), torch.float32)
    return (r, k, v, w, u, s0), dout, dstate


def _wkv_bwd_check(got, want, dtype):
    names = ("dr", "dk", "dv", "dlogw", "du", "dstate0")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        tol = TOL[g.dtype]
        err = (g.float() - w.float()).abs()
        scale = (w.float().abs() if g.dtype == torch.bfloat16
                 else w.float().abs().max())
        assert bool((err <= tol["atol"] * (1 + scale)).all()), (
            name, float(err.max()))
        assert _rel_norm(g, w) <= REL_NORM[
            dtype if name in ("dr", "dk", "dv") else torch.float32], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 512])
def test_wkv6_bwd_kernel_matches_plain(gen, dtype, hd, B, S):
    """Kernel 7-bwd against ``wkv6_chunked_bwd_ref`` from the kernel
    forward's chunk states (themselves held against the plain ones), a
    random decay, nonzero state0 and final-state gradient."""
    H = 32 if hd == 64 else 4
    ins, dout, dstate = _wkv_bwd_inputs(gen, dtype, B, S, H, hd)
    states = torch.empty((B, W6.n_chunks(S), H, hd, hd), device="cuda")
    wkv6(*ins, chunk_states=states)
    _, _, want_states = ref.wkv6_chunked_ref(*ins, chunk_states=True)
    torch.testing.assert_close(states, want_states, **TOL[torch.float32])
    got = W6.wkv6_bwd(*ins[:5], states, dout, dstate)
    _wkv_bwd_check(got, ref.wkv6_chunked_bwd_ref(*ins, states, dout,
                                                 dstate), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("S", [33, 512])
@pytest.mark.parametrize("logw,state0,dstate", [
    (-1.5, True, True), (-1e-6, True, True), (None, False, False)],
    ids=["clamp", "near_zero_decay", "zero_state"])
def test_wkv6_bwd_kernel_edges_match_plain(gen, dtype, hd, S, logw, state0,
                                           dstate):
    """The decay clamp (-1.5: 32 tokens reach e^{+-48}), a decay near
    ``LOG_W_MAX`` (-1e-6: nothing forgets over 512 tokens), and a zero
    state0 with no final-state gradient (the training path's)."""
    H = 32 if hd == 64 else 4
    ins, dout, ds = _wkv_bwd_inputs(gen, dtype, 3, S, H, hd, logw, state0)
    ds = ds if dstate else None
    states = torch.empty((3, W6.n_chunks(S), H, hd, hd), device="cuda")
    wkv6(*ins, chunk_states=states)
    got = W6.wkv6_bwd(*ins[:5], states, dout, ds)
    _wkv_bwd_check(got, ref.wkv6_chunked_bwd_ref(*ins, states, dout, ds),
                   dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_bwd_kernel_repeats_and_rows_do_not_depend_on_the_batch(
        gen, dtype):
    """Two runs bitwise equal; row 2 alone (B=1) equals row 2 of a B=8
    call bit for bit (dr, dk, dv, dlogw, dstate0; du sums the rows)."""
    B, S, H, hd = 8, 100, 32, 64
    ins, dout, dstate = _wkv_bwd_inputs(gen, dtype, B, S, H, hd)
    states = torch.empty((B, W6.n_chunks(S), H, hd, hd), device="cuda")
    wkv6(*ins, chunk_states=states)
    a = W6.wkv6_bwd(*ins[:5], states, dout, dstate)
    b = W6.wkv6_bwd(*ins[:5], states, dout, dstate)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    row = lambda t: t[2:3].contiguous()
    one = W6.wkv6_bwd(*(row(t) for t in ins[:4]), ins[4], row(states),
                      row(dout), row(dstate))
    for i in (0, 1, 2, 3, 5):
        assert torch.equal(a[i][2:3], one[i]), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd", [(1, 4096, 4, 16), (2, 1000, 32, 64)],
                         ids=["many_chunks_few_heads", "ragged_32_chunks"])
def test_wkv6_bwd_kernel_partitions_match_plain(gen, dtype, B, S, H, hd):
    """Kernel 7-bwd's block per (b, chunk, h) and its dS scan over many
    chunks at few heads (128 chunks, 4 heads of 16) and over 32 chunks
    with a ragged last one (S 1000) at rwkv6-1.6b's heads, against
    ``wkv6_chunked_bwd_ref``."""
    ins, dout, dstate = _wkv_bwd_inputs(gen, dtype, B, S, H, hd)
    states = torch.empty((B, W6.n_chunks(S), H, hd, hd), device="cuda")
    wkv6(*ins, chunk_states=states)
    got = W6.wkv6_bwd(*ins[:5], states, dout, dstate)
    _wkv_bwd_check(got, ref.wkv6_chunked_bwd_ref(*ins, states, dout,
                                                 dstate), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,logw,dstate", [
    (2, 1, 4, 16, None, True), (3, 33, 4, 16, -1.5, True),
    (2, 1000, 32, 64, None, True), (1, 4096, 32, 64, None, False),
    (1, 512, 32, 64, -1e-6, True)],
    ids=["one_token", "clamp", "ragged", "phase15", "near_zero_decay"])
def test_wkv6_bwd_ds_pass_matches_plain(gen, dtype, B, S, H, hd, logw,
                                        dstate):
    """Kernel 7-bwd's dS pass alone (``wkv6_bwd_ds``: its local and scan
    kernels) against ``ref.wkv6_bwd_ds_ref``: dS at every chunk's end
    and dstate0, fp32, by element (2e-5 of the largest) and by relative
    norm; the last chunk's end is the final state's gradient exactly."""
    ins, dout, ds = _wkv_bwd_inputs(gen, dtype, B, S, H, hd, logw)
    ds = ds if dstate else None
    got = W6.wkv6_bwd_ds(ins[0], ins[3], dout, ds)
    want = ref.wkv6_bwd_ds_ref(ins[0], ins[3], dout, ds)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        err = (g - w).abs()
        assert bool((err <= 2e-5 * (1 + w.abs().max())).all()), float(
            err.max())
        assert _rel_norm(g, w) <= REL_NORM[torch.float32]
    assert torch.equal(got[0][:, -1], torch.zeros_like(got[1]) if ds is None
                       else ds)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_bwd_kernel_repeats_and_rows_do_not_depend_on_the_batch_4096(
        gen, dtype):
    """At 4096 tokens (128 chunks, 32 heads of 64): two runs bitwise
    equal; row 1 alone equals row 1 of a B=2 call bit for bit (dr, dk,
    dv, dlogw, dstate0)."""
    B, S, H, hd = 2, 4096, 32, 64
    ins, dout, dstate = _wkv_bwd_inputs(gen, dtype, B, S, H, hd)
    states = torch.empty((B, W6.n_chunks(S), H, hd, hd), device="cuda")
    wkv6(*ins, chunk_states=states)
    a = W6.wkv6_bwd(*ins[:5], states, dout, dstate)
    b = W6.wkv6_bwd(*ins[:5], states, dout, dstate)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    row = lambda t: t[1:2].contiguous()
    one = W6.wkv6_bwd(*(row(t) for t in ins[:4]), ins[4], row(states),
                      row(dout), row(dstate))
    for i in (0, 1, 2, 3, 5):
        assert torch.equal(a[i][1:2], one[i]), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_bwd_kernel_takes_unaligned_inputs(gen, dtype):
    """Inputs at an odd element offset (not 16-byte aligned) take the
    kernels' scalar copies in place of cp.async: the same gradients as
    aligned copies of them, bit for bit."""
    B, S, H, hd = 2, 45, 4, 64
    ins, dout, dstate = _wkv_bwd_inputs(gen, dtype, B, S, H, hd)
    states = torch.empty((B, W6.n_chunks(S), H, hd, hd), device="cuda")
    wkv6(*ins, chunk_states=states)

    def odd(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        return view

    want = W6.wkv6_bwd(*ins[:5], states, dout, dstate)
    got = W6.wkv6_bwd(*(odd(t) for t in ins[:4]), ins[4], odd(states),
                      odd(dout), odd(dstate))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_wkv6_bwd_counts_one_launch_a_call_and_each_pass(gen):
    """``wkv6_bwd.launches`` counts calls; ``wkv6_bwd.passes`` each of
    its four kernels' launches, one a call; the dS pass alone and the
    pass timers count in neither."""
    ins, dout, dstate = _wkv_bwd_inputs(gen, torch.bfloat16, 1, 70, 4, 64)
    states = torch.empty((1, W6.n_chunks(70), 4, 64, 64), device="cuda")
    wkv6(*ins, chunk_states=states)
    W6.wkv6_bwd.launches = 0
    W6.wkv6_bwd.passes = dict.fromkeys(W6.PASSES, 0)
    for _ in range(2):
        W6.wkv6_bwd(*ins[:5], states, dout, dstate)
    W6.wkv6_bwd_ds(ins[0], ins[3], dout, dstate)
    for fn in W6.bwd_pass_timers(*ins[:5], states, dout, dstate).values():
        fn()
    torch.cuda.synchronize()
    assert W6.wkv6_bwd.launches == 2
    assert W6.wkv6_bwd.passes == {"local": 2, "scan": 2, "chunk": 2, "du": 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S", [(8, 100), (1, 512), (2, 31)])
def test_wkv6_chunk_state_output_leaves_the_forward_as_it_is(gen, dtype, B,
                                                             S):
    """Kernel 7 with its chunk-state output (the training forward) gives
    the serving call's output and final state bit for bit, and the
    states at each chunk's start (the first is state0 exactly)."""
    ins, _, _ = _wkv_bwd_inputs(gen, dtype, B, S, 32, 64)
    o, s = wkv6(*ins)
    states = torch.empty((B, W6.n_chunks(S), 32, 64, 64), device="cuda")
    o2, s2 = wkv6(*ins, chunk_states=states)
    assert torch.equal(o, o2) and torch.equal(s, s2)
    assert torch.equal(states[:, 0], ins[5])
    torch.testing.assert_close(
        states, ref.wkv6_chunked_ref(*ins, chunk_states=True)[2],
        **TOL[torch.float32])


def test_wkv6_fn_grads_match_plain_path(gen):
    """Autograd through ``ops.wkv6`` on the card (kernel 7 with its chunk
    states, then kernel 7-bwd, each launched once) against autograd
    through the plain chunked form, fp32, the output's and the final
    state's cotangents both; without grad, the forward kernel alone."""
    ins, dout, dstate = _wkv_bwd_inputs(gen, torch.float32, 2, 77, 4, 64)
    W6.wkv6.launches = W6.wkv6_bwd.launches = 0
    out = {}
    for name, scan in (("kernel", ops.wkv6), ("plain", ref.wkv6_chunked_ref)):
        ts = [t.clone().requires_grad_() for t in ins]
        o, s = scan(*ts)
        out[name] = (o, s, *torch.autograd.grad((o, s), ts, (dout, dstate)))
    assert (W6.wkv6.launches, W6.wkv6_bwd.launches) == (1, 1)
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    ts = [t.clone().requires_grad_() for t in ins]
    with torch.no_grad():
        o, _ = ops.wkv6(*ts)
    assert o.grad_fn is None and W6.wkv6.launches == 2


def test_wkv6_fn_refuses_widths_without_a_backward(gen):
    r = _rnd(gen, (1, 8, 2, 32), torch.float32).requires_grad_()
    with pytest.raises(ValueError, match="kernel 7-bwd is built for"):
        ops.wkv6(r, r, r, -torch.ones_like(r), torch.zeros(2, 32,
                                                          device="cuda"),
                 torch.zeros(1, 2, 32, 32, device="cuda"))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "seamless-m4t-medium"])
def test_new_family_loss_grads_kernel_path_match_plain_path(gen, arch):
    """``loss_fn`` and its gradient at a small fp32 model with head dim 64
    (2 layers, d 256, 4 heads; seamless with 2 encoder layers over 160
    frames): the kernel path (kernel 7 and 7-bwd, or kernel 1 and its
    backward kernels for the encoder, self- and cross-attention) against
    the plain path, every leaf to 1e-4."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.tree import leaves
    cfg = reduced(get_config(arch), d_model=256, num_heads=4, num_kv_heads=4,
                  head_dim=64, d_ff=512, vocab_size=512, dtype="float32",
                  num_prefix_embeddings=160)
    params = build(cfg).init_params(gen)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=96,
                        global_batch=2).batch(0, "cuda")
    if cfg.family == "encdec":
        batch["frames"] = 0.02 * _rnd(gen, (2, 160, 256), torch.float32)
    kernels = (W6.wkv6, W6.wkv6_bwd, flash_attention,
               FA.flash_attention_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    got = value_and_grad(build(cfg).loss_fn, params, batch)
    want_launches = ([2, 2, 0, 0] if cfg.family == "ssm"
                     else [0, 0, 6, 6])    # encoder 2, self 2, cross 2
    assert [fn.launches for fn in kernels] == want_launches
    want = value_and_grad(build(cfg, reference=True).loss_fn, params, batch)
    assert [fn.launches for fn in kernels] == want_launches
    assert abs(float(got[0]) - float(want[0])) <= 1e-5
    for a, b in zip(leaves(got[1]), leaves(want[1])):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_train_config_takes_the_new_families_on_the_card(gen):
    """rwkv6-1.6b (kernel 7-bwd at hd 64) trains through ``train_loop``
    on the card; seamless-m4t-medium (hd 64) passes ``train_config`` but
    ``train_loop`` refuses it: its batches need frames."""
    from repro_torch.launch.train import train_config, train_loop
    assert train_config("rwkv6-1.6b", "cuda").resolved_head_dim == 64
    assert train_config("seamless-m4t-medium", "cuda").family == "encdec"
    with pytest.raises(ValueError, match="no frames or patches"):
        train_loop(arch="seamless-m4t-medium", steps=1, global_batch=1,
                   seq_len=8, device="cuda", num_layers=1, log_every=0)


# --------------------------------------- kernel 1's backward at hd 112

# zamba2-7b's shared attention (32 heads over 32, hd 112) takes hd 128's
# layout, its columns 112 .. 127 zero-filled by TMA and never stored: B 1
# and 2, ragged S (31 and 129 beside the 32- and 128-position tiles, 300),
# causal, a prefix at a tile's edge and inside one, non-causal, G 1 and 4
BWD_CASES_112 = [
    (B, S, S, 8, kvh, causal, prefix)
    for B in (1, 2) for S in (31, 129, 300) for kvh in (8, 2)
    for causal, prefix in ((True, 0), (True, 33), (False, 0))
] + [(1, 129, 127, 8, 8, False, 0), (2, 127, 385, 8, 2, False, 0),
     (1, 300, 300, 8, 8, True, 128), (1, 4096, 4096, 32, 32, True, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,causal,prefix", BWD_CASES_112)
def test_flash_bwd_kernels_hd112_match_plain(gen, dtype, B, Sq, Sk, H, KVH,
                                             causal, prefix):
    """Kernel 1's LSE and its three backward kernels at hd 112 against
    ``attention_lse_ref`` and ``attention_bwd_ref``, by element and by
    relative norm; the padded columns of the layout written nowhere."""
    q, k, v, o, lse, do = _bwd_inputs(gen, dtype, B, Sq, Sk, H, KVH,
                                      causal, prefix, hd=112)
    kw = dict(causal=causal, prefix_len=prefix)
    _, lse_want = ref.attention_lse_ref(q, k, v, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(lse, lse_want, atol=tol, rtol=tol)
    D = FA.flash_attention_bwd_dot(o, do)
    torch.testing.assert_close(
        D, (o.float() * do.float()).sum(-1).transpose(1, 2),
        atol=2e-5, rtol=2e-5)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])
        if Sq > 1:
            assert _rel_norm(g, w) <= REL_NORM[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_hd112_repeat_and_rows_do_not_depend_on_b(
        gen, dtype):
    """No float atomics, and no row's work depends on the others: two
    backward passes at B 3 are bitwise equal, and equal bit for bit to
    each row's pass alone."""
    q, k, v, o, lse, do = _bwd_inputs(gen, dtype, 3, 333, 333, 8, 2, True,
                                      0, hd=112)
    a = FA.flash_attention_bwd(q, k, v, o, lse, do)
    b = FA.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for r in range(3):
        one = FA.flash_attention_bwd(*(t[r:r + 1].contiguous()
                                       for t in (q, k, v, o)),
                                     lse[r:r + 1].contiguous(),
                                     do[r:r + 1].contiguous())
        assert all(torch.equal(x[r:r + 1], y) for x, y in zip(a, one))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,H", [(1, 1, 1), (3, 37, 5), (2, 15, 32),
                                    (1, 4099, 8)])
def test_flash_bwd_dot_hd112_ragged_rows(gen, dtype, B, Sq, H):
    """(a) at hd 112, a row of 14 (bf16) or 28 (fp32) 16-byte vectors
    over 16 or 32 lanes, at row counts that fill no block."""
    o, do = (_rnd(gen, (B, Sq, H, 112), dtype) for _ in range(2))
    D = FA.flash_attention_bwd_dot(o, do)
    torch.testing.assert_close(
        D, (o.float() * do.float()).sum(-1).transpose(1, 2),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("views", ["offset", "strided"])
def test_flash_attention_fn_hd112_grads_match_plain_path(gen, dtype, views):
    """Autograd through ``ops.flash_attention`` at hd 112 (kernel 1 with
    its LSE, then the three backward kernels, once each) on views the
    backward kernels do not take as they are (a 2-byte offset into a
    flat buffer; slices of a fused q/k/v projection), against autograd
    through the plain version."""
    B, S, H = 1, 150, 8
    if views == "offset":
        n = B * S * H * 112
        flat = _rnd(gen, (3 * n + 1,), dtype)
        ins = [flat[1 + i * n:1 + (i + 1) * n].view(B, S, H, 112)
               for i in range(3)]
        assert all(t.data_ptr() % 16 for t in ins)
    else:
        ins = list(_rnd(gen, (B, S, 3 * H, 112), dtype).split(H, dim=2))
    do = _rnd(gen, (B, S, H, 112), dtype)
    kernels = (flash_attention, FA.flash_attention_bwd_dot,
               FA.flash_attention_bwd_dkdv, FA.flash_attention_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    out = {}
    for name, attend in (("kernel", ops.flash_attention),
                         ("plain", ref.attention_ref)):
        ts = [t.detach().requires_grad_() for t in ins]
        o = attend(*ts)
        out[name] = (o, *torch.autograd.grad(o, ts, do))
    assert [fn.launches for fn in kernels] == [1, 1, 1, 1]
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype])


def test_hybrid_loss_grads_kernel_path_match_plain_path(gen):
    """``loss_fn`` and its gradient at a small fp32 hybrid with head dim
    112 (d 448, 4 heads; 1 group of 2 Mamba2 layers and a tail layer;
    lora_b and the decay perturbed): the kernel path (kernel 1 and its
    backward kernels, once each) against the plain path, every leaf to
    1e-4."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.tree import leaves
    cfg = reduced(get_config("zamba2-7b"), d_model=448, head_dim=None,
                  d_ff=896, vocab_size=512, num_layers=3, dtype="float32")
    assert (cfg.resolved_head_dim, T._zamba_grouping(cfg)) == (112, (1, 2, 1))
    params = build(cfg).init_params(gen)
    sh = params["shared"]
    sh["lora_b"] += 0.02 * _rnd(gen, tuple(sh["lora_b"].shape), torch.float32)
    for p in params["mamba"] + params["mamba_tail"]:
        p["A_log"] += 0.5 * _rnd(gen, tuple(p["A_log"].shape), torch.float32)
        p["dt_bias"] += _rnd(gen, tuple(p["dt_bias"].shape), torch.float32)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=96,
                        global_batch=2).batch(0, "cuda")
    kernels = (flash_attention, FA.flash_attention_bwd_dot,
               FA.flash_attention_bwd_dkdv, FA.flash_attention_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    got = value_and_grad(build(cfg).loss_fn, params, batch)
    assert [fn.launches for fn in kernels] == [1, 1, 1, 1]
    want = value_and_grad(build(cfg, reference=True).loss_fn, params, batch)
    assert [fn.launches for fn in kernels] == [1, 1, 1, 1]
    assert abs(float(got[0]) - float(want[0])) <= 1e-5
    for a, b in zip(leaves(got[1]), leaves(want[1])):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_train_config_takes_the_hybrid_on_the_card(gen):
    """zamba2-7b at its published width (hd 112) passes ``train_config``
    at 13 layers (2 groups and a tail layer), and ``train_loop`` trains a
    hd-112 reduced copy on the card through kernel 1 and its backward."""
    from repro_torch.launch.train import train_config, train_loop
    cfg = train_config("zamba2-7b", "cuda", num_layers=13)
    assert (cfg.resolved_head_dim, cfg.d_model) == (112, 3584)
    assert T._zamba_grouping(cfg) == (2, 6, 1)
    FA.flash_attention_bwd_dkdv.launches = 0
    out = train_loop(arch="zamba2-7b", d_model=448, num_layers=3, steps=2,
                     global_batch=2, seq_len=64, device="cuda",
                     log_every=0)
    assert out["cfg"].resolved_head_dim == 112
    assert FA.flash_attention_bwd_dkdv.launches == 2
    assert all(map(lambda x: x == x and abs(x) < 1e4, out["losses"]))


# --------------------------------------- kernel 1's backward at hd 256

# paligemma-3b (8 heads over 1 KV head, hd 256, its 256 patches a
# bidirectional prefix): (b) splits a 64-key tile's work between its two
# warpgroups and streams 32-query tiles; (c) takes 128 rows a block and
# 32-key tiles. Its training microbatch (B 4 x 768, prefix 256), lengths at
# those tiles' edges (31/33, 63/65, 127/129), prefixes 0, inside a tile, at
# an edge and longer than Sq, non-causal with Sq != Sk, G = 8 over 1 and
# G = 1 over 8
BWD_CASES_256 = [
    (4, 768, 768, 8, 1, True, 256),
    (1, 31, 31, 8, 1, True, 0), (1, 33, 33, 8, 1, True, 0),
    (1, 63, 63, 8, 1, True, 0), (1, 65, 65, 8, 1, True, 0),
    (1, 127, 127, 8, 1, True, 0), (2, 129, 129, 8, 1, True, 0),
    (1, 300, 300, 8, 1, True, 0), (1, 300, 300, 8, 1, True, 33),
    (1, 300, 300, 8, 1, True, 64), (1, 300, 300, 8, 1, True, 129),
    (1, 200, 200, 8, 1, True, 300),
    (1, 129, 127, 8, 1, False, 0), (2, 127, 385, 8, 1, False, 0),
    (1, 257, 257, 8, 8, True, 0), (2, 300, 300, 8, 8, True, 100),
    (1, 1, 1, 8, 1, True, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,causal,prefix", BWD_CASES_256)
def test_flash_bwd_kernels_hd256_match_plain(gen, dtype, B, Sq, Sk, H, KVH,
                                             causal, prefix):
    """Kernel 1's LSE and its three backward kernels at hd 256 against
    ``attention_lse_ref`` and ``attention_bwd_ref``, by element and by
    relative norm."""
    q, k, v, o, lse, do = _bwd_inputs(gen, dtype, B, Sq, Sk, H, KVH,
                                      causal, prefix, hd=256)
    kw = dict(causal=causal, prefix_len=prefix)
    _, lse_want = ref.attention_lse_ref(q, k, v, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(lse, lse_want, atol=tol, rtol=tol)
    D = FA.flash_attention_bwd_dot(o, do)
    torch.testing.assert_close(
        D, (o.float() * do.float()).sum(-1).transpose(1, 2),
        atol=2e-5, rtol=2e-5)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])
        if Sq > 1:
            assert _rel_norm(g, w) <= REL_NORM[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_hd256_repeat_and_rows_do_not_depend_on_b(
        gen, dtype):
    """No float atomics, and no row's work depends on the others: two
    backward passes at B 3 (G = 8, a prefix) are bitwise equal, and equal
    bit for bit to each row's pass alone."""
    q, k, v, o, lse, do = _bwd_inputs(gen, dtype, 3, 333, 333, 8, 1, True,
                                      100, hd=256)
    a = FA.flash_attention_bwd(q, k, v, o, lse, do, prefix_len=100)
    b = FA.flash_attention_bwd(q, k, v, o, lse, do, prefix_len=100)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for r in range(3):
        one = FA.flash_attention_bwd(*(t[r:r + 1].contiguous()
                                       for t in (q, k, v, o)),
                                     lse[r:r + 1].contiguous(),
                                     do[r:r + 1].contiguous(), prefix_len=100)
        assert all(torch.equal(x[r:r + 1], y) for x, y in zip(a, one))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,H", [(1, 1, 1), (3, 37, 5), (2, 15, 32),
                                    (1, 4099, 8)])
def test_flash_bwd_dot_hd256_ragged_rows(gen, dtype, B, Sq, H):
    """(a) at hd 256, a row of 32 (bf16) or 64 (fp32, two a lane) 16-byte
    vectors over 32 lanes, at row counts that fill no block."""
    o, do = (_rnd(gen, (B, Sq, H, 256), dtype) for _ in range(2))
    D = FA.flash_attention_bwd_dot(o, do)
    torch.testing.assert_close(
        D, (o.float() * do.float()).sum(-1).transpose(1, 2),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("views", ["offset", "strided"])
def test_flash_attention_fn_hd256_grads_match_plain_path(gen, dtype, views):
    """Autograd through ``ops.flash_attention`` at hd 256, 8 heads over 1
    and a 40-position prefix (kernel 1 with its LSE, then the three
    backward kernels, once each) on views the backward kernels do not take
    as they are (a 2-byte offset into a flat buffer; slices of a fused
    q/k/v projection), against autograd through the plain version."""
    B, S, H, hd, prefix = 1, 150, 8, 256, 40
    if views == "offset":
        sizes = (B * S * H * hd, B * S * hd, B * S * hd)
        flat = _rnd(gen, (sum(sizes) + 1,), dtype)
        ins, at = [], 1
        for n, h in zip(sizes, (H, 1, 1)):
            ins.append(flat[at:at + n].view(B, S, h, hd))
            at += n
        assert all(t.data_ptr() % 16 for t in ins)
    else:
        ins = list(_rnd(gen, (B, S, H + 2, hd), dtype).split([H, 1, 1],
                                                              dim=2))
    do = _rnd(gen, (B, S, H, hd), dtype)
    kernels = (flash_attention, FA.flash_attention_bwd_dot,
               FA.flash_attention_bwd_dkdv, FA.flash_attention_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    out = {}
    for name, attend in (("kernel", ops.flash_attention),
                         ("plain", ref.attention_ref)):
        ts = [t.detach().requires_grad_() for t in ins]
        o = attend(*ts, prefix_len=prefix)
        out[name] = (o, *torch.autograd.grad(o, ts, do))
    assert [fn.launches for fn in kernels] == [1, 1, 1, 1]
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype])


def test_flash_bwd_hd256_fits_shared_memory(gen):
    """The bf16 dK/dV and dQ layouts at hd 256 fit the 227 KB a block may
    take (232,448 bytes), and the fp32 bodies' tiles too."""
    for dtype in (torch.bfloat16, torch.float32):
        assert 0 < FA.bwd_smem_bytes(dtype, 256) <= 232448


def test_vlm_loss_grads_kernel_path_match_plain_path(gen):
    """``loss_fn`` and its gradient at a small fp32 vlm with head dim 256
    (d 512 over 2 heads and 1 KV head, 2 layers, 8 patches): the kernel
    path (kernel 1 and its backward kernels, once a layer) against the
    plain path, every leaf to 1e-4, ``frontend_proj`` among them."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.tree import leaves
    cfg = reduced(get_config("paligemma-3b"), d_model=512, num_heads=2,
                  head_dim=256, d_ff=1024, vocab_size=512, dtype="float32")
    assert (cfg.resolved_head_dim, cfg.num_kv_heads) == (256, 1)
    params = build(cfg).init_params(gen)
    assert "frontend_proj" in params
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=96,
                        global_batch=2).batch(0, "cuda")
    batch["patches"] = 0.02 * _rnd(gen, (2, cfg.num_prefix_embeddings,
                                         cfg.d_model), torch.float32)
    kernels = (flash_attention, FA.flash_attention_bwd_dot,
               FA.flash_attention_bwd_dkdv, FA.flash_attention_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    got = value_and_grad(build(cfg).loss_fn, params, batch)
    assert [fn.launches for fn in kernels] == [2, 2, 2, 2]
    want = value_and_grad(build(cfg, reference=True).loss_fn, params, batch)
    assert [fn.launches for fn in kernels] == [2, 2, 2, 2]
    assert abs(float(got[0]) - float(want[0])) <= 1e-5
    for a, b in zip(leaves(got[1]), leaves(want[1])):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_train_config_takes_the_vlm_on_the_card(gen):
    """paligemma-3b at its published width (hd 256, 8 heads over 1)
    passes ``train_config``; ``train_loop`` still refuses it, as its
    batches need patches."""
    from repro_torch.launch.train import train_config, train_loop
    cfg = train_config("paligemma-3b", "cuda")
    assert (cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads,
            cfg.num_layers) == (256, 8, 1, 18)
    with pytest.raises(ValueError, match="no frames or patches"):
        train_loop(arch="paligemma-3b", steps=1, global_batch=1, seq_len=8,
                   device="cuda", num_layers=1, log_every=0)
