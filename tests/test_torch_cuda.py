"""The hand-written CUDA kernels against their plain PyTorch versions, and
the model's kernel path against its plain path, on the card.

Marked ``cuda``: every test skips where there is no GPU (the kernels have
no CPU mode). This file imports neither JAX nor the reference package, so
it runs on a machine that has only PyTorch for CUDA and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: bf16 outputs round once to 8 mantissa bits on each side, so
2e-2 (abs + rel); fp32 differs only in the order of sums of up to 1024
products and in fused multiply-adds, so 2e-5.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.configs import llama32_1b, reduced
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KVH,hd,lengths", [
    (4, 1024, 32, 8, 64, (1, 333, 1024, 1031)),
    (4, 1024, 32, 8, 128, (1, 333, 1024, 1031)),
    (2, 64, 8, 1, 64, (64, 5)),           # G = 8: two blocks per KV head
    (3, 50, 6, 2, 64, (0, 49, 50)),       # G = 3; length 0 gives 0
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
