"""Port kernels: plain PyTorch versions against the reference package.

The same inputs, drawn with numpy, go through the Pallas kernels of
``repro.kernels`` (interpret mode, at shapes that tile) or ``repro.kernels.ref``
(ragged shapes) and through ``repro_torch.kernels.ref``. fp32 agrees to
1e-5: the same math, summed in another order. bf16 agrees to 2e-2: the
output rounds to bf16 (8 mantissa bits) on both sides.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as dec_pallas
from repro.kernels.decode_attention import (
    paged_decode_attention as pdec_pallas)
from repro.kernels.flash_attention import flash_attention as fa_pallas
from repro.kernels.flash_attention import (
    paged_extend_attention as pext_pallas)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention as dec_cuda
from repro_torch.kernels.flash_attention import flash_attention as fa_cuda

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _qkv(seed, B, Sq, Sk, H, KVH, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), np.float32),
            rng.standard_normal((B, Sk, KVH, hd), np.float32),
            rng.standard_normal((B, Sk, KVH, hd), np.float32))


def _both(arrs, dtype):
    """(jax arrays, torch CPU tensors) of the same values in ``dtype``."""
    j = [jnp.asarray(a, jnp.dtype(dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


# ------------------------------------------------------------------ flash
@pytest.mark.parametrize("B,S,H,KVH,hd,prefix,dtype", [
    (1, 32, 8, 2, 16, 0, "float32"),      # GQA 4
    (1, 32, 8, 2, 16, 0, "bfloat16"),
    (2, 32, 4, 4, 16, 0, "float32"),      # G = 1
    (1, 32, 4, 1, 16, 20, "float32"),     # MQA with a bidirectional prefix
])
def test_attention_plain_matches_pallas(B, S, H, KVH, hd, prefix, dtype):
    (jq, jk, jv), (q, k, v) = _both(_qkv(0, B, S, S, H, KVH, hd), dtype)
    want = fa_pallas(jq, jk, jv, causal=True, prefix_len=prefix,
                     block_q=16, block_k=16, interpret=True)
    _close(ref.attention_ref(q, k, v, causal=True, prefix_len=prefix),
           want, dtype)


@pytest.mark.parametrize("B,Sq,Sk,H,KVH,causal,prefix", [
    (2, 13, 13, 8, 2, True, 0),     # ragged, GQA 4
    (1, 5, 5, 4, 4, True, 3),       # shorter than any tile, prefix
    (2, 7, 19, 4, 1, False, 0),     # Sq != Sk, bidirectional
])
def test_attention_plain_matches_reference_ragged(B, Sq, Sk, H, KVH, causal,
                                                  prefix):
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, B, Sq, Sk, H, KVH, 16),
                                    "float32")
    want = jref.attention_ref(jq, jk, jv, causal=causal, prefix_len=prefix)
    got = ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
    _close(got, want, "float32")


# ------------------------------------------------------------------ decode
def _dec_inputs(seed, B, S, H, KVH, hd, lengths):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, H, hd), np.float32),
            rng.standard_normal((B, S, KVH, hd), np.float32),
            rng.standard_normal((B, S, KVH, hd), np.float32)]
    return arrs, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("B,S,H,KVH,lengths,dtype", [
    (3, 32, 8, 2, (1, 17, 32), "float32"),    # GQA 4: length 1, odd, S
    (3, 32, 8, 2, (1, 17, 32), "bfloat16"),
    (2, 32, 4, 4, (32, 9), "float32"),        # G = 1
])
def test_decode_plain_matches_pallas(B, S, H, KVH, lengths, dtype):
    arrs, lens = _dec_inputs(2, B, S, H, KVH, 16, lengths)
    (jq, jk, jv), (q, k, v) = _both(arrs, dtype)
    want = dec_pallas(jq, jk, jv, jnp.asarray(lens), block_k=16,
                      interpret=True)
    _close(ref.decode_attention_ref(q, k, v, torch.from_numpy(lens)), want,
           dtype)


@pytest.mark.parametrize("S,lengths", [(13, (1, 13, 6)), (5, (5, 2, 3))])
def test_decode_plain_matches_reference_ragged(S, lengths):
    arrs, lens = _dec_inputs(3, 3, S, 8, 2, 16, lengths)
    (jq, jk, jv), (q, k, v) = _both(arrs, "float32")
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    got = ops.decode_attention(q, k, v, torch.from_numpy(lens))
    _close(got, want, "float32")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes on the
    CPU itself (the plain version is chosen by ``ops``, by device)."""
    (q, k, v) = [torch.from_numpy(a) for a in _qkv(4, 1, 4, 4, 4, 4, 64)]
    with pytest.raises(ValueError, match="CUDA"):
        fa_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        dec_cuda(q[:, 0], k, v, torch.ones(1, dtype=torch.int32))


# ------------------------------------------------------------ hd 256 (vlm)
# paligemma-3b's heads: hd 256, G = 8 over one KV head, at a few keys; the
# same inputs through the Pallas kernels (interpret mode) and the port's
# plain versions, which the card's hd-256 kernels are held against
HD256 = dict(H=8, KVH=1, hd=256)


def _paged_pool(rng, B, W, page, KVH, hd):
    """Pools [P + 1, page, KVH, hd] (the port's trash page last) and a
    permuted table [B, W] over the P = B * W real pages."""
    P = B * W
    kp, vp = (rng.standard_normal((P + 1, page, KVH, hd)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(P).reshape(B, W).astype(np.int32)
    return kp, vp, table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas_hd256(dtype):
    """Kernel 1: a 20-token bidirectional prefix (not a multiple of the
    16-key tile) before causal text."""
    (jq, jk, jv), (q, k, v) = _both(
        _qkv(5, 1, 32, 32, HD256["H"], HD256["KVH"], HD256["hd"]), dtype)
    want = fa_pallas(jq, jk, jv, causal=True, prefix_len=20, block_q=16,
                     block_k=16, interpret=True)
    _close(ref.attention_ref(q, k, v, causal=True, prefix_len=20), want,
           dtype)


def test_decode_plain_matches_pallas_hd256():
    """Kernel 2: rows of 1, 9 and all 16 keys."""
    arrs, lens = _dec_inputs(6, 3, 16, HD256["H"], HD256["KVH"],
                             HD256["hd"], (1, 9, 16))
    (jq, jk, jv), (q, k, v) = _both(arrs, "float32")
    want = dec_pallas(jq, jk, jv, jnp.asarray(lens), block_k=16,
                      interpret=True)
    _close(ref.decode_attention_ref(q, k, v, torch.from_numpy(lens)), want,
           "float32")


def test_paged_decode_plain_matches_pallas_hd256():
    """Kernel 4: two rows over pages of 8 (a partial last page)."""
    rng = np.random.default_rng(7)
    kp, vp, table = _paged_pool(rng, 2, 2, 8, HD256["KVH"], HD256["hd"])
    q = rng.standard_normal((2, HD256["H"], HD256["hd"])).astype(np.float32)
    lens = np.asarray([5, 16], np.int32)
    want = pdec_pallas(jnp.asarray(q), jnp.asarray(kp[:-1]),
                       jnp.asarray(vp[:-1]), jnp.asarray(table),
                       jnp.asarray(lens), interpret=True)
    got = ops.paged_decode_attention(*(torch.from_numpy(a) for a in (
        q, kp, vp, table, lens)))
    _close(got, want, "float32")


def test_paged_extend_plain_matches_pallas_hd256():
    """Kernel 5: a 4-token chunk after 3 and 9 cached keys."""
    rng = np.random.default_rng(8)
    kp, vp, table = _paged_pool(rng, 2, 2, 8, HD256["KVH"], HD256["hd"])
    C = 4
    q = rng.standard_normal((2, C, HD256["H"], HD256["hd"])).astype(
        np.float32)
    kn, vn = (rng.standard_normal((2, C, HD256["KVH"], HD256["hd"]))
              .astype(np.float32) for _ in range(2))
    pos = np.asarray([3, 9], np.int32)
    want = pext_pallas(*(jnp.asarray(a) for a in (
        q, kp[:-1], vp[:-1], kn, vn, table, pos)), interpret=True)
    got = ops.paged_extend_attention(*(torch.from_numpy(a) for a in (
        q, kp, vp, kn, vn, table, pos)))
    _close(got, want, "float32")
