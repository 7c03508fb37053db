"""Dispatch point between the hand-written kernels and their plain versions.

A tensor on the CPU goes to the plain PyTorch version in ``ref`` (which
autograd differentiates); a CUDA tensor goes to the kernel, for every
shape, and the kernel's wrapper raises on what it does not take.
``flash_attention`` on CUDA tensors with grad enabled and an input that
requires grad goes through ``FlashAttentionFn`` instead: kernel 1 with its
LSE output forward, its three backward kernels backward; ``expert_matmul``
likewise through ``ExpertMatmulFn``: kernel 6 forward, its dX and dW
kernels backward; ``wkv6`` through ``WKV6Fn``: kernel 7 with its
chunk-state output forward, kernel 7-bwd backward. Serving builds no
graph, so it launches the forward kernels alone. There is no fallback from
one to the other: the reference package's TPU tiling guards (shapes that
do not tile went to the XLA version) do not carry over, because the CUDA
kernels mask their own ragged edges.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    decode_attention as _decode_kernel)
from repro_torch.kernels.decode_attention_int8 import (
    decode_attention_int8 as _decode_int8_kernel)
from repro_torch.kernels.expert_matmul import (
    ExpertMatmulFn, expert_matmul as _expert_matmul_kernel)
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn, flash_attention as _flash_kernel)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention as _paged_decode_kernel,
    paged_decode_attention_int8 as _paged_decode_int8_kernel)
from repro_torch.kernels.paged_extend_attention import (
    paged_extend_attention as _paged_extend_kernel)
from repro_torch.kernels.wkv6 import WKV6Fn, wkv6 as _wkv6_kernel


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, prefix_len: int = 0):
    """q [B,Sq,H,hd], k [B,Sk,KVH,hd], v [B,Sk,KVH,vd] -> [B,Sq,H,vd]
    (vd = hd, or MLA's 128 under q/k 192). Differentiable on either
    device."""
    if _on_cpu(q):
        return ref.attention_ref(q, k, v, causal=causal,
                                 prefix_len=prefix_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, prefix_len)
    return _flash_kernel(q, k, v, causal=causal, prefix_len=prefix_len)


def decode_attention(q, k_cache, v_cache, lengths):
    """[B,H,hd] against ragged [B,S,KVH,hd] caches -> [B,H,hd]; ``lengths``
    counts each row's valid tokens, the new one included."""
    if _on_cpu(q):
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths)
    return _decode_kernel(q, k_cache, v_cache, lengths)


def decode_attention_int8(q, k_cache, v_cache, k_scale, v_scale, lengths, *,
                          k_new=None, v_new=None):
    """[B,H,hd] against int8 [B,S,KVH,hd] caches with [B,S,KVH] scales ->
    [B,H,hd]; ``lengths`` counts the cached tokens, and the fresh
    ``k_new``/``v_new`` [B,KVH,hd], if given, are attended after them."""
    if _on_cpu(q):
        return ref.decode_attention_int8_ref(q, k_cache, v_cache, k_scale,
                                             v_scale, lengths, k_new, v_new)
    return _decode_int8_kernel(q, k_cache, v_cache, k_scale, v_scale,
                               lengths, k_new=k_new, v_new=v_new)


def paged_decode_attention(q, k_pool, v_pool, table, lengths, *,
                           k_scale=None, v_scale=None, k_new=None,
                           v_new=None):
    """[B,H,hd] against page pools [P,page,KVH,hd] through the block table
    [B,W] -> [B,H,hd]. fp pools: ``lengths`` counts the inserted new
    token. int8 pools (``k_scale``/``v_scale`` [P,page,KVH]): ``lengths``
    counts the cached tokens and ``k_new``/``v_new`` fold the fresh one."""
    if _on_cpu(q):
        return ref.paged_decode_attention_ref(
            q, k_pool, v_pool, table, lengths, k_scale=k_scale,
            v_scale=v_scale, k_new=k_new, v_new=v_new)
    if k_scale is None:
        if k_new is not None:
            raise ValueError("the fp paged decode attends an inserted token; "
                             "k_new/v_new go with int8 pools")
        return _paged_decode_kernel(q, k_pool, v_pool, table, lengths)
    return _paged_decode_int8_kernel(q, k_pool, v_pool, k_scale, v_scale,
                                     table, lengths, k_new=k_new, v_new=v_new)


def paged_extend_attention(q, k_pool, v_pool, k_new, v_new, table, pos):
    """Chunk [B,C,H,hd] continued from page pools at per-row offsets
    ``pos`` [B], its own K/V ``k_new``/``v_new`` [B,C,KVH,hd] under the
    causal triangle -> [B,C,H,hd]."""
    if _on_cpu(q):
        return ref.paged_extend_attention_ref(q, k_pool, v_pool, k_new,
                                              v_new, table, pos)
    return _paged_extend_kernel(q, k_pool, v_pool, k_new, v_new, table, pos)


def expert_matmul(xe, w, fill=None):
    """Capacity-bucketed expert GEMM [E,C,D] x [E,D,F] -> [E,C,F] in xe's
    dtype, fp32 accumulation; rows at or past ``fill[e]`` are zero.
    Differentiable on either device."""
    if _on_cpu(xe):
        return ref.expert_matmul_ref(xe, w, fill)
    if torch.is_grad_enabled() and (xe.requires_grad or w.requires_grad):
        return ExpertMatmulFn.apply(xe, w, fill)
    return _expert_matmul_kernel(xe, w, fill)


def wkv6(r, k, v, logw, u, state0):
    """WKV6 over a segment [B,S,H,hd] from the carried state [B,H,hd,hd]
    -> (out fp32, final state fp32). Differentiable on either device."""
    if _on_cpu(r):
        return ref.wkv6_chunked_ref(r, k, v, logw, u, state0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, state0)):
        return WKV6Fn.apply(r, k, v, logw, u, state0)
    return _wkv6_kernel(r, k, v, logw, u, state0)
