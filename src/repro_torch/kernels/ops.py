"""Dispatch point between the hand-written kernels and their plain versions.

A tensor on the CPU goes to the plain PyTorch version in ``ref``; a CUDA
tensor goes to the kernel, for every shape, and the kernel's wrapper raises
on what it does not take. There is no fallback from one to the other: the
reference package's TPU tiling guards (shapes that do not tile went to the
XLA version) do not carry over, because the CUDA kernels mask their own
ragged edges.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    decode_attention as _decode_kernel)
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_kernel)


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"no attention path for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, prefix_len: int = 0):
    """[B,Sq,H,hd] x [B,Sk,KVH,hd]² -> [B,Sq,H,hd]."""
    if _on_cpu(q):
        return ref.attention_ref(q, k, v, causal=causal,
                                 prefix_len=prefix_len)
    return _flash_kernel(q, k, v, causal=causal, prefix_len=prefix_len)


def decode_attention(q, k_cache, v_cache, lengths):
    """[B,H,hd] against ragged [B,S,KVH,hd] caches -> [B,H,hd]; ``lengths``
    counts each row's valid tokens, the new one included."""
    if _on_cpu(q):
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths)
    return _decode_kernel(q, k_cache, v_cache, lengths)
