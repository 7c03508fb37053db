"""Plain PyTorch versions of the ported attention kernels.

Each is the direct O(S²) math in fp32 with the reference's ``-1e30`` mask
and GQA head mapping (query head ``h`` reads KV head ``h // G``). They are
what a wrapper runs for a tensor on the CPU, what ``chip_smoke.py`` holds
each kernel against on the card, and the oracle path of the model's
reference mode.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, prefix_len: int = 0):
    """q: [B,Sq,H,hd]; k/v: [B,Sk,KVH,hd] (GQA). Full Sq×Sk softmax in fp32.

    Under ``causal``, query ``i`` sees keys ``j <= i`` plus every key
    ``j < prefix_len`` (a bidirectional prefix)."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Sk, device=q.device)[None, :]
        mask = (q_pos >= k_pos) | (k_pos < prefix_len)
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q: [B,H,hd]; caches: [B,S,KVH,hd]; lengths: [B] valid tokens
    (including a freshly inserted one). One-token attention over the valid
    prefix of each row."""
    B, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = (q.reshape(B, KVH, G, hd) / math.sqrt(hd)).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, H, hd).to(q.dtype)
