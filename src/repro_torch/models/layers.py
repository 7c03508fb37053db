"""Dense transformer building blocks (plain PyTorch tensor functions).

Port of the dense, non-int8 parts of ``repro/models/layers.py``. Weights
follow PyTorch's ``nn.Linear`` layout, ``[out, in]`` applied with
``F.linear``; ``models.convert`` maps the reference's ``[in, out]`` layout
onto it. Norms and RoPE compute in fp32 and cast back.

Attention goes through ``kernels.ops``: prefill to the flash kernel and
decode to the decode kernel on the card (their plain versions on the CPU);
``reference=True`` sends both to the plain versions on any device, which is
the oracle path ``chip_smoke.py`` compares the card's logits with. The
cache is updated in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref


def rmsnorm(scale, x, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_table(positions, head_dim: int, theta: float):
    """positions: int tensor [...]; returns (cos, sin) [..., head_dim/2]."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [..., S, H, D]; cos/sin: [..., S, D/2] broadcast over heads. The
    two halves rotate together (no interleaving)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def mlp(p, x):
    h = F.silu(F.linear(x, p["w_gate"])) * F.linear(x, p["w_up"])
    return F.linear(h, p["w_down"])


def embed(p, tokens):
    return p["embed"][tokens]


def logits(p, x, cfg):
    return F.linear(x, p["embed"] if cfg.tie_embeddings else p["lm_head"])


def extend_attention(q, k_cache, v_cache, k_new, v_new, pos):
    """Chunk attention against a [B,S,KVH,hd] cache (prefill continuation).

    q: [B,C,H,hd]; k_new/v_new: [B,C,KVH,hd], the chunk's own K/V, not yet
    in the cache; ``pos``: [B] valid cached tokens per row. Query ``j`` of
    the chunk attends to the cached prefix (< pos) plus chunk positions
    <= j."""
    B, C, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    neg = torch.tensor(-1e30, device=q.device)
    qg = (q.reshape(B, C, KVH, G, hd) * (1.0 / math.sqrt(hd))).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float())
    valid = torch.arange(S, device=q.device)[None, :] < pos[:, None]
    s = torch.where(valid[:, None, None, None, :], s, neg)
    s_new = torch.einsum("bqkgd,bjkd->bkgqj", qg, k_new.float())
    tri = (torch.arange(C, device=q.device)[:, None]
           >= torch.arange(C, device=q.device)[None, :])
    s_new = torch.where(tri, s_new, neg)
    m = torch.maximum(s.amax(dim=-1), s_new.amax(dim=-1))
    p = torch.exp(s - m[..., None])
    p_new = torch.exp(s_new - m[..., None])
    l = p.sum(dim=-1) + p_new.sum(dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v_cache.float())
    o = o + torch.einsum("bkgqj,bjkd->bkgqd", p_new, v_new.float())
    o = o / l[..., None]
    o = o.permute(0, 3, 1, 2, 4).reshape(B, C, H, v_cache.shape[-1])
    return o.to(q.dtype)


def _cache_insert_chunk(cache, new, pos, rows=None):
    """Write a C-token chunk into cache [B,S,...] at per-row offsets
    pos..pos+C-1, in place. Writes at positions >= S, and every write of a
    row with ``rows[b]`` False, are dropped.

    The reference's scatter drops out-of-range writes silently; on the card
    an out-of-range index is a device-side assert, and a free slot's
    ``pos`` grows without bound. So a dropped write is sent to
    ``col % S`` with the value already there: for C <= S those targets are
    distinct and miss every kept write of the row, and no host sync is
    needed to find them."""
    B, C = new.shape[0], new.shape[1]
    S = cache.shape[1]
    if C > S:
        raise ValueError(f"chunk of {C} tokens does not fit a cache of {S}")
    cols = pos.long()[:, None] + torch.arange(C, device=cache.device)[None, :]
    keep = cols < S
    if rows is not None:
        keep = keep & rows[:, None]
    tgt = cols % S
    bidx = torch.arange(B, device=cache.device)[:, None].expand(B, C)
    keep = keep.reshape(B, C, *([1] * (new.dim() - 2)))
    cache[bidx, tgt] = torch.where(keep, new.to(cache.dtype), cache[bidx, tgt])


def _cache_insert(cache, new, pos):
    """cache: [B,S,...]; new: [B,...]; pos: [B] — one token per row."""
    _cache_insert_chunk(cache, new[:, None], pos)


def attention_block(cfg, p, x, *, positions, mode: str = "prefill",
                    cache=None, pos=None, rows=None, reference: bool = False):
    """Projections + RoPE + attention (+ cache update), dense GQA.

    Returns (out, kv). ``mode="prefill"``: causal attention over ``x``
    itself through the flash kernel; ``kv`` is the layer's (k, v)
    [B,S,KVH,hd] for the caller's cache. The other modes continue from
    ``cache`` ({"k", "v"} [B,S,KVH,hd] of this layer) at per-row offsets
    ``pos`` [B], update it in place and return ``kv = None``:
    ``"decode"`` (one token: insert it, then the decode kernel over
    ``pos + 1`` tokens) and ``"extend"`` (a chunk of any length: plain
    attention over the cached prefix and the chunk, then insert, only into
    the rows that ``rows`` [B] bool selects, if given).
    """
    hd = cfg.resolved_head_dim
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    B, Sq, _ = x.shape
    q = F.linear(x, p["wq"]).view(B, Sq, H, hd)
    k = F.linear(x, p["wk"]).view(B, Sq, KVH, hd)
    v = F.linear(x, p["wv"]).view(B, Sq, KVH, hd)
    cos, sin = rope_table(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    kv = None
    if mode == "prefill":
        if reference:
            o = ref.attention_ref(q, k, v, causal=True)
        else:
            o = ops.flash_attention(q, k, v, causal=True)
        kv = (k, v)
    elif mode == "decode":
        kc, vc = cache["k"], cache["v"]
        _cache_insert(kc, k[:, 0], pos)
        _cache_insert(vc, v[:, 0], pos)
        attend = ref.decode_attention_ref if reference else ops.decode_attention
        o = attend(q[:, 0], kc, vc, pos + 1)[:, None]
    elif mode == "extend":
        kc, vc = cache["k"], cache["v"]
        o = extend_attention(q, kc, vc, k, v, pos)
        _cache_insert_chunk(kc, k, pos, rows)
        _cache_insert_chunk(vc, v, pos, rows)
    else:
        raise ValueError(f"attention mode {mode!r}")
    return F.linear(o.reshape(B, Sq, H * hd), p["wo"]), kv
