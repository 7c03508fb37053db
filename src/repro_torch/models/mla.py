"""Multi-head Latent Attention (DeepSeek-V2).

Port of ``repro/models/mla.py``. The cache holds, per token, the
compressed latent ``ckv`` [kv_lora] (RMS-normalised ``x @ w_dkv``) and one
RoPE key ``kr`` [rope] shared by every head; no per-head K or V is ever
cached.

Prefill runs the *expanded* form: per-head ``k = [ckv @ w_uk | kr]``
(nope + rope wide, 192 at deepseek-v2) and ``v = ckv @ w_uv`` (128), one KV
head per query head, through ``ops.flash_attention`` (kernel 1 on the
card, which takes a q/k width that differs from its v width). Extend and
decode run the *absorbed* form, as the reference does outside any
kernel: ``q_lat = q_nope . w_uk`` (kv_lora wide) scores against ``ckv``,
``q_rope`` against ``kr``, the softmax runs over the cached prefix and the
new tokens, and ``w_uv`` maps the ``ckv``-weighted sum back per head; all
of it fp32 matmuls. The scale is ``1/sqrt(nope + rope)`` in all three.

Weights follow the port's ``[out, in]`` layout (``F.linear``): ``w_dq``
[q_lora, d], ``q_ln`` [q_lora], ``w_uq`` [H*(nope+rope), q_lora],
``w_dkv`` [kv_lora, d], ``kv_ln`` [kv_lora], ``w_kr`` [rope, d], ``w_uk``
[H*nope, kv_lora], ``w_uv`` [H*v, kv_lora], ``wo`` [d, H*v]. Extend and
decode write the new latents into the cache in place, only for the rows
that ``rows`` [B] bool selects (default all).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (
    _cache_insert, _cache_insert_chunk, apply_rope, dense_init, rmsnorm,
    rope_table)


def mla_params(cfg, gen: torch.Generator, dtype) -> dict:
    """One layer's MLA weights from ``gen``, on ``gen.device``."""
    d, H = cfg.d_model, cfg.num_heads
    nope, rope_d, v_hd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
    ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank

    def dense(out_f, in_f):
        return dense_init(gen, (out_f, in_f), in_f, dtype)

    ones = lambda n: torch.ones((n,), dtype=dtype, device=gen.device)
    return {"w_dq": dense(ql, d), "q_ln": ones(ql),
            "w_uq": dense(H * (nope + rope_d), ql),
            "w_dkv": dense(kvl, d), "kv_ln": ones(kvl),
            "w_kr": dense(rope_d, d),
            "w_uk": dense(H * nope, kvl), "w_uv": dense(H * v_hd, kvl),
            "wo": dense(d, H * v_hd)}


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _project_q(cfg, p, x, positions):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope] with RoPE applied)."""
    B, S, _ = x.shape
    nope = cfg.qk_nope_head_dim
    cq = rmsnorm(p["q_ln"], F.linear(x, p["w_dq"]), cfg.norm_eps)
    q = F.linear(cq, p["w_uq"]).view(B, S, cfg.num_heads, -1)
    cos, sin = rope_table(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    return q[..., :nope], apply_rope(q[..., nope:], cos, sin)


def _project_kv_latent(cfg, p, x, positions):
    """(ckv [B,S,kv_lora], kr [B,S,rope] with RoPE applied)."""
    ckv = rmsnorm(p["kv_ln"], F.linear(x, p["w_dkv"]), cfg.norm_eps)
    kr = F.linear(x, p["w_kr"])
    cos, sin = rope_table(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    return ckv, apply_rope(kr[:, :, None, :], cos, sin)[:, :, 0, :]


def mla_prefill(cfg, p, x, positions, *, reference: bool = False):
    """Expanded-form causal attention over ``x`` [B,S,d]. Returns (out
    [B,S,d], (ckv, kr)), the latents for the caller's cache."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope_d, v_hd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
    q_nope, q_rope = _project_q(cfg, p, x, positions)
    ckv, kr = _project_kv_latent(cfg, p, x, positions)
    k_nope = F.linear(ckv, p["w_uk"]).view(B, S, H, nope)
    v = F.linear(ckv, p["w_uv"]).view(B, S, H, v_hd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, rope_d)],
                  dim=-1)
    attend = ref.attention_ref if reference else ops.flash_attention
    o = attend(q, k, v, causal=True)
    return F.linear(o.reshape(B, S, H * v_hd), p["wo"]), (ckv, kr)


def _absorbed(cfg, p, x, cache, pos, positions):
    """The absorbed form's common part: the chunk's projections and its
    scores over the cached prefix (< ``pos``), fp32. Returns (q_lat
    [B,C,H,kv_lora], q_rope32 [B,C,H,rope], ckv_new, kr_new, s [B,H,C,S]).
    Masks fill with a Python scalar: no device constant, so no host
    sync."""
    H, nope = cfg.num_heads, cfg.qk_nope_head_dim
    q_nope, q_rope = _project_q(cfg, p, x, positions)
    ckv_new, kr_new = _project_kv_latent(cfg, p, x, positions)
    w_uk = p["w_uk"].view(H, nope, cfg.kv_lora_rank).float()
    q_lat = torch.einsum("bchn,hnl->bchl", q_nope.float(), w_uk)
    q_rope = q_rope.float()
    ckv_c, kr_c = cache["ckv"], cache["kr"]
    S = ckv_c.shape[1]
    s = (torch.einsum("bchl,bsl->bhcs", q_lat, ckv_c.float())
         + torch.einsum("bchr,bsr->bhcs", q_rope, kr_c.float())) * _scale(cfg)
    past = torch.arange(S, device=x.device)[None, :] >= pos[:, None]
    s = s.masked_fill(past[:, None, None, :], -1e30)
    return q_lat, q_rope, ckv_new, kr_new, s


def _out(cfg, p, out_lat, x):
    """``w_uv`` per head of the ``ckv``-weighted sum [B,H,C,kv_lora], then
    ``wo``: [B,C,d] in x's dtype."""
    B, C = x.shape[:2]
    H, v_hd = cfg.num_heads, cfg.v_head_dim
    w_uv = p["w_uv"].view(H, v_hd, cfg.kv_lora_rank).float()
    o = torch.einsum("bhcl,hvl->bchv", out_lat, w_uv)
    return F.linear(o.reshape(B, C, H * v_hd).to(x.dtype), p["wo"])


def mla_extend(cfg, p, x, cache, pos, rows=None):
    """Absorbed-form chunk continuation. x: [B,C,d]; cache: this layer's
    {"ckv": [B,S,kv_lora], "kr": [B,S,rope]}; pos: [B] valid cached
    tokens. Chunk query j attends to the cached prefix plus chunk
    positions <= j; then the chunk's latents go in at pos..pos+C-1 (rows
    with ``rows[b]`` False write nothing). Returns out [B,C,d]."""
    C = x.shape[1]
    positions = pos[:, None] + torch.arange(C, device=x.device)[None, :]
    q_lat, q_rope, ckv_new, kr_new, s = _absorbed(cfg, p, x, cache, pos,
                                                  positions)
    ckv_n, kr_n = ckv_new.float(), kr_new.float()
    s_new = (torch.einsum("bchl,bjl->bhcj", q_lat, ckv_n)
             + torch.einsum("bchr,bjr->bhcj", q_rope, kr_n)) * _scale(cfg)
    ahead = (torch.arange(C, device=x.device)[:, None]
             < torch.arange(C, device=x.device)[None, :])
    s_new = s_new.masked_fill(ahead, -1e30)
    m = torch.maximum(s.amax(dim=-1), s_new.amax(dim=-1))      # [B,H,C]
    pr = torch.exp(s - m[..., None])
    pr_new = torch.exp(s_new - m[..., None])
    l = pr.sum(dim=-1) + pr_new.sum(dim=-1)
    out_lat = (torch.einsum("bhcs,bsl->bhcl", pr, cache["ckv"].float())
               + torch.einsum("bhcj,bjl->bhcl", pr_new, ckv_n))
    out = _out(cfg, p, out_lat / l[..., None], x)
    _cache_insert_chunk(cache["ckv"], ckv_new, pos, rows)
    _cache_insert_chunk(cache["kr"], kr_new, pos, rows)
    return out


def mla_decode(cfg, p, x, cache, pos, rows=None):
    """Absorbed-form decode: one token [B,1,d] against this layer's latent
    cache (valid < ``pos``) plus its own latents, which then go in at
    ``pos`` (rows with ``rows[b]`` False write nothing). Returns out
    [B,1,d]."""
    q_lat, q_rope, ckv_new, kr_new, s = _absorbed(cfg, p, x, cache, pos,
                                                  pos[:, None])
    ckv_n, kr_n = ckv_new[:, 0].float(), kr_new[:, 0].float()
    s, q_lat, q_rope = s[:, :, 0], q_lat[:, 0], q_rope[:, 0]  # [B,H,*]
    s_new = (torch.einsum("bhl,bl->bh", q_lat, ckv_n)
             + torch.einsum("bhr,br->bh", q_rope, kr_n)) * _scale(cfg)
    m = torch.maximum(s.amax(dim=-1), s_new)
    pr = torch.exp(s - m[..., None])
    pr_new = torch.exp(s_new - m)
    l = pr.sum(dim=-1) + pr_new
    out_lat = (torch.einsum("bhs,bsl->bhl", pr, cache["ckv"].float())
               + pr_new[..., None] * ckv_n[:, None, :])
    out = _out(cfg, p, (out_lat / l[..., None])[:, :, None, :], x)
    _cache_insert(cache["ckv"], ckv_new[:, 0], pos, rows)
    _cache_insert(cache["kr"], kr_new[:, 0], pos, rows)
    return out


def mla_block(cfg, p, x, *, positions, mode: str = "prefill", cache=None,
              pos=None, rows=None, reference: bool = False):
    """``layers.attention_block``'s counterpart: (out, kv). Prefill returns
    ``kv = (ckv, kr)``; a continuation of one token decodes and a longer
    one extends (as the reference picks by the chunk's length, whatever
    the caller's mode), in place, with ``kv = None``."""
    if mode == "prefill":
        return mla_prefill(cfg, p, x, positions, reference=reference)
    if mode not in ("extend", "decode"):
        raise ValueError(f"attention mode {mode!r}")
    step = mla_decode if x.shape[1] == 1 else mla_extend
    return step(cfg, p, x, cache, pos, rows), None
