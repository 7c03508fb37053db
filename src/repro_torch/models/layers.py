"""Dense transformer building blocks (plain PyTorch tensor functions).

Port of the dense parts of ``repro/models/layers.py``, with its paged
(block-table) and int8 KV caches, qk-norm and the encoder-decoder's
cross-attention. Weights follow PyTorch's ``nn.Linear`` layout, ``[out,
in]`` applied with ``F.linear``; ``models.convert`` maps the reference's
``[in, out]`` layout onto it. Norms (qk-norm included) and RoPE compute in
fp32 and cast back.

Attention goes through ``kernels.ops``: on the card prefill runs the flash
kernel (causal, or bidirectional for an encoder), decode the decode
kernels (dense, int8, paged fp or paged int8) and a paged extend the paged
extend kernel; cross-attention runs the flash kernel without the mask in
prefill and extend, and the dense decode kernel over every encoder key in
decode. On the CPU they run their plain versions. ``reference=True``
sends every call to the plain versions on any device, which is the oracle
path ``chip_smoke.py`` compares the card's logits with. Dense and int8
extends are plain PyTorch everywhere, as the reference leaves them to XLA.
Caches are updated in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref


def dense_init(gen: torch.Generator, shape, fan_in: int, dtype):
    """normal / sqrt(fan_in), drawn in fp32 on ``gen.device`` and cast (the
    reference's ``dense_init``)."""
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.div_(math.sqrt(fan_in)).to(dtype)


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


def embed(p, tokens, cfg):
    """Token embeddings; the vlm family scales them by sqrt(d_model)
    (gemma's normalisation)."""
    x = p["embed"][tokens]
    if cfg.family == "vlm":
        x = x * math.sqrt(cfg.d_model)
    return x


def logits(p, x, cfg):
    return F.linear(x, p["embed"] if cfg.tie_embeddings else p["lm_head"])


def cross_entropy(logit, labels, mask=None):
    """Next-token cross-entropy of ``logit`` [..., V] against ``labels``
    [...]: the fp32 log-sum-exp minus the gold logit, averaged (over the
    positions ``mask`` selects, if given). The reference's one-hot
    multiply-reduce is a gather here: the same function, without a
    [..., V] fp32 one-hot on the device."""
    logit = logit.float()
    lse = torch.logsumexp(logit, dim=-1)
    gold = torch.gather(logit, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp(min=1)
    return nll.mean()


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


def _cache_insert(cache, new, pos, rows=None):
    """cache: [B,S,...]; new: [B,...]; pos: [B] — one token per row (rows
    with ``rows[b]`` False write nothing)."""
    _cache_insert_chunk(cache, new[:, None], pos, rows)


# --------------------------------------------------- paged (block-table) KV
# A paged cache leaf is a pool [P + 1, page, KVH, ...]: P pages that rows
# own through a block table [B, W] of page ids, and one trash page, id P,
# which is also the table's sentinel for an unmapped entry. Logical token t
# of row b lives at pool[table[b, t // page], t % page]. The reference
# drops writes through the sentinel (a scatter with mode="drop"); on the
# card an index past the pool is a fault, so here they land in the trash
# page, which no live row reads. Reads clamp ids to the pool, so a
# sentinel reads the trash page, past every live row's length.

def paged_view(pool, table):
    """Dense [B, W*page, ...] view of the pages ``table`` [B, W] names."""
    return ref.paged_gather_ref(pool, table)


def _paged_cache_insert_chunk(pool, new, table, pos, rows=None):
    """Write a C-token chunk [B,C,...] per row at logical offsets
    pos..pos+C-1 through the table, in place. A write through the
    sentinel, past the table's width, or of a row with ``rows[b]`` False
    goes to the trash page (id P = pool.shape[0] - 1) instead."""
    C = new.shape[1]
    page, trash = pool.shape[1], pool.shape[0] - 1
    W = table.shape[1]
    cols = pos.long()[:, None] + torch.arange(C, device=pool.device)[None, :]
    pidx = torch.div(cols, page, rounding_mode="floor")
    phys = torch.gather(table.long(), 1, pidx.clamp(0, W - 1))
    keep = pidx < W
    if rows is not None:
        keep = keep & rows[:, None]
    phys = torch.where(keep, phys.clamp(max=trash), trash)
    pool[phys, cols % page] = new.to(pool.dtype)


def _paged_cache_insert(pool, new, table, pos, rows=None):
    """One token [B,...] per row: ``_paged_cache_insert_chunk`` with C=1."""
    _paged_cache_insert_chunk(pool, new[:, None], table, pos, rows)


def quantize_kv(x):
    """Per-(token, KV head) absmax int8 quantization of K or V.

    x: [..., KVH, hd] -> (q int8 [..., KVH, hd], scale fp32 [..., KVH])."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp(min=1e-30) / 127.0
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequant(c, s, dtype):
    """int8 cache and its scales -> values in ``dtype`` (the reference
    casts the dequantized cache to the activations' dtype)."""
    return (c.float() * s[..., None]).to(dtype)


def _insert_int8(cache, k, v, insert):
    """Quantize the new K/V and write values and scales with ``insert``."""
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    for name, val in (("k", kq), ("k_scale", ks), ("v", vq), ("v_scale", vs)):
        insert(cache[name], val)


def attention_block(cfg, p, x, *, positions, mode: str = "prefill",
                    causal: bool = True, prefix_len: int = 0, cache=None,
                    pos=None, rows=None, table=None, reference: bool = False,
                    qkv_delta=None):
    """Projections (+ qk-norm) + RoPE + attention (+ cache update), GQA.

    Returns (out, kv). ``mode="prefill"``: attention over ``x`` itself
    through the flash kernel, causal unless ``causal`` is False (an
    encoder's, which as in the reference takes no RoPE), with the first
    ``prefix_len`` keys visible to every query (a vlm's patches); ``kv``
    is the layer's (k, v) [B,S,KVH,hd] for the caller's cache. With
    ``cfg.qk_norm`` q and k are RMS-normalised per head (``q_norm``,
    ``k_norm`` [hd]) before RoPE. ``qkv_delta`` (dq, dk, dv) [B,Sq,*],
    if given, is added to the three projections before qk-norm and RoPE
    (the hybrid's per-group LoRA). The other modes continue from
    ``cache``, this layer's leaves: {"k", "v"} [B,S,KVH,hd], plus
    {"k_scale", "v_scale"} [B,S,KVH] when int8; with a block ``table``
    [B,W] they are page pools [P+1,page,KVH,...] instead. They continue at
    per-row offsets ``pos`` [B], update the cache in place and return
    ``kv = None``:

    ``"decode"`` (one token): fp caches insert it, then attend over
    ``pos + 1`` tokens; int8 caches attend over the ``pos`` cached tokens
    dequantized plus the new token at full precision, then insert it
    quantized (as the reference does). Rows with ``rows[b]`` False, if
    given, write nothing; their output is the caller's to drop.
    ``"extend"`` (a chunk of any length): attention over the cached prefix
    and the chunk, then insert, only into the rows that ``rows`` [B] bool
    selects, if given. Rows left out of a paged extend attend to no cached
    token; their output is the caller's to drop.
    """
    hd = cfg.resolved_head_dim
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    B, Sq, _ = x.shape
    q, k, v = (F.linear(x, p[w]) for w in ("wq", "wk", "wv"))
    if qkv_delta is not None:
        q, k, v = (t + d.to(t.dtype) for t, d in zip((q, k, v), qkv_delta))
    q = q.view(B, Sq, H, hd)
    k = k.view(B, Sq, KVH, hd)
    v = v.view(B, Sq, KVH, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if causal or cfg.family != "encdec":
        cos, sin = rope_table(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    int8 = cache is not None and "k_scale" in cache

    kv = None
    if mode == "prefill":
        attend = ref.attention_ref if reference else ops.flash_attention
        o = attend(q, k, v, causal=causal, prefix_len=prefix_len)
        kv = (k, v)
    elif mode == "decode" and table is not None:
        k0, v0 = k[:, 0], v[:, 0]
        attend = (ref.paged_decode_attention_ref if reference
                  else ops.paged_decode_attention)
        if int8:
            o = attend(q[:, 0], cache["k"], cache["v"], table, pos,
                       k_scale=cache["k_scale"], v_scale=cache["v_scale"],
                       k_new=k0, v_new=v0)
            _insert_int8(cache, k0, v0, lambda c, val: _paged_cache_insert(
                c, val, table, pos, rows))
        else:
            _paged_cache_insert(cache["k"], k0, table, pos, rows)
            _paged_cache_insert(cache["v"], v0, table, pos, rows)
            o = attend(q[:, 0], cache["k"], cache["v"], table, pos + 1)
        o = o[:, None]
    elif mode == "decode":
        k0, v0 = k[:, 0], v[:, 0]
        if int8:
            attend = (ref.decode_attention_int8_ref if reference
                      else ops.decode_attention_int8)
            o = attend(q[:, 0], cache["k"], cache["v"], cache["k_scale"],
                       cache["v_scale"], pos, k_new=k0, v_new=v0)
            _insert_int8(cache, k0, v0,
                         lambda c, val: _cache_insert(c, val, pos, rows))
        else:
            kc, vc = cache["k"], cache["v"]
            _cache_insert(kc, k0, pos, rows)
            _cache_insert(vc, v0, pos, rows)
            attend = (ref.decode_attention_ref if reference
                      else ops.decode_attention)
            o = attend(q[:, 0], kc, vc, pos + 1)
        o = o[:, None]
    elif mode == "extend" and table is not None:
        attn_pos = pos if rows is None else torch.where(rows, pos, 0)
        if int8:
            kd = _dequant(paged_view(cache["k"], table),
                          paged_view(cache["k_scale"], table), q.dtype)
            vd = _dequant(paged_view(cache["v"], table),
                          paged_view(cache["v_scale"], table), q.dtype)
            o = extend_attention(q, kd, vd, k, v, attn_pos)
            _insert_int8(cache, k, v, lambda c, val: _paged_cache_insert_chunk(
                c, val, table, pos, rows))
        else:
            attend = (ref.paged_extend_attention_ref if reference
                      else ops.paged_extend_attention)
            o = attend(q, cache["k"], cache["v"], k, v, table, attn_pos)
            _paged_cache_insert_chunk(cache["k"], k, table, pos, rows)
            _paged_cache_insert_chunk(cache["v"], v, table, pos, rows)
    elif mode == "extend":
        if int8:
            kd = _dequant(cache["k"], cache["k_scale"], q.dtype)
            vd = _dequant(cache["v"], cache["v_scale"], q.dtype)
            o = extend_attention(q, kd, vd, k, v, pos)
            _insert_int8(cache, k, v, lambda c, val: _cache_insert_chunk(
                c, val, pos, rows))
        else:
            kc, vc = cache["k"], cache["v"]
            o = extend_attention(q, kc, vc, k, v, pos)
            _cache_insert_chunk(kc, k, pos, rows)
            _cache_insert_chunk(vc, v, pos, rows)
    else:
        raise ValueError(f"attention mode {mode!r}")
    return F.linear(o.reshape(B, Sq, H * hd), p["wo"]), kv


def cross_attention(cfg, p, x, enc_k, enc_v, *, mode: str = "prefill",
                    enc_len=None, reference: bool = False):
    """The decoder's queries over the encoder's K/V ``enc_k``/``enc_v``
    [B,Se,KVH,hd] (the cache's ``enc_kv``), unmasked and with no RoPE on
    either side, as the reference's ``cross_kv`` path. ``mode="decode"``:
    one query a row through the dense decode kernel with every row at
    ``enc_len`` [B] int32 (= Se) keys; prefill and extend: the flash
    kernel without the causal mask, Sq queries over Se keys."""
    hd = cfg.resolved_head_dim
    B, Sq, _ = x.shape
    q = F.linear(x, p["wq"]).view(B, Sq, cfg.num_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
    if mode == "decode":
        attend = (ref.decode_attention_ref if reference
                  else ops.decode_attention)
        o = attend(q[:, 0], enc_k, enc_v, enc_len)[:, None]
    else:
        attend = ref.attention_ref if reference else ops.flash_attention
        o = attend(q, enc_k, enc_v, causal=False)
    return F.linear(o.reshape(B, Sq, cfg.num_heads * hd), p["wo"])
