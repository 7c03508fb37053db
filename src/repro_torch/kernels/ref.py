"""Plain PyTorch versions of the ported kernels.

The attention ones are the direct O(S²) math in fp32 with the reference's
``-1e30`` mask and GQA head mapping (query head ``h`` reads KV head
``h // G``); the expert GEMM is one fp32 batched product; WKV6 has its
token-serial definition and the chunked form the model runs. They are what
a wrapper runs for a tensor on the CPU, what ``chip_smoke.py`` holds each
kernel against on the card, and the oracle path of the model's reference
mode. ``attention_lse_ref`` and ``attention_bwd_ref`` are the plain
versions of kernel 1's log-sum-exp output and of its backward kernels,
``expert_matmul_bwd_ref`` that of kernel 6's two; on the CPU autograd
differentiates ``attention_ref`` and ``expert_matmul_ref`` themselves.
"""
from __future__ import annotations

import math

import torch


# the log-sum-exp of a row with nothing visible (kernel 1's kLseEmpty):
# finite, and exp(s - LSE_EMPTY) is 0 for any score
LSE_EMPTY = 1e30


def _masked_scores(q, k, causal: bool, prefix_len: int):
    """Scaled fp32 scores [B,KVH,G,Sq,Sk] of q [B,Sq,H,hd] against k
    [B,Sk,KVH,hd], masked to -1e30 off the visible keys; and the mask
    [Sq,Sk] (None without ``causal``: every key is visible)."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    mask = None
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Sk, device=q.device)[None, :]
        mask = (q_pos >= k_pos) | (k_pos < prefix_len)
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    return s, mask


def _heads_out(o, B, Sq, H):
    """[B,KVH,G,Sq,d] -> [B,Sq,H,d]."""
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, o.shape[-1])


def attention_ref(q, k, v, *, causal: bool = True, prefix_len: int = 0):
    """q: [B,Sq,H,hd]; k: [B,Sk,KVH,hd]; v: [B,Sk,KVH,vd] (GQA; vd may
    differ from hd, as in MLA's expanded prefill) -> [B,Sq,H,vd]. Full
    Sq×Sk softmax in fp32, scores scaled by 1/sqrt(hd).

    Under ``causal``, query ``i`` sees keys ``j <= i`` plus every key
    ``j < prefix_len`` (a bidirectional prefix)."""
    B, Sq, H, _ = q.shape
    s, _ = _masked_scores(q, k, causal, prefix_len)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return _heads_out(o, B, Sq, H).to(q.dtype)


def attention_lse_ref(q, k, v, *, causal: bool = True, prefix_len: int = 0):
    """``attention_ref``'s output and each (row, head)'s log-sum-exp of
    its scaled visible scores, fp32 [B,H,Sq] (``LSE_EMPTY`` for a row
    with no key): what kernel 1 saves for its backward."""
    B, Sq, H, _ = q.shape
    s, _ = _masked_scores(q, k, causal, prefix_len)
    lse = torch.logsumexp(s, dim=-1)                       # [B,KVH,G,Sq]
    lse = torch.where(torch.isfinite(lse), lse,
                      torch.tensor(LSE_EMPTY, device=q.device))
    return (attention_ref(q, k, v, causal=causal, prefix_len=prefix_len),
            lse.reshape(B, H, Sq))


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      prefix_len: int = 0):
    """The gradient of ``attention_ref`` from its output ``o`` and saved
    ``lse`` [B,H,Sq], given the output's gradient ``do`` -> (dq, dk, dv)
    in the inputs' dtypes, in fp32 math: D = sum(dO * O) over the head
    dim, P = exp(S - LSE) on the visible keys and exactly 0 elsewhere, dV
    = P^T dO, dS = P * (dO V^T - D), dQ = dS K / sqrt(hd), dK = dS^T Q /
    sqrt(hd), dK and dV summed over the G query heads of a KV head."""
    B, Sq, H, hd = q.shape
    Sk, KVH, vd = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KVH
    s, mask = _masked_scores(q, k, causal, prefix_len)
    p = torch.exp(s - lse.float().reshape(B, KVH, G, Sq, 1))
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dog = do.float().reshape(B, Sq, KVH, G, vd)
    D = (dog * o.float().reshape(B, Sq, KVH, G, vd)).sum(-1)  # [B,Sq,KVH,G]
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - D.permute(0, 2, 3, 1)[..., None])
    scale = 1.0 / math.sqrt(hd)
    dq = torch.einsum("bkgqs,bskd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(B, Sq, KVH, G, hd)) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return (_heads_out(dq, B, Sq, H).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def _decode_with_fresh(q, k_cache, v_cache, lengths, k_new, v_new):
    """One-token attention over the cached prefix ``< lengths`` (fp32
    caches) plus, when given, the fresh token's own K/V [B,KVH,hd] at full
    precision, folded once after the cached keys."""
    if k_new is None:
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    B, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = (q.reshape(B, KVH, G, hd) / math.sqrt(hd)).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(-1e30, device=q.device))
    s_new = torch.einsum("bkgd,bkd->bkg", qg, k_new.float())
    p = torch.softmax(torch.cat([s, s_new[..., None]], dim=-1), dim=-1)
    o = (torch.einsum("bkgs,bskd->bkgd", p[..., :S], v_cache.float())
         + p[..., S:] * v_new.float()[:, :, None, :])
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention_int8_ref(q, k_cache, v_cache, k_scale, v_scale,
                              lengths, k_new=None, v_new=None):
    """q: [B,H,hd]; int8 caches [B,S,KVH,hd] with per-(token, KV head)
    fp32 scales [B,S,KVH]: dequantize in fp32, then attend over the
    ``lengths`` cached tokens (plus the fresh ``k_new``/``v_new``
    [B,KVH,hd], if given)."""
    kd = k_cache.float() * k_scale.float()[..., None]
    vd = v_cache.float() * v_scale.float()[..., None]
    return _decode_with_fresh(q, kd, vd, lengths, k_new, v_new)


def paged_gather_ref(pool, table):
    """A paged pool [P,page,...] as dense rows through the block table
    [B,W] int32 -> [B, W*page, ...]. Entries past the pool (the sentinel)
    clamp to its last page; what they gather lies past each row's length
    and is masked by the caller."""
    idx = table.long().clamp(0, pool.shape[0] - 1)
    v = pool[idx]                                  # [B, W, page, ...]
    B, W, page = v.shape[:3]
    return v.reshape(B, W * page, *pool.shape[2:])


def paged_decode_attention_ref(q, k_pool, v_pool, table, lengths, *,
                               k_scale=None, v_scale=None, k_new=None,
                               v_new=None):
    """Paged twin of ``decode_attention_ref``: gather the pages the table
    names, attend over the valid prefix (``lengths`` past the table's
    width clamp to it). With ``k_scale``/``v_scale`` [P,page,KVH] the
    pools are int8 and are dequantized in fp32; ``k_new``/``v_new``
    [B,KVH,hd] fold the fresh token in after the cached keys."""
    kc = paged_gather_ref(k_pool, table)
    vc = paged_gather_ref(v_pool, table)
    if k_scale is not None:
        kc = kc.float() * paged_gather_ref(k_scale, table).float()[..., None]
        vc = vc.float() * paged_gather_ref(v_scale, table).float()[..., None]
    return _decode_with_fresh(q, kc, vc, lengths, k_new, v_new)


def paged_extend_attention_ref(q, k_pool, v_pool, k_new, v_new, table, pos):
    """Chunk attention continued from a paged cache. q: [B,C,H,hd] at
    per-row offsets ``pos`` [B]; pools [P,page,KVH,hd]; k/v_new:
    [B,C,KVH,hd], the chunk's own K/V, not yet in the pool. Query ``i``
    of the chunk sees cached positions ``< pos`` plus chunk columns
    ``<= i``."""
    B, C, H, hd = q.shape
    kc = paged_gather_ref(k_pool, table).float()
    vc = paged_gather_ref(v_pool, table).float()
    S, KVH = kc.shape[1], kc.shape[2]
    G = H // KVH
    neg = torch.tensor(-1e30, device=q.device)
    qg = (q.reshape(B, C, KVH, G, hd) / math.sqrt(hd)).float()
    s_c = torch.einsum("bikgd,bskd->bkgis", qg, kc)
    valid = (torch.arange(S, device=q.device)[None, :]
             < pos.to(q.device)[:, None])
    s_c = torch.where(valid[:, None, None, None, :], s_c, neg)
    s_n = torch.einsum("bikgd,bjkd->bkgij", qg, k_new.float())
    tri = (torch.arange(C, device=q.device)[None, :]
           <= torch.arange(C, device=q.device)[:, None])
    s_n = torch.where(tri, s_n, neg)
    p = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1)
    o = (torch.einsum("bkgis,bskd->bkgid", p[..., :S], vc)
         + torch.einsum("bkgij,bjkd->bkgid", p[..., S:], v_new.float()))
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, hd).to(q.dtype)


def expert_matmul_ref(xe, w, fill=None):
    """Capacity-bucketed expert GEMM. xe: [E,C,D]; w: [E,D,F]; ``fill``
    [E] int (default C) counts each expert's valid rows. Returns [E,C,F]
    in xe's dtype: the fp32 product, with rows ``>= fill[e]`` zeroed."""
    y = torch.bmm(xe.float(), w.float())
    if fill is not None:
        row = torch.arange(xe.shape[1], device=xe.device)[None, :, None]
        y = torch.where(row < fill.to(xe.device)[:, None, None], y, 0.0)
    return y.to(xe.dtype)


def expert_matmul_bwd_ref(xe, w, fill, dy):
    """The gradient of ``expert_matmul_ref`` given its output's gradient
    ``dy`` [E,C,F] -> (dxe [E,C,D] in xe's dtype, dw [E,D,F] in w's), in
    fp32 products: dy's rows at or past ``fill[e]`` (default C) are zeroed
    (the output there is a constant), then dxe = dy w^T and dw = xe^T dy,
    as autograd of ``expert_matmul_ref`` computes them."""
    dy = dy.float()
    if fill is not None:
        row = torch.arange(xe.shape[1], device=xe.device)[None, :, None]
        dy = torch.where(row < fill.to(xe.device)[:, None, None], dy, 0.0)
    dxe = torch.bmm(dy, w.float().transpose(1, 2))
    dw = torch.bmm(xe.float().transpose(1, 2), dy)
    return dxe.to(xe.dtype), dw.to(w.dtype)


def wkv6_ref(r, k, v, logw, u, state0):
    """Token-by-token WKV6 recurrence (the definitional form).

    r/k/v/logw: [B,S,H,hd]; u: [H,hd]; state0: [B,H,hd,hd]::

        S_t   = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
        out_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

    Returns (out [B,S,H,hd] fp32, state [B,H,hd,hd] fp32)."""
    r, k, v, w = (a.float() for a in (r, k, v, logw))
    u = u.float()
    S = state0.float()
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t = r[:, t], k[:, t], v[:, t]
        rk_u = (r_t * u[None] * k_t).sum(-1)                 # [B,H]
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t, S)
                    + rk_u[..., None] * v_t)
        S = (torch.exp(w[:, t])[..., None] * S
             + k_t[..., :, None] * v_t[..., None, :])
    out = torch.stack(outs, 1) if outs else torch.zeros_like(r)
    return out, S


WKV6_CHUNK = 32


def wkv6_chunked_ref(r, k, v, logw, u, state0, chunk: int = WKV6_CHUNK,
                     chunk_states: bool = False):
    """The chunked form of ``wkv6_ref`` (``repro/models/rwkv6.py``
    ``wkv6_chunked``), for any S: chunks of ``chunk`` tokens, the last one
    shorter. Within a chunk, with c the inclusive cumsum of logw:
    decayed strictly causal scores (r e^{c_prev})(k e^{-c})^T, the bonus
    diagonal, the carried state's term (r e^{c_prev}) S, and the carry
    S <- e^{c_last} S + (k e^{c_last - c})^T v. At the model's clamp
    (logw >= -1.5) a 32-token chunk keeps every factor within e^{±48}, in
    fp32 range. Returns (out fp32, state fp32) like ``wkv6_ref``; with
    ``chunk_states`` also the state at each chunk's start, [B,
    ceil(S/chunk), H, hd, hd] fp32 (the first is ``state0``): what kernel
    7 saves for its backward."""
    B, S, H, hd = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, logw))
    u = u.float()
    st = state0.float()
    outs, starts = [], []
    for t0 in range(0, S, chunk):
        starts.append(st)
        sl = slice(t0, min(t0 + chunk, S))
        r_i, k_i, v_i, w_i = r[:, sl], k[:, sl], v[:, sl], w[:, sl]
        C = r_i.shape[1]
        c = torch.cumsum(w_i, dim=1)
        A = r_i * torch.exp(c - w_i)
        Bm = k_i * torch.exp(-c)
        tri = torch.tril(torch.ones((C, C), device=r.device), diagonal=-1)
        s = torch.einsum("bthd,bjhd->bhtj", A, Bm) * tri
        diag = (r_i * u[None, None] * k_i).sum(-1)           # [B,C,H]
        out = (torch.einsum("bhtj,bjhd->bthd", s, v_i) + diag[..., None] * v_i
               + torch.einsum("bthk,bhkv->bthv", A, st))
        c_last = c[:, -1:]
        k_dec = k_i * torch.exp(c_last - c)
        st = (torch.exp(c_last[:, 0])[..., None] * st
              + torch.einsum("bthk,bthv->bhkv", k_dec, v_i))
        outs.append(out)
    out = torch.cat(outs, 1) if outs else torch.zeros_like(r)
    if chunk_states:
        states = (torch.stack(starts, 1) if starts
                  else st.new_zeros((B, 0, H, hd, hd)))
        return out, st, states
    return out, st


def wkv6_bwd_ds_ref(r, logw, dout, dstate=None, chunk: int = WKV6_CHUNK):
    """The dS pass of ``wkv6_chunked_bwd_ref``: the gradient of the state
    at each chunk's end, walking the chunks in reverse from the final
    state's ``dstate`` [B,H,hd,hd] (None: zero), dS <- e^{c_L} dS + A^T
    dout with A = r e^{c_prev} (c the inclusive cumsum of logw inside the
    chunk, c_prev = c - logw, c_L its last row). r/logw/dout [B,S,H,hd] ->
    (ds [B, ceil(S/chunk), H, hd, hd], whose entry i is dS at chunk i's end
    (the last is dstate), dstate0 [B,H,hd,hd]), fp32: what kernel 7-bwd's
    local and scan passes compute. Only r, logw and dout enter it."""
    B, S, H, hd = r.shape
    rf, wf, do = (a.float() for a in (r, logw, dout))
    dS = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
          if dstate is None else dstate.float())
    n = (S + chunk - 1) // chunk
    ds = [None] * n
    for i in reversed(range(n)):
        ds[i] = dS
        sl = slice(i * chunk, min((i + 1) * chunk, S))
        r_i, w_i, do_i = rf[:, sl], wf[:, sl], do[:, sl]
        c = torch.cumsum(w_i, dim=1)
        A = r_i * torch.exp(c - w_i)
        e_last = torch.exp(c[:, -1])                          # [B,H,hd]
        dS = (e_last[..., None] * dS
              + torch.einsum("bthk,bthv->bhkv", A, do_i))
    ds = (torch.stack(ds, 1) if n
          else dS.new_zeros((B, 0, H, hd, hd)))
    return ds, dS


def wkv6_chunked_bwd_ref(r, k, v, logw, u, state0, chunk_states, dout,
                         dstate=None, chunk: int = WKV6_CHUNK):
    """The gradient of ``wkv6_chunked_ref`` from ``state0`` and the later
    chunk-start states it saves (``chunk_states`` [B,n,H,hd,hd], whose
    first is state0), given the output's gradient
    ``dout`` [B,S,H,hd] and the final state's ``dstate`` [B,H,hd,hd]
    (None: zero) -> (dr, dk, dv in r's dtype, dlogw fp32, du [H,hd] fp32,
    dstate0 fp32), in explicit fp32 formulas, not autograd: what kernel
    7-bwd computes. The dS pass (``wkv6_bwd_ds_ref``) gives dS, the
    gradient of the state at each chunk's end, and dstate0; then each
    chunk's gradients follow from its inputs, S0 and dS. Within a chunk
    (c the inclusive cumsum of logw, c_prev = c - logw, c_L its last row; A = r
    e^{c_prev}, Bm = k e^{-c}, Kd = k e^{c_L - c}, P[t, j] = A_t . Bm_j
    below the diagonal and the bonus r_t . (u k_t) on it, dP[t, j] =
    dout_t . v_j likewise, dd_t on the diagonal)::

        dv_t   = sum_{s>=t} P[s, t] dout_s + Kd_t dS
        dA_t   = sum_{j<t} dP[t, j] Bm_j + S0 dout_t
        dBm_j  = sum_{t>j} dP[t, j] A_t
        dKd_t  = dS v_t
        dr_t   = dA_t e^{c_prev_t} + dd_t u k_t
        dk_t   = dBm_t e^{-c_t} + dKd_t e^{c_L - c_t} + dd_t u r_t
        du    += sum_t dd_t r_t k_t
        dlogw_s = sum_{t>=s} x_t + sum_{t>s} y_t + dc_L, with
                  x_t = -(dBm_t Bm_t + dKd_t Kd_t) (through c_t),
                  y_t = dA_t A_t (through c_prev_t),
                  dc_L = sum_t dKd_t Kd_t + e^{c_L} rowsum(dS * S0)
        dS    <- e^{c_L} dS + A^T dout  (the previous chunk's, then
                  dstate0: the dS pass)

    The bonus gives du and nothing to dlogw. Every product is fp32."""
    B, S, H, hd = r.shape
    f = lambda a: a.float()
    rf, kf, vf, wf, do = f(r), f(k), f(v), f(logw), f(dout)
    u = f(u)
    ds, dstate0 = wkv6_bwd_ds_ref(r, logw, dout, dstate, chunk)
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    du = torch.zeros((H, hd), dtype=torch.float32, device=r.device)
    for i in reversed(range(0, (S + chunk - 1) // chunk)):
        dS = ds[:, i]
        sl = slice(i * chunk, min((i + 1) * chunk, S))
        r_i, k_i, v_i, w_i, do_i = (a[:, sl] for a in (rf, kf, vf, wf, do))
        S0 = f(state0 if i == 0 else chunk_states[:, i])    # [B,H,hd,hd]
        C = r_i.shape[1]
        c = torch.cumsum(w_i, dim=1)
        c_prev = c - w_i
        c_last = c[:, -1:]
        A = r_i * torch.exp(c_prev)
        Bm = k_i * torch.exp(-c)
        Kd = k_i * torch.exp(c_last - c)
        tri = torch.tril(torch.ones((C, C), device=r.device), diagonal=-1)
        eye = torch.eye(C, device=r.device)
        diag = (r_i * u[None, None] * k_i).sum(-1)            # [B,C,H]
        dd = (do_i * v_i).sum(-1)                             # [B,C,H]
        P = (torch.einsum("bthd,bjhd->bhtj", A, Bm) * tri
             + torch.einsum("bth,tj->bhtj", diag, eye))
        dP = torch.einsum("bthd,bjhd->bhtj", do_i, v_i) * tri
        dv[:, sl] = (torch.einsum("bhst,bshd->bthd", P, do_i)
                     + torch.einsum("bthk,bhkv->bthv", Kd, dS))
        dA = (torch.einsum("bhtj,bjhd->bthd", dP, Bm)
              + torch.einsum("bhkv,bthv->bthk", S0, do_i))
        dBm = torch.einsum("bhtj,bthd->bjhd", dP, A)
        dKd = torch.einsum("bhkv,bthv->bthk", dS, v_i)
        uk = u[None, None] * k_i
        dr[:, sl] = dA * torch.exp(c_prev) + dd[..., None] * uk
        dk[:, sl] = (dBm * torch.exp(-c) + dKd * torch.exp(c_last - c)
                     + dd[..., None] * u[None, None] * r_i)
        du += (dd[..., None] * r_i * k_i).sum((0, 1))
        x = -(dBm * Bm + dKd * Kd)
        y = dA * A
        e_last = torch.exp(c_last[:, 0])                      # [B,H,hd]
        dc_last = (dKd * Kd).sum(1) + e_last * (dS * S0).sum(-1)
        rev = lambda a: torch.flip(torch.cumsum(torch.flip(a, [1]), 1), [1])
        dw[:, sl] = rev(x) + rev(y) - y + dc_last[:, None]
    to = lambda a: a.to(r.dtype)
    return to(dr), to(dk), to(dv), dw, du, dstate0
