"""RWKV6 (Finch): attention-free time-mix with data-dependent decay.

Port of ``repro/models/rwkv6.py``. Per head, with state S [hd, hd]::

    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
    out_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

A prefill or extend segment runs the recurrence through ``ops.wkv6``:
kernel 7 on the card, the chunked plain form on the CPU. A decode step is
the plain token-serial recurrence ``ref.wkv6_ref`` over its one token, as
in the reference, where it is left to XLA. One deliberate difference: the
reference picks the step by length (any one-token segment, an engine's
1-token extend chunk too), the port by call (``step``), so that every
admission call of the engine runs kernel 7 and its launches are a plain
count of the engine's admission calls. The two forms agree to fp32
rounding.

The per-token log decay is clamped to [LOG_W_MIN, LOG_W_MAX], so a
32-token chunk keeps the chunked form's ``exp(-cumsum)`` inside fp32
range (a documented deviation of the reference from unclamped Finch).

Matrices use PyTorch's ``[out, in]`` layout, applied with ``F.linear``;
the interpolation weights ``mu_*``, ``decay_base``, ``bonus_u`` [H, hd]
and the norm scales keep the reference's shapes. ``decay_base`` and
``bonus_u`` are fp32 whatever the model's dtype.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import dense_init, rmsnorm

LOG_W_MIN = -1.5
LOG_W_MAX = -1e-6
DDLERP_RANK = 32   # rank of the decay's data-dependent (LoRA) term

MATRICES = ("w_r", "w_k", "w_v", "w_g", "w_o", "w_decay_a", "w_decay_b",
            "cm_k", "cm_v", "cm_r")
FP32_LEAVES = ("decay_base", "bonus_u")


def rwkv6_params(cfg, gen: torch.Generator, dtype) -> dict:
    """One layer's weights on ``gen.device``: projections [out, in] normal
    / sqrt(in), as the reference's ``dense_init``."""
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    if H * hd != d:
        raise ValueError("rwkv6 time-mix needs heads * head_dim == d_model")
    full = lambda v, dt=dtype: torch.full((d,), v, dtype=dt,
                                          device=gen.device)
    lin = lambda out_f, in_f, dt=dtype: dense_init(gen, (out_f, in_f), in_f,
                                                   dt)
    p = {name: lin(d, d) for name in ("w_r", "w_k", "w_v", "w_g", "w_o")}
    p.update({f"mu_{s}": full(0.5) for s in "rkvgw"})
    p["w_decay_a"] = lin(DDLERP_RANK, d)
    p["w_decay_b"] = lin(d, DDLERP_RANK)
    p["decay_base"] = full(-1.0, torch.float32)
    p["bonus_u"] = lin(H, hd, torch.float32)
    p["ln_x"] = full(1.0)
    p["cm_k"] = lin(cfg.d_ff, d)
    p["cm_v"] = lin(d, cfg.d_ff)
    p["cm_r"] = lin(d, d)
    p["cm_mu_k"], p["cm_mu_r"] = full(0.5), full(0.5)
    p["ln1"], p["ln2"] = full(1.0), full(1.0)
    return p


def _token_shift(x, prev):
    """x: [B,S,D]; prev: [B,D], the previous segment's last token."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _lerp(x, shifted, mu):
    return x + (shifted - x) * mu


def _log_decay(p, xw):
    """Data-dependent per-channel log decay in [LOG_W_MIN, LOG_W_MAX]."""
    lora = F.linear(torch.tanh(F.linear(xw, p["w_decay_a"])), p["w_decay_b"])
    raw = p["decay_base"].float() + lora.float()
    return (-F.softplus(raw)).clamp(LOG_W_MIN, LOG_W_MAX)


def _group_norm(x, scale, eps):
    """Per-head RMS norm of the wkv output. x: [B,S,H,hd]; scale: [D]."""
    B, S, H, hd = x.shape
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return y.reshape(B, S, H * hd) * scale.float()


def time_mix(cfg, p, x, tm_state, wkv_state, *, step: bool = False,
             reference: bool = False, wkv_chunk: int = ref.WKV6_CHUNK):
    """x: [B,S,D]; tm_state: [B,D]; wkv_state: [B,H,hd,hd] fp32. ``step``
    (a decode, S = 1) takes the recurrent step, otherwise the segment
    goes through the scan; ``reference`` scans with the plain chunked form
    at ``wkv_chunk`` tokens a chunk. Returns (out [B,S,D], new tm_state,
    new wkv_state)."""
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    sx = _token_shift(x, tm_state)
    proj = lambda s, w: F.linear(_lerp(x, sx, p[f"mu_{s}"]), p[w])
    r = proj("r", "w_r").view(B, S, H, hd)
    k = proj("k", "w_k").view(B, S, H, hd)
    v = proj("v", "w_v").view(B, S, H, hd)
    g = F.silu(proj("g", "w_g"))
    logw = _log_decay(p, _lerp(x, sx, p["mu_w"])).view(B, S, H, hd)
    u = p["bonus_u"].float()
    if step:
        scan = ref.wkv6_ref
    elif reference:
        scan = functools.partial(ref.wkv6_chunked_ref, chunk=wkv_chunk)
    else:
        scan = ops.wkv6
    out, new_wkv = scan(r, k, v, logw.contiguous(), u, wkv_state)
    out = _group_norm(out, p["ln_x"], cfg.norm_eps).to(x.dtype)
    return F.linear(out * g, p["w_o"]), x[:, -1, :], new_wkv


def channel_mix(cfg, p, x, cm_state):
    """Squared-ReLU channel mix. cm_state: [B,D] last-token carry."""
    sx = _token_shift(x, cm_state)
    xk = _lerp(x, sx, p["cm_mu_k"])
    xr = _lerp(x, sx, p["cm_mu_r"])
    h = torch.relu(F.linear(xk, p["cm_k"])).square()
    out = torch.sigmoid(F.linear(xr, p["cm_r"])) * F.linear(h, p["cm_v"])
    return out, x[:, -1, :]


def rwkv6_state_init(cfg, batch: int, device) -> dict:
    """Zeroed recurrent state (this family's decode cache) [L, B, ...]."""
    H, hd, L, d = (cfg.num_heads, cfg.resolved_head_dim, cfg.num_layers,
                   cfg.d_model)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return {"wkv": z(L, batch, H, hd, hd), "tm": z(L, batch, d),
            "cm": z(L, batch, d)}


def rwkv6_block(cfg, p, x, state: dict, **scan):
    """One layer (pre-norm time-mix + channel-mix). ``state``: this
    layer's {"tm", "cm", "wkv"}; ``scan``: ``time_mix``'s keywords.
    Returns (x, the new state, fp32)."""
    h, tm, wkv = time_mix(cfg, p, rmsnorm(p["ln1"], x, cfg.norm_eps),
                          state["tm"], state["wkv"], **scan)
    x = x + h
    h, cm = channel_mix(cfg, p, rmsnorm(p["ln2"], x, cfg.norm_eps),
                        state["cm"])
    return x + h, {"tm": tm.float(), "cm": cm.float(), "wkv": wkv}
