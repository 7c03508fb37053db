"""Mamba2 (SSD) block: the zamba2-7b hybrid's backbone.

Port of ``repro/models/mamba2.py``. Per head ``h`` with scalar decay and
state ``S`` [P, N] (P the SSM head dim, N the state size)::

    a_t = exp(-dt_t * A_h)                      (dt_t = softplus(raw), A_h > 0)
    S_t = a_t S_{t-1} + (dt_t x_t) B_t^T
    y_t = S_t C_t + D_h x_t

A segment of more than one token (prefill, extend) takes the chunked SSD
form, a single token (decode, or an extend chunk of one) the recurrent
update, as in the reference. The reference computes SSD in XLA, with no
Pallas kernel, so this is plain PyTorch on every device. The causal
depthwise conv (width 4) over x/B/C carries its last ``width - 1`` inputs
as state. The per-token log decay is clamped to ``LOG_A_MIN``.

One deliberate difference in ``ssd_chunked``: the intra-chunk decay
``exp(cum_t - cum_j)`` is taken after the causal mask, so the entries
j > t are ``exp(-inf) = 0``. The reference exponentiates first and masks
after; past a 32-token chunk at the decay clamp ``cum_t - cum_j`` passes
fp32's range there, and ``inf * 0`` gives NaN. The two agree to rounding
at every chunk where the reference stays finite. The terms inside a chunk
(scores, decays, each chunk's contribution to the state) are computed for
all chunks at once; only the carry of the state from chunk to chunk is a
loop. Every product is a two-operand einsum after an explicit elementwise
scale, so no order of contraction can form a [B, n, C, H, P, N] tensor:
the reference's three-operand ``einsum("bth,bhpn,btn->bthp", ...)``,
contracted left to right as torch does without ``opt_einsum``, forms that
outer product first (7.5 GB a layer at zamba2-7b's width and 4096 tokens,
saved for the backward). Each decay scales the N-wide side (C_t, or B_j)
before the contraction: the order ``opt_einsum`` takes for the
three-operand forms, so the sums round as they did where it is present.

Projections use PyTorch's ``[out, in]`` layout (``w_in``, ``w_out``,
applied with ``F.linear``); ``conv_w`` [W, conv_dim], ``conv_b``, the norm
scales and the fp32 ``A_log``, ``dt_bias``, ``D`` [H] keep the
reference's shapes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rmsnorm

CHUNK = 32
LOG_A_MIN = -1.5

MATRICES = ("w_in", "w_out")
FP32_LEAVES = ("A_log", "dt_bias", "D")


def set_ssd_chunk(n: int) -> None:
    """Set the SSD chunk of a segment whose length it divides
    (``chunk_for``). The masked decay keeps any chunk finite; the chunk
    changes only the order of the fp32 sums and the size of the
    [B, n, C, C, H] intra-chunk terms."""
    global CHUNK
    CHUNK = n


def chunk_for(S: int) -> int:
    """SSD chunk for a segment of length S: ``CHUNK`` where it divides S,
    else 8, else 1 (the reference's ``scan_chunk_for``)."""
    return CHUNK if S % CHUNK == 0 else (8 if S % 8 == 0 else 1)


def _dims(cfg):
    """(d_in, N, P, H, W): the inner width, state size, SSM head dim, SSM
    heads and conv width."""
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    return d_in, cfg.ssm_state, P, d_in // P, cfg.ssm_conv_width


def mamba2_params(cfg, gen: torch.Generator, dtype) -> dict:
    """One layer's weights on ``gen.device``: projections [out, in] normal
    / sqrt(in) and the conv normal / sqrt(W), as the reference's
    ``dense_init``; ``A_log`` and ``dt_bias`` zeros and ``D`` ones, fp32."""
    d = cfg.d_model
    d_in, N, _P, H, W = _dims(cfg)
    conv_dim = d_in + 2 * N
    dev = gen.device
    f32 = lambda v, n: torch.full((n,), v, dtype=torch.float32, device=dev)
    return {
        # in_proj -> [z (gate, d_in), xBC (conv stream), dt (H)]
        "w_in": dense_init(gen, (2 * d_in + 2 * N + H, d), d, dtype),
        "conv_w": dense_init(gen, (W, conv_dim), W, dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": f32(0.0, H),                 # A = exp(A_log) > 0
        "dt_bias": f32(0.0, H),
        "D": f32(1.0, H),
        "ssm_norm": torch.ones((d_in,), dtype=dtype, device=dev),
        "w_out": dense_init(gen, (d, d_in), d_in, dtype),
        "ln": torch.ones((d,), dtype=dtype, device=dev),
    }


def _causal_conv(x, w, b, conv_state):
    """Depthwise causal conv, then SiLU. x: [B,S,C]; w: [W,C]; b: [C];
    conv_state: [B,W-1,C], the previous inputs. Returns (out [B,S,C], the
    last W-1 inputs [B,W-1,C] in x's dtype)."""
    W, S = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(W - 1):] if W > 1 else conv_state
    return F.silu(out + b), new_state


def ssd_chunked(x, dt_v, Bm, Cm, A, state0, chunk: int = CHUNK):
    """Chunked SSD scan.

    x: [B,S,H,P]; dt_v: [B,S,H]; Bm/Cm: [B,S,N]; A: [H]; state0:
    [B,H,P,N]. Returns (y [B,S,H,P], state [B,H,P,N]), both fp32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    n = S // chunk
    f32 = torch.float32
    loga = (-dt_v.to(f32) * A.to(f32)).clamp(LOG_A_MIN, 0.0)
    xd = x.to(f32) * dt_v.to(f32)[..., None]           # dt-weighted input
    xc = xd.reshape(Bsz, n, chunk, H, P)
    bc = Bm.to(f32).reshape(Bsz, n, chunk, N)
    cc = Cm.to(f32).reshape(Bsz, n, chunk, N)
    cum = loga.reshape(Bsz, n, chunk, H).cumsum(dim=2)  # inclusive
    # intra-chunk: y_t += sum_{j<=t} exp(cum_t - cum_j) (C_t.B_j) xd_j, the
    # mask applied before the exponent
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,n,t,j,H]
    dec = torch.where(tri[:, :, None], diff, float("-inf")).exp()
    gram = torch.einsum("bctn,bcjn->bctj", cc, bc)
    intra = torch.einsum("bctjh,bcjhp->bcthp", gram[..., None] * dec, xc)
    # each chunk's own contribution to the state it hands on:
    # sum_j exp(cum_last - cum_j) xd_j b_j^T
    last = cum[:, :, -1:, :]                                # [B,n,1,H]
    contrib = torch.einsum("bcjhn,bcjhp->bchpn",
                           (last - cum).exp()[..., None] * bc[:, :, :, None],
                           xc)
    decay = last[:, :, 0].exp()                             # [B,n,H]
    # the carry, chunk by chunk: the state entering each chunk
    state = state0.to(f32)
    entering = []
    for i in range(n):
        entering.append(state)
        state = decay[:, i, :, None, None] * state + contrib[:, i]
    # inter-chunk: y_t += (exp(cum_t) C_t) . S_in
    inter = torch.einsum("bcthn,bchpn->bcthp",
                         cum.exp()[..., None] * cc[:, :, :, None],
                         torch.stack(entering, dim=1))
    return (intra + inter).reshape(Bsz, S, H, P), state


def ssd_decode(x, dt_v, Bm, Cm, A, state):
    """One-token SSD update. x: [B,H,P]; dt_v: [B,H]; Bm/Cm: [B,N]; state
    [B,H,P,N]. Returns (y [B,H,P], new state), fp32."""
    f32 = torch.float32
    loga = (-dt_v.to(f32) * A.to(f32)).clamp(LOG_A_MIN, 0.0)
    xd = x.to(f32) * dt_v.to(f32)[..., None]
    new_state = (loga.exp()[..., None, None] * state
                 + torch.einsum("bhp,bn->bhpn", xd, Bm.to(f32)))
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.to(f32))
    return y, new_state


def mamba2_state_init(cfg, batch: int, num_layers: int, device) -> dict:
    """Zeroed state of ``num_layers`` layers: ``ssm`` [L,B,H,P,N] and
    ``conv`` [L,B,W-1,d_in+2N], fp32."""
    d_in, N, P, H, W = _dims(cfg)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return {"ssm": z(num_layers, batch, H, P, N),
            "conv": z(num_layers, batch, W - 1, d_in + 2 * N)}


def mamba2_block(cfg, p, x, state: dict):
    """Pre-norm Mamba2 block. x: [B,S,D]; state: this layer's {"ssm",
    "conv"}. Returns (x + out, the new state, fp32)."""
    B, S, _ = x.shape
    d_in, N, P, H, _W = _dims(cfg)
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    z, xbc, dt_raw = F.linear(h, p["w_in"]).split([d_in, d_in + 2 * N, H],
                                                  dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 state["conv"])
    xs, Bm, Cm = xbc.split([d_in, N, N], dim=-1)
    dt_v = F.softplus(dt_raw.float() + p["dt_bias"])
    A = p["A_log"].exp()
    xs = xs.reshape(B, S, H, P)
    if S == 1:
        y, new_ssm = ssd_decode(xs[:, 0], dt_v[:, 0], Bm[:, 0], Cm[:, 0], A,
                                state["ssm"])
        y = y[:, None]
    else:
        y, new_ssm = ssd_chunked(xs, dt_v, Bm, Cm, A, state["ssm"],
                                 chunk=chunk_for(S))
    y = y + p["D"][:, None] * xs.float()
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rmsnorm(p["ssm_norm"], y * F.silu(z), cfg.norm_eps)
    return x + F.linear(y, p["w_out"]), {"ssm": new_ssm,
                                         "conv": new_conv.float()}
