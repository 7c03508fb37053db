"""Mixture-of-Experts block, single device.

Port of ``repro/models/moe.py``: ``moe_params``, ``_route`` and the
function of ``moe_dense_ref``, shared experts included. The
expert-parallel paths (``moe_ep``, ``moe_ep_over_data``) are not ported.

The reference's dense path runs every expert over every token and
combines with a [T, E] matrix of routing weights. The port buckets
instead: the T x k (token, expert) pairs go, in token order, into
``xe [E, C=T, D]`` with ``fill[e]`` the routed count, all on the device
with no host sync; three expert GEMMs (gate, up, down) run through
``ops.expert_matmul`` (kernel 6 on the card), with ``silu(g) * u``
between them; each pair's row comes back, weighted, and the k terms sum in
fp32. With C = T no token is dropped, so, as in the reference, a token's
output never depends on its batch-mates, which the engine's batched ==
serial anchor relies on. It equals the reference's compute-every-expert
form token by token, to rounding.

The buckets ``xe`` and ``ye`` [E, C, D] grow with E x T: at deepseek-v2's
160 experts and d 5120 a 4096-token prefill would take 6.7 GB for each.
So routing runs over all T tokens at once (the aux loss sees them all),
and the bucket-GEMM-combine over slices of at most ``SLICE_BYTES`` of
``xe``; no row of a GEMM depends on another, so a token's output does not
depend on the cut. Smaller models (phi3.5's 16 experts at d 4096 take
8192 tokens a slice) run in one slice.

Training: ``moe_block`` is differentiable end to end, as the reference's
``value_and_grad`` of ``moe_dense_ref``: through the router (the softmax,
the top-k values and their renormalisation, and the aux loss's mean of the
gates; the expert counts take no gradient, as there), the bucket scatter,
the three GEMMs (on the card ``ops.expert_matmul`` runs kernel 6 forward
and its dX and dW kernels backward, over the live rows only) and the
weighted combine. A token's k rows in the buckets are its row repeated by
``expand``, whose backward sums them in a reduction over k in a fixed
order (no atomics), so two backward runs are bitwise equal for any k, top-6
included; the gather of the buckets' outputs puts back distinct rows.

The leaves keep the reference's layout: expert stacks ``w_gate``/``w_up``
[E, D, F] and ``w_down`` [E, F, D], the router [D, E] in fp32, a shared
expert's ``w_gate``/``w_up`` [D, Fs] and ``w_down`` [Fs, D], all applied
as ``x @ w``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import dense_init

# the most bytes of one slice's bucket xe [E, Tc, D] (ye is as large)
SLICE_BYTES = 1 << 30


def moe_params(cfg, gen: torch.Generator, dtype) -> dict:
    """One layer's MoE weights from ``gen``, on ``gen.device``."""
    d, f, E = cfg.d_model, cfg.resolved_moe_d_ff, cfg.num_experts
    p = {"router": dense_init(gen, (d, E), d, torch.float32),
         "w_gate": dense_init(gen, (E, d, f), d, dtype),
         "w_up": dense_init(gen, (E, d, f), d, dtype),
         "w_down": dense_init(gen, (E, f, d), f, dtype)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"w_gate": dense_init(gen, (d, fs), d, dtype),
                       "w_up": dense_init(gen, (d, fs), d, dtype),
                       "w_down": dense_init(gen, (fs, d), fs, dtype)}
    return p


def _route(x32, router_w, k: int):
    """Softmax gates, top-k renormalised, and the Switch-style
    load-balance loss. ``torch.topk`` and ``lax.top_k`` agree where the
    gates have no ties."""
    gates = torch.softmax(x32 @ router_w, dim=-1)              # [T, E]
    weights, idx = torch.topk(gates, k, dim=-1)                # [T, k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    E = gates.shape[-1]
    ce = torch.zeros(E, device=gates.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=gates.device))
    aux = E * torch.sum(gates.mean(dim=0) * ce / idx.numel())
    return weights, idx, aux


def _bucket(e_flat, num_experts: int):
    """Each (token, expert) pair's row in its expert's bucket, in token
    order, and the buckets' fill counts [E] int32. No host sync (unlike
    ``one_hot`` and ``bincount``, which read their inputs' range)."""
    experts = torch.arange(num_experts, device=e_flat.device)
    onehot = (e_flat[:, None] == experts).to(torch.int32)     # [N, E]
    slot = (onehot.cumsum(0) * onehot).sum(1) - 1
    return slot, onehot.sum(0, dtype=torch.int32)


def slice_tokens(num_experts: int, d_model: int, dtype) -> int:
    """Tokens a slice of ``moe_block`` takes: as many as keep its bucket
    [E, Tc, D] within ``SLICE_BYTES``, at least one."""
    per_token = num_experts * d_model * torch.empty((), dtype=dtype
                                                    ).element_size()
    return max(1, SLICE_BYTES // per_token)


def _experts(p, xf, weights, idx, num_experts: int, gemm):
    """The routed experts' weighted sum for tokens xf [T, D] with their
    top-k ``weights``/``idx`` [T, k]: bucket, three GEMMs, combine."""
    T, D = xf.shape
    k = idx.shape[1]
    e_flat = idx.reshape(-1)                                   # [T*k]
    slot, fill = _bucket(e_flat, num_experts)
    xe = xf.new_zeros((num_experts, T, D))
    xe[e_flat, slot] = xf[:, None].expand(T, k, D).reshape(T * k, D)
    h = (F.silu(gemm(xe, p["w_gate"], fill))
         * gemm(xe, p["w_up"], fill))
    ye = gemm(h, p["w_down"], fill)                            # [E, T, D]
    return (ye[e_flat, slot].float().view(T, k, D)
            * weights[..., None]).sum(1).to(xf.dtype)


def moe_block(cfg, p, x, *, reference: bool = False):
    """x: [B,S,D] -> (y [B,S,D] in x's dtype, aux loss). ``reference``
    runs the expert GEMMs through their plain version on any device."""
    B, S, D = x.shape
    T, k, E = B * S, cfg.experts_per_token, cfg.num_experts
    xf = x.reshape(T, D)
    weights, idx, aux = _route(xf.float(), p["router"], k)
    gemm = ref.expert_matmul_ref if reference else ops.expert_matmul
    Tc = slice_tokens(E, D, x.dtype)
    ys = [_experts(p, xf[t:t + Tc], weights[t:t + Tc], idx[t:t + Tc], E,
                   gemm) for t in range(0, T, Tc)]
    y = ys[0] if len(ys) == 1 else torch.cat(ys)
    if cfg.num_shared_experts:
        sp = p["shared"]
        hs = F.silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])
        y = y + hs @ sp["w_down"]
    return y.reshape(B, S, D), aux
