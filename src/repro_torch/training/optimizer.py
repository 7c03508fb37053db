"""AdamW optimizer over the port's parameter trees.

Port of ``repro/training/optimizer.py``: decoupled-weight-decay AdamW
with fp32 optimizer state, the gradient clipped to a global norm first,
and ``lr_schedule`` (linear warmup, then cosine decay). Every update is
computed in fp32 and each parameter is written back in its own dtype, as
the reference's ``upd``; the bias corrections are fp32 powers of the step.
``update`` returns new parameters and writes the state's ``mu`` and
``nu`` in place (the state passed in is consumed), which keeps one fp32
copy of each on the device instead of two.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar, on the parameters' device
    mu: Any                 # fp32 tree shaped like the parameters
    nu: Any


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        dev = leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def update(self, grads, state: AdamWState, params, lr_scale=1.0):
        """Returns (new_params, new_state): grad-norm clip + AdamW + decay.
        ``state.mu`` and ``state.nu`` are updated in place."""
        gnorm = global_norm(grads)
        clip = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
        step = state.step + 1
        b1c = 1.0 - self.b1 ** step.float()
        b2c = 1.0 - self.b2 ** step.float()
        lr = self.lr * lr_scale

        def upd(p, g, m, v):
            g = g.float() * clip
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g.square())
            delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps) \
                + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype)

        new_params = tree_map(upd, params, grads, state.mu, state.nu)
        return new_params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    total = 0.0
    for leaf in leaves(tree):
        total = total + leaf.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def lr_schedule(step, *, warmup: int = 100, total: int = 10_000,
                min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup -> cosine decay, as a multiplicative scale in [0, 1]
    (fp32, on ``step``'s device when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
