"""Token sampling for the serving engine: greedy and temperature draws.

Every draw is keyed by (seed, request id, token index): row ``r``'s token
depends only on its key and its own logits row, so a request's stream is
the same whatever its batch-mates, admission order or slot. A sampled
row's noise comes from a ``torch.Generator`` seeded with the key (Philox,
a counter-based generator, on the card). The reference's threefry bits are
not reproduced: greedy rows are exact ``argmax`` and agree with it, sampled
rows agree in distribution.
"""
from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finaliser: a bijection of 64-bit integers."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def draw_key(seed: int, rid: int, idx: int) -> int:
    """The 63-bit generator seed of token ``idx`` of request ``rid``."""
    k = _mix64(_mix64(_mix64(seed & _MASK64) ^ (rid & _MASK64))
               ^ (idx & _MASK64))
    return k >> 1


def sample_batch(logits, keys, temperature):
    """logits: [B, V]; keys: B ints (``draw_key``); temperature: B floats.
    Returns tokens [B] int32 on the logits' device. Rows with temperature
    <= 0 take the argmax and ignore their key; the others take
    argmax(logits / t + Gumbel noise), a draw from softmax(logits / t)."""
    toks = torch.argmax(logits, dim=-1).to(torch.int32)
    for r, (key, t) in enumerate(zip(keys, temperature)):
        if t <= 0.0:
            continue
        gen = torch.Generator(device=logits.device).manual_seed(int(key))
        u = torch.rand(logits.shape[-1], generator=gen,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        toks[r] = torch.argmax(logits[r].float() / max(float(t), 1e-6)
                               + gumbel).to(torch.int32)
    return toks
