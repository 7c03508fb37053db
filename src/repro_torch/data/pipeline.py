"""Training data: the deterministic synthetic next-token stream.

Port of ``repro/data/pipeline.py``: the same numpy draws from
``default_rng((seed, step))`` (Zipf unigrams over the vocabulary, half the
next tokens a fixed bigram of the previous one), so batch ``i`` equals the
reference's token for token and restoring a checkpoint only sets the step.
Batches come as integer tensors on the device the caller names.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def batch(self, step: int, device="cpu") -> dict:
        """Deterministic batch for ``step``: {tokens, labels} [B, S] int64
        on ``device``."""
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        u = rng.zipf(self.zipf_a, size=(B, S + 1))
        u = (u - 1) % V
        # with p = 0.5 the next token is (prev * 31 + 7) % V: a learnable
        # short-range dependency, so the loss falls below the unigram's
        mask = rng.random((B, S)) < 0.5
        nxt = (u[:, :-1] * 31 + 7) % V
        tok = u.copy()
        tok[:, 1:][mask] = nxt[mask]
        as_t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        return {"tokens": as_t(tok[:, :-1]), "labels": as_t(tok[:, 1:])}

    def batches(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
