"""Serving checkpoints: request transcripts, saved and loaded atomically.

``TranscriptSnapshot`` is the serving-side checkpoint record: everything
needed to resume a preempted in-flight request on *another* engine with
the same continuation (prompt, generated tokens, and the sampling seed
that keys the stream). ``save_transcripts``/``load_transcripts`` persist
a site's drained work atomically (tmp + fsync + rename). The JSON format
is the reference package's, so a file written by either loads in the
other.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


@dataclass
class TranscriptSnapshot:
    """A preempted request's resumable state — the serving checkpoint.

    Carries the full transcript (prompt + every token generated so far)
    plus the sampling ``seed`` that keys the request's stream. Resuming
    replays the transcript through the prefill-from-cache path and
    continues sampling at token index ``len(tokens)`` under the carried
    seed, so the continuation draws the keys of the uninterrupted run —
    on *any* engine serving the same model, whatever that engine's own
    seed is (its greedy tokens equal the uninterrupted run's wherever the
    replayed cache rounds as the decoded one did: at fp32). ``attempts``
    is the failover retry budget consumed so far.
    """
    rid: int
    prompt: np.ndarray            # [S] int32 token ids
    tokens: list                  # tokens generated before preemption
    max_new_tokens: int
    temperature: float
    seed: int                     # sampling seed that keys this stream
    arrival_s: float = 0.0
    prefill_done_s: Optional[float] = None   # original TTFT is preserved
    attempts: int = 0
    deadline_s: Optional[float] = None

    @classmethod
    def from_request(cls, req: Any, seed: int) -> "TranscriptSnapshot":
        """Snapshot a live ``serving.engine.Request`` (duck-typed)."""
        return cls(rid=int(req.rid),
                   prompt=np.asarray(req.prompt, np.int32),
                   tokens=list(req.tokens),
                   max_new_tokens=int(req.max_new_tokens),
                   temperature=float(req.temperature),
                   seed=int(seed),
                   arrival_s=float(req.arrival_s),
                   prefill_done_s=req.prefill_done_s,
                   attempts=int(req.attempts),
                   deadline_s=req.deadline_s)

    def to_json(self) -> dict:
        return {"rid": int(self.rid),
                "prompt": np.asarray(self.prompt).tolist(),
                "tokens": [int(t) for t in self.tokens],
                "max_new_tokens": int(self.max_new_tokens),
                "temperature": float(self.temperature),
                "seed": int(self.seed),
                "arrival_s": float(self.arrival_s),
                "prefill_done_s": self.prefill_done_s,
                "attempts": int(self.attempts),
                "deadline_s": self.deadline_s}

    @classmethod
    def from_json(cls, d: dict) -> "TranscriptSnapshot":
        return cls(rid=int(d["rid"]),
                   prompt=np.asarray(d["prompt"], np.int32),
                   tokens=[int(t) for t in d["tokens"]],
                   max_new_tokens=int(d["max_new_tokens"]),
                   temperature=float(d["temperature"]),
                   seed=int(d["seed"]),
                   arrival_s=float(d.get("arrival_s", 0.0)),
                   prefill_done_s=d.get("prefill_done_s"),
                   attempts=int(d.get("attempts", 0)),
                   deadline_s=d.get("deadline_s"))


def save_transcripts(path: str, snaps: list, extra: Optional[dict] = None) -> str:
    """Atomically persist a drained site's transcript snapshots."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"extra": extra or {},
                   "transcripts": [s.to_json() for s in snaps]}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_transcripts(path: str) -> tuple[list, dict]:
    with open(path) as f:
        d = json.load(f)
    return ([TranscriptSnapshot.from_json(s) for s in d["transcripts"]],
            d.get("extra", {}))

