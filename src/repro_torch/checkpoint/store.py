"""Checkpoints: request transcripts (serving) and parameter trees
(training), each saved atomically.

``TranscriptSnapshot`` is the serving-side checkpoint record: everything
needed to resume a preempted in-flight request on *another* engine with
the same continuation (prompt, generated tokens, and the sampling seed
that keys the stream). ``save_transcripts``/``load_transcripts`` persist
a site's drained work atomically (tmp + fsync + rename). The JSON format
is the reference package's, so a file written by either loads in the
other.

``CheckpointStore`` keeps a training run's trees of tensors (parameters,
optimizer state) in the reference's on-disk format: ``step_XXXXXXXX/``
with one ``.npy`` a leaf (bf16 stored as its raw ``u2`` bits) under a
name from its tree path and a ``manifest.json``, staged in a ``.tmp``
directory, fsync'd and renamed into place, so a reader never sees a torn
checkpoint; the newest ``keep`` are kept. Either package restores the
other's checkpoint of the same tree. ``save_async`` copies to the host
before its writer thread starts; ``restore`` puts each leaf on its
``like`` leaf's device in its dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, path_name, unflatten


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



# numpy's name of each tensor dtype a checkpoint holds; bf16 has no numpy
# type here and is stored as its raw 16 bits
_NP_DTYPE = {torch.float32: "float32", torch.float64: "float64",
             torch.float16: "float16", torch.bfloat16: "bfloat16",
             torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
             torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _flatten_with_names(tree):
    """[(name, leaf)] in the reference's order and naming (dict keys
    sorted, ``.field`` for a NamedTuple, indices for a sequence)."""
    return [(path_name(path), leaf) for path, leaf in flatten_with_path(tree)]


def _to_host(leaf):
    """A tensor (or array, or number) as (numpy array to store, its
    dtype's name): bf16 as ``uint16`` bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _NP_DTYPE[t.dtype]
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


@dataclass
class CheckpointStore:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    # ----------------------------------------------------------- write
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        """Synchronous atomic save. Returns the committed directory."""
        return self._write(step, self._host(tree), extra or {})

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None) -> None:
        """Device -> host copy now; file I/O in a background thread."""
        self.wait()                                   # one in flight at a time
        host = self._host(tree)
        t = threading.Thread(target=self._write,
                             args=(step, host, extra or {}), daemon=True)
        t.start()
        self._pending = t

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    @staticmethod
    def _host(tree) -> list:
        return [(name, *_to_host(leaf))
                for name, leaf in _flatten_with_names(tree)]

    def _write(self, step: int, host: list, extra: dict) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for i, (name, arr, dtype) in enumerate(host):
            fname = f"{i:04d}_{name[:80]}.npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"].append(
                {"file": fname, "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                         # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ----------------------------------------------------------- read
    def list_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d,
                                               "manifest.json")):
                    out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None
                ) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (a tree of tensors):
        each leaf on its ``like`` leaf's device, in its dtype. Returns
        (tree, extra)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        named = _flatten_with_names(like)
        if len(named) != len(manifest["leaves"]):
            raise ValueError(
                f"leaf count mismatch: ckpt {len(manifest['leaves'])} vs "
                f"model {len(named)}")
        out = []
        for (name, leaf), meta in zip(named, manifest["leaves"]):
            arr = np.load(os.path.join(d, meta["file"]))
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
        return unflatten(like, out), manifest.get("extra", {})
