"""Site-local serving engine: KV-cache slots + continuous batching.

Port of ``repro/serving/engine.py``:

  * a fixed pool of ``max_batch`` cache slots over one dense cache
    ``[L, max_batch, max_seq, KVH, hd]`` (or, for the recurrent ssm
    family, one state ``[L, max_batch, ...]`` with no sequence axis,
    overwritten whole when a slot is admitted; the hybrid holds such a
    state beside one K/V cache a group, ``attn``); every step runs ONE
    batched decode over all slots, free ones too (a free slot's state
    drifts until its next admission overwrites it), and a finished
    sequence frees its slot at once;
  * batched admission (``admit_mode="batched"``, the default): waiting
    requests are grouped by the largest power of two of their prompt
    (bucket) and prefilled together, one ``prefill_fn`` call per (bucket,
    power-of-2 padded batch); each prompt's tail runs through descending
    power-of-2 ``extend_fn`` chunks shared by every row with that bit set;
  * ``admit_mode="serial"`` keeps the one-request-at-a-time reference: a
    bucket prefill and a B=1 decode per tail token. Batched and serial give
    the same token streams;
  * ``admit_mode="async"`` splits admission across steps and interleaves
    it with decode (below);
  * per-request TTFT / TBT / E2E metrics.

An encdec model's prefills take zero ``frames`` [B, Se, d] (the audio
frontend stub); the encoder's K/V (``enc_kv``) follow a row through every
insert, and the frames do not count against ``max_seq``. A vlm model's
prefills take zero ``patches`` [B, P, d] (the vision frontend stub), which
sit in the cache before the prompt: the P patch positions count against
``max_seq``, in the pages a request reserves and in a slot's length.

The schedule of buckets and chunks is the reference's, so ``prefill_calls``
and the greedy streams match it. Every token draw is keyed by (engine seed,
request id, token index) — see ``serving.sampling``.

Paged KV cache (``paged=True``, as in the reference): the dense rows
give way to a shared pool of ``num_pages`` pages of ``page_size`` tokens
(default: the dense capacity) addressed through a host-side block table
per slot. Pages for a request's whole contract (prompt + max_new_tokens
- 1) are reserved at admission; a request that could never fit is
rejected, and one that does not fit now waits (nothing live is evicted);
a finished slot's pages go back on the free list, and a failed admission
gives back everything it reserved. Decode runs over the table sliced to
the power-of-2 page count that covers the live rows; extends run at full
width, with the rows outside the chunk masked. Greedy streams equal the
dense engine's (to rounding: the reference's paged path is bitwise the
dense one, the port's paged kernels sum in another order).

Request lifecycle (as in the reference)::

    queued --admit--> live --finish--> completed
       |                |  |
       | (watermark /   |  +--deadline--> timed_out
       |  oversize /    +--preempt--> snapshot --resume--> queued (again)
       |  deadline)                        |
       +--> rejected / timed_out           +--(budget spent)--> failed

``preempt(slots)`` snapshots each in-flight request's transcript (prompt +
generated tokens + the seed that keys its draws) into a
``checkpoint.store.TranscriptSnapshot`` and frees the slot (and its
pages); ``drain()`` does so for every live slot and the waiting queue (a
site dying). ``resume(snapshot)`` queues the transcript again, on this or
any engine serving the same model: admission prefills the prompt plus the
carried tokens through the same bucket and chunk schedule, and sampling
continues at token index ``len(tokens)`` under the carried seed. The draws
are keyed as in the uninterrupted run, so greedy streams equal it wherever
the replayed cache rounds as the decoded one did (at fp32; at bf16 the
prefill and decode kernels round differently).

``queue_watermark`` rejects a submission beyond that queue depth;
``set_brownout(frac)`` sheds fresh admissions' ``max_new_tokens`` to
``ceil(frac * requested)`` and scales the per-step admission budget by
``frac``; ``deadline_s`` (absolute, engine clock) times out a queued or
live request; ``not_before_s`` holds a request back (``retry_backoff``)
without blocking the queue behind it. ``EngineMetrics`` keeps the ledger
(preemptions, resumes, recovered / lost / shed tokens, timeouts), and
``reconcile()`` checks that it balances.

Async admission (``admit_mode="async"``, as in the reference): batched
admission runs a whole wave to completion before the step's decode, so a
burst stalls the live rows for the whole wave. Async splits it:

  1. a pending set (``_pend``: slot -> [request, effective prompt,
     tokens consumed]) carries each admitted prompt whose tail is not yet
     in the cache across steps; its slot (and pages) are reserved while
     the tail fills chunk by chunk;
  2. a token-budget arbiter (``admit_token_budget``, default ``max_seq``
     tokens a step, scaled by brownout) spends each step's budget on, in
     order: one guaranteed descending power-of-2 extend chunk for the
     pending tails (so they never starve), bucket prefills of new
     requests, then what is left on more tail chunks;
  3. the step's decode runs over the live rows only: pending and free rows
     are masked (``decode_fn(rows=...)``): their ``pos`` does not move and
     their K/V are not written (dense) or go to the trash page (paged),
     where the reference copies the whole cache and selects old against
     new, or points the masked rows' table rows at the sentinel.

It launches no other kernel than batched admission does, and gives the
same token streams. A pending request is live for ``preempt``/``drain``
(its snapshot replays from the prompt), for the deadline sweep and for
``reconcile``. The int8 KV cache is reached, as in the reference, through
the model's cache functions, not through the engine.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import TranscriptSnapshot
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.api import Model
from repro_torch.serving.sampling import draw_key, sample_batch
from repro_torch.stats import percentile


def retry_backoff(attempts: int, *, base: float = 0.05,
                  cap: float = 2.0) -> float:
    """Capped exponential backoff delay before retry ``attempts`` (1-based):
    ``min(base * 2**(attempts-1), cap)``. Deterministic (no jitter) so
    chaos runs replay exactly."""
    return min(base * (2.0 ** max(attempts - 1, 0)), cap)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [S] int32 token ids
    max_new_tokens: int                 # TOTAL tokens (incl. resumed prefix)
    arrival_s: float = 0.0
    temperature: float = 0.0
    # lifecycle
    seed: Optional[int] = None          # sampling seed carried by a resumed
    #                                     request (None: the engine's)
    deadline_s: Optional[float] = None  # absolute deadline (engine clock)
    not_before_s: float = 0.0           # backoff gate for (re-)admission
    attempts: int = 0                   # admission/failover attempts so far
    resumed_from: int = 0               # tokens carried in from a snapshot
    # filled by the engine
    tokens: list = field(default_factory=list)
    prefill_done_s: Optional[float] = None
    finish_s: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.prefill_done_s is None:
            return None
        return self.prefill_done_s - self.arrival_s

    @property
    def e2e(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s

    @property
    def tbt(self) -> Optional[float]:
        if self.finish_s is None or len(self.tokens) < 2:
            return None
        return (self.finish_s - self.prefill_done_s) / max(len(self.tokens) - 1, 1)


# attention KV leaves, recurrent state, the hybrid's per-group K/V, an
# encdec model's encoder K/V
CACHE_PARTS = ("kv", "state", "attn", "enc_kv")


def cache_leaves(cache: dict):
    """(part, name, tensor) for every per-slot leaf [L, B, ...] of a
    decode cache, ``pos`` aside."""
    for part in CACHE_PARTS:
        for name, leaf in cache.get(part, {}).items():
            yield part, name, leaf


def insert_cache_rows(engine_cache: dict, group_cache: dict,
                      slots: np.ndarray) -> None:
    """Copy row ``r`` of a prefill cache into engine slot ``slots[r]``, in
    place, for every leaf of the engine cache: a KV leaf's first S
    positions (S the group's length), a state leaf [L, B, ...] whole, so
    a slot's recurrent state is overwritten at admission. Ids >= max_batch
    (power-of-2 padding rows) are dropped."""
    B = engine_cache["pos"].shape[0]
    rows = [r for r, s in enumerate(slots) if 0 <= s < B]
    if not rows:
        return
    dev = engine_cache["pos"].device
    dst = torch.as_tensor([int(slots[r]) for r in rows], device=dev)
    src = torch.as_tensor(rows, device=dev)
    for part, name, e in cache_leaves(engine_cache):
        g = group_cache[part][name]
        e[(slice(None), dst, *(slice(0, n) for n in g.shape[2:]))] = (
            g[:, src].to(e.dtype))
    engine_cache["pos"][dst] = group_cache["pos"][src]


def insert_cache_pages(pool_kv: dict, group_kv: dict,
                       page_map: torch.Tensor) -> None:
    """Scatter a dense prefill cache's kv leaves [L, kb, S, ...] into the
    page pools [L, P+1, page, ...], in place: row ``r``'s tokens land in
    pages ``page_map[r]`` ([kb, ceil(S / page)] int64). Entries past the
    real pages (the sentinel) write the trash page, which is how padding
    rows and table columns past a slot's reservation are dropped."""
    for name, pool in pool_kv.items():
        g = group_kv[name].to(pool.dtype)
        page = pool.shape[2]
        L, kb, S = g.shape[:3]
        npr = page_map.shape[1]
        if npr * page > S:
            pad = torch.zeros((L, kb, npr * page - S, *g.shape[3:]),
                              dtype=g.dtype, device=g.device)
            g = torch.cat([g, pad], dim=2)
        g = g[:, :, :npr * page].reshape(L, kb, npr, page, *g.shape[3:])
        pool[:, page_map.clamp(0, pool.shape[1] - 1)] = g


@dataclass
class EngineMetrics:
    completed: list
    rejected: list = field(default_factory=list)
    timed_out: list = field(default_factory=list)
    steps: int = 0
    prefills: int = 0          # requests admitted (one prefill each, logically)
    prefill_calls: int = 0     # model calls spent on admission
    submitted: int = 0         # submissions (watermark rejections too)
    preemptions: int = 0       # live slots snapshotted and freed
    evicted: int = 0           # snapshots handed out (preempted + drained)
    resumed: int = 0           # snapshots queued again on this engine
    recovered_tokens: int = 0  # tokens carried into a resume (not re-sampled)
    lost_tokens: int = 0       # generated tokens discarded (timeout/rejection)
    duplicated_tokens: int = 0 # tokens re-emitted behind a delivery mark;
    #                            must stay 0
    shed_tokens: int = 0       # max_new_tokens cut under brownout
    decode_steps: int = 0      # decode calls (steps with >= 1 live row)
    extend_chunks: int = 0     # extend calls of the batched prompt tails
    admit_stall_steps: int = 0 # steps that admitted with no live decode row
    page_waits: int = 0        # steps whose admission stopped for pages

    def summary(self) -> dict:
        ttfts = [r.ttft for r in self.completed if r.ttft is not None]
        e2es = [r.e2e for r in self.completed if r.e2e is not None]
        tbts = [r.tbt for r in self.completed if r.tbt is not None]
        f = lambda xs: float(np.mean(xs)) if xs else 0.0
        out = {"num_completed": len(self.completed), "steps": self.steps,
               "prefills": self.prefills, "prefill_calls": self.prefill_calls,
               "rejected": len(self.rejected),
               "timed_out": len(self.timed_out),
               "submitted": self.submitted,
               "preemptions": self.preemptions,
               "resumed": self.resumed,
               "served_tokens": sum(len(r.tokens) for r in self.completed),
               "recovered_tokens": self.recovered_tokens,
               "lost_tokens": self.lost_tokens,
               "duplicated_tokens": self.duplicated_tokens,
               "shed_tokens": self.shed_tokens,
               "decode_steps": self.decode_steps,
               "extend_chunks": self.extend_chunks,
               "admit_stall_steps": self.admit_stall_steps,
               "page_waits": self.page_waits,
               "mean_ttft": f(ttfts), "mean_tbt": f(tbts), "mean_e2e": f(e2es)}
        for name, xs in (("ttft", ttfts), ("tbt", tbts), ("e2e", e2es)):
            out[f"p50_{name}"] = percentile(xs, 50)
            out[f"p99_{name}"] = percentile(xs, 99)
        return out


class ServingEngine:
    """Continuous-batching engine over one model replica.

    ``params`` decide the device: the cache and every call live where the
    weights do. ``admit_mode``: "batched" (default), "serial" (the
    reference) or "async" (admission interleaved with decode).
    ``admit_token_budget``: max prompt tokens admitted per step (None =
    unlimited for batched and serial, ``max_seq`` for async), at least one
    request per step.
    ``queue_watermark``: max waiting-queue depth before ``submit`` rejects
    (None = unbounded). ``paged``: a paged KV cache of ``num_pages`` pages
    of ``page_size`` tokens (families without a paged layout stay dense).
    """

    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 max_seq: int = 512, eos_token: int = -1, seed: int = 0,
                 clock=None, admit_mode: str = "batched",
                 admit_token_budget: Optional[int] = None,
                 queue_watermark: Optional[int] = None,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None):
        if admit_mode not in ("batched", "serial", "async"):
            raise ValueError(f"admit_mode {admit_mode!r}")
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.params = params
        self.device = params["final_norm"].device
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos = eos_token
        self.admit_mode = admit_mode
        self.admit_token_budget = admit_token_budget
        self.queue_watermark = queue_watermark
        self.seed = seed
        self.brownout = 1.0
        self._clock = clock or time.perf_counter
        self._has_deadlines = False
        # cache positions every request spends before its prompt: a vlm's
        # patches (an encdec model's frames live in the encoder's cache)
        self._prefix = (self.cfg.num_prefix_embeddings
                        if self.cfg.family == "vlm" else 0)
        self.paged = bool(paged) and T.supports_paged_cache(self.cfg)
        if self.paged:
            if page_size < 1 or page_size & (page_size - 1):
                raise ValueError(f"page_size {page_size} not a power of 2")
            if max_seq % page_size:
                raise ValueError("max_seq must be a multiple of page_size")
            self.page_size = page_size
            self._maxP = max_seq // page_size
            self.num_pages = (num_pages if num_pages is not None
                              else max_batch * self._maxP)
            cache = T.make_paged_decode_cache(
                self.cfg, max_batch, max_seq, self.device,
                page_size=page_size, num_pages=self.num_pages)
            # the block table lives on the host (allocation is host work);
            # each call gets it sliced to the width it needs
            cache.pop("table")
            self.cache = cache
            self._tbl = np.full((max_batch, self._maxP), self.num_pages,
                                np.int32)
            self._free_pages = list(range(self.num_pages - 1, -1, -1))
            self.slot_pages: list[list[int]] = [[] for _ in range(max_batch)]
            self._slot_len = np.zeros((max_batch,), np.int64)
        else:
            self.page_size = self.num_pages = self._maxP = 0
            self.cache = T.make_decode_cache(self.cfg, max_batch, max_seq,
                                             self.device)
        self.active: list[Optional[Request]] = [None] * max_batch
        self.last_token = torch.zeros((max_batch,), dtype=torch.int32,
                                      device=self.device)
        self.new_counts = [0] * max_batch
        self.waiting: deque[Request] = deque()
        self.metrics = EngineMetrics(completed=[])
        # async: admitted prompts whose tails are not yet in the cache,
        # slot -> [req, effective prompt, tokens consumed]
        self._pend: dict[int, list] = {}
        # B=1 cache of the serial-mode prompt tails, built at first use
        self._b1_cache = None

    # --------------------------------------------------------------- admit
    def submit(self, req: Request) -> bool:
        """Queue a request. Returns False (and records a rejection) when
        the queue is at ``queue_watermark``."""
        self.metrics.submitted += 1
        if (self.queue_watermark is not None
                and len(self.waiting) >= self.queue_watermark):
            req.finish_s = self._clock()
            self.metrics.rejected.append(req)
            return False
        if req.deadline_s is not None:
            self._has_deadlines = True
        self.waiting.append(req)
        return True

    def _seed_of(self, req: Request) -> int:
        """The seed that keys ``req``'s draws: the one it carries from a
        snapshot, else this engine's."""
        return self.seed if req.seed is None else req.seed

    @staticmethod
    def _effective_prompt(req: Request) -> np.ndarray:
        """What admission prefills: the prompt plus every token generated
        before a preemption, so the replay rebuilds the request's cache."""
        prompt = np.asarray(req.prompt, np.int32)
        if not req.tokens:
            return prompt
        return np.concatenate([prompt, np.asarray(req.tokens, np.int32)])

    def _finalize_admits(self, items: list, logits) -> None:
        """Sample first tokens for every request finished by one model call
        (one batched draw, one host sync) and make their slots live.

        items: [(slot, req, row)] with ``row`` indexing ``logits``.
        """
        if not items:
            return
        rows = torch.as_tensor([row for _, _, row in items],
                               device=logits.device)
        # the token index is len(tokens): 0 for a fresh request, the
        # resume point for a replayed transcript
        keys = [draw_key(self._seed_of(req), req.rid, len(req.tokens))
                for _, req, _ in items]
        temps = [req.temperature for _, req, _ in items]
        toks = sample_batch(logits[rows], keys, temps).cpu().numpy()
        now = self._clock()
        live_slots, live_toks = [], []
        for j, (slot, req, _) in enumerate(items):
            tok = int(toks[j])
            req.tokens.append(tok)
            if req.prefill_done_s is None:
                # a resumed request keeps its first prefill time: TTFT is
                # when the user first saw a token
                req.prefill_done_s = now
            self.metrics.prefills += 1
            if len(req.tokens) >= req.max_new_tokens or tok == self.eos:
                # the prompt's last logits gave the only requested token:
                # the slot never goes live
                req.finish_s = now
                self.metrics.completed.append(req)
                self.release_slot(slot)
                continue
            self.active[slot] = req
            self.new_counts[slot] = len(req.tokens)
            live_slots.append(slot)
            live_toks.append(tok)
        if live_slots:
            self.last_token[torch.as_tensor(live_slots, device=self.device)] = (
                torch.as_tensor(live_toks, dtype=torch.int32,
                                device=self.device))

    def _sweep_waiting_deadlines(self, now: float) -> None:
        """Time out queued requests past their deadline, before admission
        spends a prefill on them."""
        keep: deque[Request] = deque()
        for req in self.waiting:
            if req.deadline_s is not None and now >= req.deadline_s:
                req.finish_s = now
                self.metrics.timed_out.append(req)
                self.metrics.lost_tokens += len(req.tokens)
            else:
                keep.append(req)
        self.waiting = keep

    def _step_budget(self, budget: Optional[int]) -> Optional[int]:
        """This step's admission budget: ``budget`` (None: unlimited),
        scaled by brownout."""
        if budget is not None and self.brownout < 1.0:
            budget = max(1, int(budget * self.brownout))
        return budget

    def _take_admits(self, now: float, budget: Optional[int], spent: int,
                     *, charge_bucket: bool) -> tuple[list, int]:
        """Walk the queue and give each request admission can take this
        step a free slot (and its pages): [(slot, req)] and the tokens
        spent. A request is charged its effective prompt, or only its
        bucket when ``charge_bucket`` (async: the tail is the arbiter's),
        against ``budget`` on top of ``spent`` (None: no limit); the first
        of a step that has spent nothing is taken whatever its charge."""
        free = self._free_slots()
        admits: list[tuple[int, Request]] = []
        held: list[Request] = []       # backoff-gated, in queue order
        while self.waiting and free:
            req = self.waiting[0]
            if req.not_before_s > now:
                # retry backoff: not eligible yet; the requests behind it
                # are not held up
                held.append(self.waiting.popleft())
                continue
            S = len(req.prompt) + len(req.tokens)    # the effective prompt
            if req.max_new_tokens <= len(req.tokens):
                # nothing (left) to generate: complete as-is, no slot, no
                # prefill
                self.waiting.popleft()
                req.finish_s = self._clock()
                self.metrics.completed.append(req)
                continue
            need = self._pages_needed(req) if self.paged else 0
            if (len(req.prompt) == 0
                    or (self._prefix + len(req.prompt) + req.max_new_tokens
                        - 1 > self.max_seq)
                    or need > self.num_pages):
                # can never fit this engine's cache (or page pool): reject
                # without a slot
                self.waiting.popleft()
                req.finish_s = self._clock()
                self.metrics.lost_tokens += len(req.tokens)
                self.metrics.rejected.append(req)
                continue
            if self.paged and need > len(self._free_pages):
                # pool exhausted for now: wait for live requests to finish
                # and give their pages back; nothing is evicted
                self.metrics.page_waits += 1
                break
            cost = 1 << (S.bit_length() - 1) if charge_bucket else S
            if ((admits or spent) and budget is not None
                    and spent + cost > budget):
                break
            self.waiting.popleft()
            if self.brownout < 1.0 and not req.tokens:
                # brownout sheds a fresh request's tokens instead of
                # dropping it; a resumed transcript keeps its contract
                want = req.max_new_tokens
                shed_to = max(1, int(math.ceil(want * self.brownout)))
                if shed_to < want:
                    self.metrics.shed_tokens += want - shed_to
                    req.max_new_tokens = shed_to
            slot = free.pop(0)
            if self.paged:
                # after any shed: never more than the `need` cleared above
                self._alloc_pages(slot, self._pages_needed(req))
            admits.append((slot, req))
            spent += cost
        if held:
            self.waiting.extendleft(reversed(held))
        return admits, spent

    def _admit(self) -> None:
        if not self.waiting:
            return
        now = self._clock()
        if self._has_deadlines:
            self._sweep_waiting_deadlines(now)
        admits, _ = self._take_admits(
            now, self._step_budget(self.admit_token_budget), 0,
            charge_bucket=False)
        if not admits:
            return
        try:
            if self.admit_mode == "serial":
                for slot, req in admits:
                    self._admit_serial(slot, req)
            else:
                self._admit_batched(admits)
        except Exception:
            self._rollback_admits(admits)
            raise

    def _free_slots(self) -> list:
        """Slots neither live nor holding a pending async admission."""
        return [i for i, r in enumerate(self.active)
                if r is None and i not in self._pend]

    def _rollback_admits(self, admits: list) -> None:
        """A failed admission round: every request not yet live, pending,
        completed or rejected goes back to the front of the queue with only
        the tokens it carried in, and its slot (and pages) are released."""
        requeue = []
        for slot, req in admits:
            settled = (self.active[slot] is req
                       or (slot in self._pend and self._pend[slot][0] is req)
                       or any(r is req for r in self.metrics.completed)
                       or any(r is req for r in self.metrics.rejected))
            if not settled:
                del req.tokens[req.resumed_from:]
                if req.resumed_from == 0:
                    req.prefill_done_s = None
                self.release_slot(slot)
                requeue.append(req)
        self.waiting.extendleft(reversed(requeue))

    def _admit_serial(self, slot: int, req: Request) -> None:
        """Reference path: pow2-prefix prefill + serial B=1 decode tail,
        over the effective prompt."""
        full = self._effective_prompt(req)
        S = len(full)
        bucket = 1 << (S.bit_length() - 1)
        logits, req_cache = self.model.prefill_fn(
            self.params, self._prefill_inputs(full[None, :bucket]))
        self.metrics.prefill_calls += 1
        if bucket < S:
            # decode(prefill of a prefix) is the exact sequential
            # continuation, so the final logits match a full-length prefill
            if self._b1_cache is None:
                self._b1_cache = T.make_decode_cache(self.cfg, 1,
                                                     self.max_seq,
                                                     self.device)
            b1 = self._b1_cache
            for _part, _name, leaf in cache_leaves(b1):
                leaf.zero_()
            b1["pos"].zero_()
            insert_cache_rows(b1, req_cache, np.zeros(1, np.int32))
            for tok in full[bucket:]:
                logits, b1 = self.model.decode_fn(
                    self.params, {"token": torch.as_tensor([tok])}, b1)
                self.metrics.prefill_calls += 1
            req_cache = b1
        self._insert_group_cache(req_cache, np.asarray([slot]))
        if self.paged:
            # the logical length is the request cache's pos (the prefix
            # included), not its kv length (the serial tail cache spans
            # max_seq)
            self._slot_len[slot] = int(req_cache["pos"][0])
        self._finalize_admits([(slot, req, 0)], logits)

    def _prefill_inputs(self, toks: np.ndarray) -> dict:
        """A prefill call's inputs for prompt rows ``toks`` [B, S]: an
        encdec model also takes its frontend stub's frames, a vlm model its
        patches, zeros [B, num_prefix_embeddings, d]."""
        inputs = {"tokens": torch.as_tensor(toks)}
        stub = {"encdec": "frames", "vlm": "patches"}.get(self.cfg.family)
        if stub:
            inputs[stub] = torch.zeros(
                (toks.shape[0], self.cfg.num_prefix_embeddings,
                 self.cfg.d_model), dtype=T.torch_dtype(self.cfg.dtype),
                device=self.device)
        return inputs

    def _prefill_groups(self, admits: list, pend: dict) -> None:
        """Bucket-group prefills of an admission wave, over the effective
        prompts (a resumed request rides the same pipeline as a fresh
        one): one ``prefill_fn`` call per bucket, its batch padded to a
        power of 2. Prompts that fill their bucket finish at once; the
        others go into ``pend`` (slot -> [req, full, consumed])."""
        groups: dict[int, list] = {}
        for slot, req in admits:
            full = self._effective_prompt(req)
            bucket = 1 << (len(full).bit_length() - 1)
            groups.setdefault(bucket, []).append((slot, req, full))
        for bucket in sorted(groups, reverse=True):
            group = groups[bucket]
            kp = 1 << (len(group) - 1).bit_length()   # pow2-padded batch
            toks = np.zeros((kp, bucket), np.int32)
            # padding rows go to slot id max_batch and are dropped
            slots = np.full((kp,), self.max_batch, np.int32)
            for r, (slot, req, full) in enumerate(group):
                toks[r] = full[:bucket]
                slots[r] = slot
            logits, gcache = self.model.prefill_fn(
                self.params, self._prefill_inputs(toks))
            self.metrics.prefill_calls += 1
            self._insert_group_cache(gcache, slots)
            if self.paged:
                # the group cache's length: the bucket after any prefix
                for slot, _req, _full in group:
                    self._slot_len[slot] = self._prefix + bucket
            fins = []
            for r, (slot, req, full) in enumerate(group):
                if bucket == len(full):
                    fins.append((slot, req, r))
                else:
                    pend[slot] = [req, full, bucket]
            self._finalize_admits(fins, logits)

    def _admit_batched(self, admits: list) -> None:
        """Grouped bucket prefills + shared descending-pow2 extend tails,
        all within this step."""
        pend: dict[int, list] = {}          # slot -> [req, full, consumed]
        self._prefill_groups(admits, pend)
        while pend:
            # chunk = the largest remaining binary digit across pending
            # rows; every row with that bit set advances this round
            C = max(1 << ((len(full) - cons).bit_length() - 1)
                    for req, full, cons in pend.values())
            toks = np.zeros((self.max_batch, C), np.int32)
            mask = np.zeros((self.max_batch,), bool)
            takers = []
            for slot, (req, full, cons) in pend.items():
                if (len(full) - cons) & C:
                    toks[slot] = full[cons:cons + C]
                    mask[slot] = True
                    takers.append(slot)
            logits = self._dispatch_extend(toks, mask, takers, C)
            fins = []
            for slot in takers:
                req, full, cons = pend[slot]
                cons += C
                if cons == len(full):
                    del pend[slot]
                    fins.append((slot, req, slot))
                else:
                    pend[slot][2] = cons
            self._finalize_admits(fins, logits)

    # --------------------------------------------------------------- async
    def _arbiter(self, budget: int, *, force: bool = False) -> int:
        """Spend up to ``budget`` prompt tokens advancing the pending tails
        in descending power-of-2 chunks (each chunk the largest power of 2
        within both the longest remaining tail and the budget left; every
        pending row with at least that much left rides it). ``force``
        grants one 1-token chunk on a spent budget, so tails never starve
        behind a stream of arrivals. Returns the tokens spent."""
        spent = 0
        while self._pend:
            remaining = budget - spent
            if remaining < 1:
                if not (force and spent == 0):
                    break
                remaining = 1
            max_rem = max(len(full) - cons
                          for _req, full, cons in self._pend.values())
            C = 1 << (min(max_rem, remaining).bit_length() - 1)
            toks = np.zeros((self.max_batch, C), np.int32)
            mask = np.zeros((self.max_batch,), bool)
            takers = []
            for slot, (_req, full, cons) in self._pend.items():
                if len(full) - cons >= C:
                    toks[slot] = full[cons:cons + C]
                    mask[slot] = True
                    takers.append(slot)
            logits = self._dispatch_extend(toks, mask, takers, C)
            fins = []
            for slot in takers:
                entry = self._pend[slot]
                entry[2] += C
                if entry[2] == len(entry[1]):
                    del self._pend[slot]
                    fins.append((slot, entry[0], slot))
            self._finalize_admits(fins, logits)
            spent += C * len(takers)
        return spent

    def _admit_async(self) -> int:
        """One bounded slice of admission work: a guaranteed arbiter chunk
        for the pending tails, bucket prefills of new requests with the
        budget left (their tails join ``_pend``), then what is still left
        on more tail chunks. Returns the prompt tokens spent."""
        now = self._clock()
        if self._has_deadlines:
            self._sweep_waiting_deadlines(now)
        budget = self._step_budget(self.admit_token_budget or self.max_seq)
        spent = self._arbiter(budget, force=True)
        admits, spent = self._take_admits(now, budget, spent,
                                          charge_bucket=True)
        if admits:
            try:
                self._prefill_groups(admits, self._pend)
            except Exception:
                self._rollback_admits(admits)
                raise
        return spent + self._arbiter(budget - spent)

    def _dispatch_extend(self, toks, mask, takers: list, C: int):
        """One masked extend chunk over the whole engine batch: rows
        outside ``mask`` keep their cache and pos (written in place, where
        the reference selects old against new). Paged: at the table's
        full width, so only the chunk length varies."""
        cache = self._call_cache(self._maxP) if self.paged else self.cache
        logits, cache = self.model.extend_fn(
            self.params, {"tokens": torch.as_tensor(toks)}, cache,
            rows=torch.as_tensor(mask, device=self.device))
        self.cache["pos"] = cache["pos"]
        if self.paged:
            self._slot_len[takers] += C
        self.metrics.prefill_calls += 1
        self.metrics.extend_chunks += 1
        return logits

    # --------------------------------------------------------------- pages
    def _call_cache(self, width: int) -> dict:
        """The per-call paged cache: the device pools and ``pos`` with the
        host block table sliced to ``width`` pages (a [B, width] int32
        upload per call)."""
        return {**self.cache, "table": torch.as_tensor(
            self._tbl[:, :width], device=self.device)}

    def _pages_needed(self, req: Request) -> int:
        """Pages covering the whole contract: prefix + prompt +
        max_new_tokens - 1 cache positions (the last sampled token never
        writes KV; a resumed request's carried tokens are part of
        max_new_tokens)."""
        total = self._prefix + len(req.prompt) + req.max_new_tokens - 1
        return -(-total // self.page_size)

    def _alloc_pages(self, slot: int, need: int) -> None:
        """Reserve ``need`` free pages for ``slot`` and point its table row
        at them (the rest stays sentinel). The caller checked there are
        enough."""
        pages = [self._free_pages.pop() for _ in range(need)]
        self.slot_pages[slot] = pages
        self._tbl[slot, :] = self.num_pages
        self._tbl[slot, :need] = pages

    def _decode_width(self, live: list) -> int:
        """Smallest power-of-2 page count covering every live row's next
        token write; free rows' tables are all sentinel."""
        need = max([int(self._slot_len[i]) + 1 for i in live] + [1])
        pages = -(-need // self.page_size)
        return min(1 << (pages - 1).bit_length(), self._maxP)

    def _insert_group_cache(self, gcache: dict, slots: np.ndarray) -> None:
        """Copy row ``r`` of a dense prefill (or B=1 tail) cache into slot
        ``slots[r]``: dense rows, or the slot's reserved pages. Slot ids
        past the engine (padding rows) are dropped."""
        if not self.paged:
            insert_cache_rows(self.cache, gcache, slots)
            return
        S_g = gcache["kv"]["k"].shape[2]
        npr = -(-S_g // self.page_size)
        pm = np.full((len(slots), npr), self.num_pages, np.int64)
        for r, s in enumerate(slots):
            if 0 <= s < self.max_batch:
                # columns past the reservation stay sentinel, so a tail
                # cache that spans max_seq writes no stray page
                pm[r] = self._tbl[s, :npr]
        insert_cache_pages(self.cache["kv"], gcache["kv"],
                           torch.as_tensor(pm, device=self.device))
        # pos, and an encdec model's enc_kv, by row
        insert_cache_rows({**self.cache, "kv": {}}, gcache, slots)

    # --------------------------------------------------------------- slots
    def release_slot(self, slot: int) -> None:
        """Retire a slot: clear its bookkeeping and zero its cache position
        so its stale cache rows are masked; paged, its pages go back on
        the free list and its table row to the sentinel, so a stale write
        lands in the trash page, not in the pages' next owner. Idempotent;
        an out-of-range slot id raises."""
        if not 0 <= slot < self.max_batch:
            raise ValueError(
                f"slot {slot} out of range [0, {self.max_batch})")
        self.active[slot] = None
        self.new_counts[slot] = 0
        self._pend.pop(slot, None)
        self.cache["pos"][slot] = 0
        if self.paged and self.slot_pages[slot]:
            self._free_pages.extend(self.slot_pages[slot])
            self.slot_pages[slot] = []
            self._tbl[slot, :] = self.num_pages
            self._slot_len[slot] = 0

    # ----------------------------------------------------- preempt / resume
    def preempt(self, slots: Optional[list] = None) -> list:
        """Snapshot in-flight requests and free their slots (and pages).

        ``slots=None`` preempts every live slot and every pending async
        admission (a power drop). Each snapshot carries the transcript and
        the seed that keys the request's draws, so ``resume`` here or on
        any engine serving the same model continues the same stream. A
        pending admission's partly filled cache is dropped: its resume
        replays it from the prompt."""
        if slots is None:
            slots = ([i for i, r in enumerate(self.active) if r is not None]
                     + list(self._pend))
        snaps = []
        for slot in slots:
            req = self.active[slot]
            if req is None and slot in self._pend:
                req = self._pend[slot][0]
            if req is None:
                continue
            snaps.append(TranscriptSnapshot.from_request(
                req, seed=self._seed_of(req)))
            self.metrics.preemptions += 1
            self.metrics.evicted += 1
            self.release_slot(slot)
        return snaps

    def drain(self) -> list:
        """A site dying: preempt every live slot and hand out the waiting
        queue too, all as snapshots for a failover layer to carry."""
        snaps = self.preempt()
        while self.waiting:
            req = self.waiting.popleft()
            snaps.append(TranscriptSnapshot.from_request(
                req, seed=self._seed_of(req)))
            self.metrics.evicted += 1
        return snaps

    def resume(self, snap: TranscriptSnapshot, *,
               not_before_s: float = 0.0) -> Optional[Request]:
        """Queue a preempted transcript again, with its seed and its first
        ``prefill_done_s``. Returns the queued Request, or None when the
        watermark rejected it (the caller keeps the snapshot)."""
        req = Request(rid=snap.rid,
                      prompt=np.asarray(snap.prompt, np.int32),
                      max_new_tokens=snap.max_new_tokens,
                      arrival_s=snap.arrival_s,
                      temperature=snap.temperature,
                      seed=snap.seed,
                      deadline_s=snap.deadline_s,
                      not_before_s=not_before_s,
                      attempts=snap.attempts,
                      resumed_from=len(snap.tokens),
                      tokens=list(snap.tokens),
                      prefill_done_s=snap.prefill_done_s)
        if not self.submit(req):
            return None
        self.metrics.resumed += 1
        self.metrics.recovered_tokens += len(snap.tokens)
        return req

    def set_brownout(self, frac: float) -> None:
        """Enter (or leave, frac=1.0) brownout: fresh admissions shed
        ``max_new_tokens`` to ``ceil(frac * requested)`` and the per-step
        admission token budget scales by ``frac``."""
        self.brownout = float(min(max(frac, 0.0), 1.0))

    def reconcile(self) -> dict:
        """The ledger: every submitted request is in exactly one of
        completed / rejected / timed_out / waiting / active (live or
        pending) / evicted. Returns the books and a ``balanced`` flag."""
        m = self.metrics
        books = {"submitted": m.submitted,
                 "completed": len(m.completed),
                 "rejected": len(m.rejected),
                 "timed_out": len(m.timed_out),
                 "waiting": len(self.waiting),
                 "active": (sum(r is not None for r in self.active)
                            + len(self._pend)),
                 "evicted": m.evicted}
        books["balanced"] = (
            books["submitted"] == books["completed"] + books["rejected"]
            + books["timed_out"] + books["waiting"] + books["active"]
            + books["evicted"])
        books["decode_utilization"] = {
            "decode_steps": m.decode_steps,
            "extend_chunks": m.extend_chunks,
            "admit_stall_steps": m.admit_stall_steps,
        }
        return books

    # --------------------------------------------------------------- step
    def step(self) -> int:
        """Admit waiting requests, run one batched decode. Returns #active."""
        if self._has_deadlines:
            now = self._clock()
            rows = [(i, r) for i, r in enumerate(self.active) if r is not None]
            rows += [(i, entry[0]) for i, entry in self._pend.items()]
            for i, r in rows:
                if r.deadline_s is not None and now >= r.deadline_s:
                    r.finish_s = now
                    self.metrics.timed_out.append(r)
                    self.metrics.lost_tokens += len(r.tokens)
                    self.release_slot(i)       # drops a pending entry too
        pc_before = self.metrics.prefill_calls
        if self.admit_mode == "async":
            self._admit_async()
        else:
            self._admit()
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            if self.metrics.prefill_calls > pc_before:
                self.metrics.admit_stall_steps += 1
            return 0
        # batched and serial: every row decodes, free ones too (their
        # results are dropped and their cache writes are dropped in the
        # layer: past max_seq, or into the trash page through a sentinel
        # table row). Async: only the live rows move; a pending row's
        # half-filled cache must not
        rows = None
        if self.admit_mode == "async":
            mask = np.zeros((self.max_batch,), bool)
            mask[live] = True
            rows = torch.as_tensor(mask, device=self.device)
        if self.paged:
            cache = self._call_cache(self._decode_width(live))
            logits, cache = self.model.decode_fn(
                self.params, {"token": self.last_token}, cache, rows=rows)
            self.cache["pos"] = cache["pos"]
            self._slot_len[live] += 1
        else:
            logits, self.cache = self.model.decode_fn(
                self.params, {"token": self.last_token}, self.cache,
                rows=rows)
        self.metrics.decode_steps += 1
        keys = [0] * self.max_batch
        temps = [0.0] * self.max_batch
        for i in live:
            req = self.active[i]
            keys[i] = draw_key(self._seed_of(req), req.rid, len(req.tokens))
            temps[i] = req.temperature
        toks = sample_batch(logits, keys, temps)
        toks_np = toks.cpu().numpy()
        self.last_token = toks
        self.metrics.steps += 1
        now = self._clock()
        for i in live:
            req = self.active[i]
            req.tokens.append(int(toks_np[i]))
            self.new_counts[i] += 1
            if (self.new_counts[i] >= req.max_new_tokens
                    or int(toks_np[i]) == self.eos):
                req.finish_s = now
                self.metrics.completed.append(req)
                self.release_slot(i)
        return len([r for r in self.active if r is not None])

    def run(self, max_steps: int = 10_000) -> EngineMetrics:
        """Drain all waiting + active requests."""
        for _ in range(max_steps):
            n = self.step()
            if n == 0 and not self.waiting and not self._pend:
                break
        return self.metrics
