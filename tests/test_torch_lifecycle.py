"""Port serving engine's request lifecycle against the reference engine.

The port's versions of the anchors of ``tests/test_faults.py``: a request
preempted mid-decode and resumed on an engine with another seed continues
the stream of the uninterrupted serial run, dense and paged, through one
or two interruptions; ``drain`` empties the engine and ``reconcile``
balances. Both packages serve the same fp32 model (``params_from_numpy``);
greedy rows must equal the reference engine's streams, sampled rows the
port's own uninterrupted run (the reference's threefry bits are not
reproduced). The host-side lifecycle (watermark, deadlines, brownout,
``retry_backoff``, transcript files) is held equal to the reference
engine's on the same requests and the same virtual clock.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.checkpoint.store import TranscriptSnapshot as JSnapshot
from repro.checkpoint.store import load_transcripts as jload
from repro.checkpoint.store import save_transcripts as jsave
from repro.configs import llama32_1b as jax_llama
from repro.configs.base import reduced as jax_reduced
from repro.models.api import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import retry_backoff as jretry_backoff
from repro_torch.checkpoint.store import (TranscriptSnapshot, load_transcripts,
                                          save_transcripts)
from repro_torch.configs import llama32_1b, reduced
from repro_torch.models.api import build
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Request, ServingEngine, retry_backoff

# tests/test_faults.py::_requests: five requests, one past max_batch=4 so
# that drain also hands out a queued one; greedy and sampled rows
LENGTHS = (7, 12, 5, 9, 6)
TEMPS = (0.0, 0.9, 1.3, 0.0, 0.7)
GREEDY = [i for i, t in enumerate(TEMPS) if t == 0.0]
N_NEW = 10


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENGTHS]


def _requests(cls, prompts, n_new=N_NEW, **kw):
    return [cls(rid=i, prompt=p, max_new_tokens=n_new, temperature=t, **kw)
            for i, (p, t) in enumerate(zip(prompts, TEMPS))]


def _run(eng, max_steps=400):
    for _ in range(max_steps):
        if not eng.waiting and not any(r is not None for r in eng.active):
            break
        eng.step()
    return {r.rid: list(r.tokens) for r in eng.metrics.completed}


class Clock:
    """The virtual clock both engines read."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _deadline_run(engine_cls, request_cls, model, params, prompts):
    """One slot, two requests: the live one's deadline falls mid-decode,
    the queued one's before a slot frees up."""
    clock = Clock()
    eng = engine_cls(model, params, max_batch=1, max_seq=64, clock=clock)
    eng.submit(request_cls(rid=0, prompt=prompts[0], max_new_tokens=N_NEW,
                           deadline_s=4.0))
    eng.submit(request_cls(rid=1, prompt=prompts[1], max_new_tokens=3,
                           deadline_s=2.0))
    for t in range(8):
        clock.now = float(t)
        eng.step()
    m = eng.metrics
    return {"timed_out": [(r.rid, len(r.tokens), r.finish_s)
                          for r in m.timed_out],
            "lost_tokens": m.lost_tokens, "completed": len(m.completed),
            "balanced": eng.reconcile()["balanced"]}


def _brownout_run(engine_cls, request_cls, model, params, prompts):
    """Brownout at 0.5 over a 40-token admission budget; one resumed
    request, which keeps its contract, among fresh ones."""
    eng = engine_cls(model, params, max_batch=4, max_seq=64,
                     admit_token_budget=40)
    eng.set_brownout(0.5)
    reqs = _requests(request_cls, prompts)
    reqs[-1].tokens, reqs[-1].resumed_from, reqs[-1].seed = [5, 6], 2, 0
    for r in reqs:
        eng.submit(r)
    eng.step()
    first = sorted(r.rid for r in eng.active if r is not None)
    _run(eng)
    m = eng.metrics
    return {"first_step": first, "shed_tokens": m.shed_tokens,
            "lengths": sorted((r.rid, len(r.tokens), r.max_new_tokens)
                              for r in m.completed),
            "steps": m.steps}


def _watermark_run(engine_cls, request_cls, model, params, prompts):
    eng = engine_cls(model, params, max_batch=4, max_seq=64,
                     queue_watermark=2)
    took = [eng.submit(r) for r in _requests(request_cls, prompts)]
    return {"took": took, "rejected": [r.rid for r in eng.metrics.rejected],
            "books": {k: v for k, v in eng.reconcile().items()
                      if k != "decode_utilization"}}


@pytest.fixture(scope="module")
def ref():
    """The reference engine's runs, built once."""
    jcfg = jax_reduced(jax_llama, num_kv_heads=2, dtype="float32")
    cfg = reduced(llama32_1b, num_kv_heads=2, dtype="float32")
    jm = jax_build(jcfg)
    jparams = jm.init_params(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    prompts = _prompts(cfg.vocab_size)
    jeng = JEngine(jm, jparams, max_batch=4, max_seq=64, admit_mode="serial")
    for r in _requests(JRequest, prompts):
        jeng.submit(r)
    out = {"streams": _run(jeng)}
    for name, fn in (("deadline", _deadline_run), ("brownout", _brownout_run),
                     ("watermark", _watermark_run)):
        out[name] = fn(JEngine, JRequest, jm, jparams, prompts)
    return cfg, build(cfg), params, prompts, out


def _engine(model, params, paged, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 64)
    return ServingEngine(model, params, paged=paged, page_size=8, **kw)


@pytest.fixture(scope="module")
def uninterrupted(ref):
    """The port's uninterrupted serial run of the five requests."""
    cfg, model, params, prompts, jout = ref
    eng = _engine(model, params, False, admit_mode="serial")
    for r in _requests(Request, prompts):
        eng.submit(r)
    streams = _run(eng)
    assert len(streams) == len(LENGTHS)
    assert {i: streams[i] for i in GREEDY} == {
        i: jout["streams"][i] for i in GREEDY}
    return streams


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("seed", [0, 7])
def test_preempt_resume_across_engines(ref, uninterrupted, paged, seed):
    """Preempt mid-decode, resume on an engine with another seed: the
    streams of the uninterrupted run, greedy rows equal to the reference
    engine's."""
    cfg, model, params, prompts, jout = ref
    want = uninterrupted
    if seed:
        e0 = _engine(model, params, paged, admit_mode="serial", seed=seed)
        for r in _requests(Request, prompts):
            e0.submit(r)
        want = _run(e0)
        assert {i: want[i] for i in GREEDY} == {
            i: jout["streams"][i] for i in GREEDY}
    e1 = _engine(model, params, paged, seed=seed)
    for r in _requests(Request, prompts):
        assert e1.submit(r)
    for _ in range(3):                      # mid-decode, nothing finished
        e1.step()
    snaps = e1.drain()
    assert len(snaps) == 5                  # 4 live slots + 1 queued
    assert len([s for s in snaps if 0 < len(s.tokens) < N_NEW]) == 4
    assert all(s.seed == seed for s in snaps)
    assert not any(r is not None for r in e1.active) and not e1.waiting
    assert e1.reconcile()["balanced"]
    if paged:
        assert len(e1._free_pages) == e1.num_pages

    e2 = _engine(model, params, paged, seed=seed + 91)
    for s in snaps:
        assert e2.resume(s) is not None
    got = _run(e2)
    assert e2.reconcile()["balanced"]
    assert e2.metrics.recovered_tokens == sum(len(s.tokens) for s in snaps)
    assert e2.metrics.resumed == 5
    assert got == want
    if paged:
        assert len(e2._free_pages) == e2.num_pages


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_second_preempt_and_resume_gives_same_streams(ref, uninterrupted,
                                                      paged):
    cfg, model, params, prompts, _ = ref
    eng = _engine(model, params, paged)
    for r in _requests(Request, prompts):
        eng.submit(r)
    got = {}
    for hop, nsteps in enumerate((2, 3)):   # two interruptions
        for _ in range(nsteps):
            eng.step()
        snaps = eng.drain()
        got.update({r.rid: list(r.tokens) for r in eng.metrics.completed})
        eng = _engine(model, params, paged, seed=17 + hop)
        for s in snaps:
            assert eng.resume(s) is not None
    got.update(_run(eng))
    assert got == uninterrupted


def test_resumed_request_keeps_first_prefill_time(ref):
    cfg, model, params, prompts, _ = ref
    clock = Clock()
    e1 = _engine(model, params, False, clock=clock)
    e1.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=N_NEW))
    e1.step()
    clock.now = 5.0
    e1.step()
    (snap,) = e1.preempt()
    assert snap.prefill_done_s == 0.0 and len(snap.tokens) == 3
    clock.now = 9.0
    e2 = _engine(model, params, False, clock=clock, seed=3)
    req = e2.resume(snap)
    _run(e2)
    assert req.prefill_done_s == 0.0 and req.ttft == 0.0
    assert req.finish_s == 9.0 and len(req.tokens) == N_NEW


def test_drain_hands_out_the_queue_and_reconcile_balances(ref):
    cfg, model, params, prompts, _ = ref
    eng = _engine(model, params, True, max_batch=2)
    for r in _requests(Request, prompts):
        eng.submit(r)
    eng.step()
    books = eng.reconcile()
    assert (books["active"], books["waiting"], books["balanced"]) == (2, 3,
                                                                     True)
    snaps = eng.drain()
    books = eng.reconcile()
    assert (books["evicted"], books["active"], books["waiting"]) == (5, 0, 0)
    assert books["balanced"] and eng.metrics.preemptions == 2
    assert sorted(s.rid for s in snaps) == list(range(5))
    assert len(eng._free_pages) == eng.num_pages


def test_queue_watermark_rejects(ref):
    cfg, model, params, prompts, jout = ref
    got = _watermark_run(ServingEngine, Request, model, params, prompts)
    assert got == jout["watermark"]
    assert got["took"] == [True, True, False, False, False]
    eng = _engine(model, params, False, queue_watermark=1)
    snap = TranscriptSnapshot(rid=9, prompt=prompts[0], tokens=[1],
                              max_new_tokens=4, temperature=0.0, seed=0)
    assert eng.resume(snap) is not None
    assert eng.resume(snap) is None         # the caller keeps the snapshot
    assert eng.metrics.resumed == 1


def test_deadlines_expire_queued_and_live_requests(ref):
    cfg, model, params, prompts, jout = ref
    got = _deadline_run(ServingEngine, Request, model, params, prompts)
    assert got == jout["deadline"]
    assert [rid for rid, _, _ in got["timed_out"]] == [1, 0]
    assert got["lost_tokens"] > 0 and got["balanced"]


def test_brownout_sheds_as_the_reference(ref):
    cfg, model, params, prompts, jout = ref
    got = _brownout_run(ServingEngine, Request, model, params, prompts)
    assert got == jout["brownout"]
    assert got["shed_tokens"] > 0
    assert (4, N_NEW, N_NEW) in got["lengths"]   # the resumed one
    assert len(got["first_step"]) < 4       # the budget scaled down


def test_backoff_holds_a_request_without_blocking_the_queue(ref):
    cfg, model, params, prompts, _ = ref
    clock = Clock()
    eng = _engine(model, params, False, clock=clock)
    held, fresh = _requests(Request, prompts)[:2]
    held.not_before_s = retry_backoff(3)
    eng.submit(held)
    eng.submit(fresh)
    eng.step()
    assert [r.rid for r in eng.active if r is not None] == [1]
    assert [r.rid for r in eng.waiting] == [0]
    clock.now = retry_backoff(3)
    eng.step()
    assert sorted(r.rid for r in eng.active if r is not None) == [0, 1]


def test_retry_backoff_matches_reference():
    for attempts in range(0, 25):
        assert retry_backoff(attempts) == jretry_backoff(attempts)
    assert retry_backoff(2, base=0.5, cap=0.7) == jretry_backoff(
        2, base=0.5, cap=0.7)


def test_transcript_files_load_in_either_package(tmp_path):
    kw = dict(rid=4, prompt=np.arange(6, dtype=np.int32), tokens=[3, 1, 4],
              max_new_tokens=9, temperature=0.7, seed=11, arrival_s=1.5,
              prefill_done_s=2.0, attempts=2, deadline_s=30.0)
    fields = list(kw)

    def same(a, b):
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, f

    port = str(tmp_path / "port.json")
    save_transcripts(port, [TranscriptSnapshot(**kw)], extra={"site": 1})
    snaps, extra = jload(port)
    same(snaps[0], JSnapshot(**kw))
    assert extra == {"site": 1}
    refp = str(tmp_path / "ref.json")
    jsave(refp, [JSnapshot(**{**kw, "deadline_s": None})])
    snaps, extra = load_transcripts(refp)
    same(snaps[0], TranscriptSnapshot(**{**kw, "deadline_s": None}))
    assert extra == {}
