"""Port engine's async admission against the reference engine and itself.

The port's versions of the async anchors of ``tests/test_paged.py``: with
``admit_mode="async"`` the engine splits admission over steps under a
token budget and decodes the live rows while prompt tails are pending.
Both packages serve the same fp32 model (``params_from_numpy``) on
``reduced(llama3.2-1b, num_kv_heads=2, dtype="float32")``. Streams are
held equal across async, batched and serial admission (sampled rows
included: every draw is keyed by seed, request id and token index), greedy
rows equal to the reference engine's; the admission schedule of every step
(calls, chunks, the tokens spent, which rows are live and pending) equals
the reference async engine's; deadlines, brownout, preemption of a
pending row, the admission rollback and ``reconcile`` follow the
reference.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import llama32_1b as jax_llama
from repro.configs.base import reduced as jax_reduced
from repro.models.api import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import llama32_1b, reduced
from repro_torch.models import transformer as T
from repro_torch.models.api import Model, build
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import Request, ServingEngine

# the request set of tests/test_paged.py::_requests
LENGTHS = (8, 13, 5, 11, 7, 9)
TEMPS = (0.0, 0.7, 0.0, 1.3, 0.0, 0.7)
GREEDY = [i for i, t in enumerate(TEMPS) if t == 0.0]
N_NEW = 4
BUDGET = 8


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENGTHS]


def _requests(cls, prompts, temps=TEMPS, n_new=N_NEW):
    return [cls(rid=i, prompt=p, max_new_tokens=n_new, temperature=t)
            for i, (p, t) in enumerate(zip(prompts, temps))]


def _streams(eng):
    return {r.rid: list(r.tokens) for r in eng.metrics.completed}


def _schedule(eng, reqs, max_steps=100):
    """Submit ``reqs`` and step to the end, recording after each step what
    admission did: prompt tokens spent (``_admit_async``'s return), the
    call counters, and the live and pending request ids."""
    spent = []
    admit = eng._admit_async

    def recording():
        spent.append(admit())
        return spent[-1]

    eng._admit_async = recording
    for r in reqs:
        eng.submit(r)
    rows = []
    for _ in range(max_steps):
        if not eng.waiting and not eng._pend and not any(eng.active):
            break
        eng.step()
        m = eng.metrics
        rows.append((spent[-1], m.prefill_calls, m.extend_chunks,
                     m.decode_steps,
                     sorted(r.rid for r in eng.active if r is not None),
                     sorted(e[0].rid for e in eng._pend.values())))
    return rows


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _deadline_run(engine_cls, request_cls, model, params, prompt, paged):
    """A 40-token prompt under an 8-token budget: its deadline falls while
    its tail is still pending."""
    clock = Clock()
    eng = engine_cls(model, params, max_batch=4, max_seq=64,
                     admit_mode="async", admit_token_budget=BUDGET,
                     paged=paged, clock=clock)
    eng.submit(request_cls(rid=0, prompt=prompt, max_new_tokens=5,
                           deadline_s=5.0))
    eng.step()
    pending = sorted(eng._pend)
    clock.now = 10.0
    eng.run()
    return {"pending_after_step_1": pending,
            "timed_out": [r.rid for r in eng.metrics.timed_out],
            "balanced": eng.reconcile()["balanced"],
            "pages_back": (not paged
                           or len(eng._free_pages) == eng.num_pages)}


def _brownout_run(engine_cls, request_cls, model, params, prompts):
    """Brownout at 0.5 over a 16-token async budget, with one resumed
    request, which keeps its contract."""
    eng = engine_cls(model, params, max_batch=4, max_seq=64,
                     admit_mode="async", admit_token_budget=16)
    eng.set_brownout(0.5)
    reqs = _requests(request_cls, prompts, temps=(0.0,) * len(LENGTHS),
                     n_new=10)
    reqs[-1].tokens, reqs[-1].resumed_from, reqs[-1].seed = [5, 6], 2, 0
    for r in reqs:
        eng.submit(r)
    eng.step()
    first = (sorted(r.rid for r in eng.active if r is not None),
             sorted(e[0].rid for e in eng._pend.values()))
    eng.run()
    m = eng.metrics
    return {"first_step": first, "shed_tokens": m.shed_tokens,
            "lengths": sorted((r.rid, len(r.tokens), r.max_new_tokens)
                              for r in m.completed),
            "steps": m.steps}


@pytest.fixture(scope="module")
def ref():
    """The reference engine's runs, built once."""
    jcfg = jax_reduced(jax_llama, num_kv_heads=2, dtype="float32")
    cfg = reduced(llama32_1b, num_kv_heads=2, dtype="float32")
    jm = jax_build(jcfg)
    jparams = jm.init_params(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    prompts = _prompts(cfg.vocab_size)
    long = np.random.default_rng(10).integers(
        0, cfg.vocab_size, size=40).astype(np.int32)
    out = {}
    jeng = JEngine(jm, jparams, max_batch=4, max_seq=64, admit_mode="serial")
    for r in _requests(JRequest, prompts):
        jeng.submit(r)
    jeng.run()
    out["streams"] = _streams(jeng)
    for paged in (False, True):
        jeng = JEngine(jm, jparams, max_batch=4, max_seq=64, paged=paged,
                       page_size=8, admit_mode="async",
                       admit_token_budget=BUDGET)
        out["schedule", paged] = _schedule(jeng, _requests(JRequest,
                                                           prompts))
        out["deadline", paged] = _deadline_run(JEngine, JRequest, jm,
                                               jparams, long, paged)
    out["brownout"] = _brownout_run(JEngine, JRequest, jm, jparams, prompts)
    return cfg, build(cfg), params, prompts, long, out


def _engine(model, params, mode="async", paged=False, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 64)
    return ServingEngine(model, params, admit_mode=mode, paged=paged,
                         page_size=8, **kw)


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    return _streams(eng)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_async_equals_batched_equals_serial(ref, paged):
    """The same streams whatever the admission path, sampled rows
    included; greedy rows equal to the reference engine's."""
    cfg, model, params, prompts, _, jout = ref
    streams = {}
    for mode, kw in (("serial", {}), ("batched", {}),
                     ("async", {"admit_token_budget": BUDGET}),
                     ("async", {})):
        eng = _engine(model, params, mode, paged, **kw)
        got = _run(eng, _requests(Request, prompts))
        assert len(got) == len(LENGTHS)
        assert eng.reconcile()["balanced"] and not eng._pend
        if paged:
            assert len(eng._free_pages) == eng.num_pages
        streams[mode, bool(kw)] = got
    first = streams["serial", False]
    assert all(s == first for s in streams.values())
    assert {i: first[i] for i in GREEDY} == {i: jout["streams"][i]
                                            for i in GREEDY}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_async_schedule_matches_reference(ref, paged):
    """Step by step, the port's arbiter spends the tokens the reference's
    spends, with the same prefill calls, extend chunks and decode steps
    and the same live and pending rows; every chunk and bucket fits the
    budget (no prompt here is longer than twice it)."""
    cfg, model, params, prompts, _, jout = ref
    eng = _engine(model, params, paged=paged, admit_token_budget=BUDGET)
    sizes = []
    extend, prefill = model.extend_fn, model.prefill_fn

    def extend_fn(p, inputs, cache, **kw):
        sizes.append(inputs["tokens"].shape[1])
        return extend(p, inputs, cache, **kw)

    def prefill_fn(p, inputs, **kw):
        sizes.append(inputs["tokens"].shape[1])
        return prefill(p, inputs, **kw)

    eng.model = Model(model.cfg, model.init_params, prefill_fn, extend_fn,
                      model.decode_fn)
    rows = _schedule(eng, _requests(Request, prompts))
    assert rows == jout["schedule", paged]
    assert max(sizes) <= BUDGET
    assert any(pend for *_, pend in rows)      # tails really were pending
    assert eng.metrics.extend_chunks >= 2


def test_async_decodes_while_a_tail_is_pending(ref):
    """A long prompt streams in under the budget while a live request
    keeps decoding (its pending row masked out of the decode)."""
    cfg, model, params, *_ = ref
    eng = _engine(model, params, paged=True, admit_token_budget=BUDGET)
    rng = np.random.default_rng(9)
    eng.submit(Request(rid=1, prompt=rng.integers(
        0, cfg.vocab_size, size=8).astype(np.int32), max_new_tokens=8))
    eng.step()
    live1 = next(r for r in eng.active if r is not None)
    eng.submit(Request(rid=0, prompt=rng.integers(
        0, cfg.vocab_size, size=47).astype(np.int32), max_new_tokens=3))
    overlapped = 0
    for _ in range(4):
        before = len(live1.tokens)
        eng.step()
        overlapped += bool(eng._pend) and len(live1.tokens) > before
    assert overlapped >= 1
    m = eng.run()
    s = m.summary()
    assert s["num_completed"] == 2 and s["extend_chunks"] >= 2
    assert eng.reconcile()["decode_utilization"]["decode_steps"] == \
        s["decode_steps"] > 0
    assert len(eng._free_pages) == eng.num_pages


def test_masked_decode_leaves_other_rows(ref):
    """``decode_fn(rows=...)``: a masked row's cache and ``pos`` stay as
    they were, dense and paged; the live row's logits and cache are those
    of the unmasked call."""
    cfg, model, params, *_ = ref
    gen = torch.Generator().manual_seed(0)
    for paged in (False, True):
        if paged:
            c = T.make_paged_decode_cache(cfg, 2, 32, "cpu", page_size=8)
            c["table"] = torch.randperm(8, generator=gen).reshape(2, 4).to(
                torch.int32)
            row = lambda t, b: t[:, c["table"][b].long()]
        else:
            c = T.make_decode_cache(cfg, 2, 32, "cpu")
            row = lambda t, b: t[:, b]
        for leaf in c["kv"].values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
        c["pos"] = torch.tensor([5, 9], dtype=torch.int32)
        full = {**c, "kv": {n: t.clone() for n, t in c["kv"].items()}}
        before = {n: t.clone() for n, t in c["kv"].items()}
        tok = torch.tensor([3, 7], dtype=torch.int32)
        lf, full = model.decode_fn(params, {"token": tok}, full)
        lm, c = model.decode_fn(params, {"token": tok}, c,
                                rows=torch.tensor([True, False]))
        torch.testing.assert_close(lm[0], lf[0])
        assert c["pos"].tolist() == [6, 9]
        for n in ("k", "v"):
            torch.testing.assert_close(row(c["kv"][n], 0),
                                       row(full["kv"][n], 0))
            torch.testing.assert_close(row(c["kv"][n], 1),
                                       row(before[n], 1))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_deadline_sweeps_a_pending_row(ref, paged):
    cfg, model, params, _, long, jout = ref
    got = _deadline_run(ServingEngine, Request, model, params, long, paged)
    assert got == jout["deadline", paged]
    assert got["pending_after_step_1"] and got["timed_out"] == [0]
    assert got["balanced"] and got["pages_back"]


def test_async_brownout_sheds_as_the_reference(ref):
    cfg, model, params, prompts, _, jout = ref
    got = _brownout_run(ServingEngine, Request, model, params, prompts)
    assert got == jout["brownout"]
    assert got["shed_tokens"] > 0
    assert (5, 10, 10) in got["lengths"]      # the resumed one


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_preempt_catches_a_pending_row_and_resume_is_bit_identical(
        ref, paged):
    """A power drop while a prompt tail is pending: the pending request is
    snapshotted with the live ones, its pages come back, and the resumed
    streams (on an engine with another seed) equal the uninterrupted
    run's."""
    cfg, model, params, prompts, _, _ = ref
    want = _run(_engine(model, params, "serial", paged, seed=3),
                _requests(Request, prompts))
    e1 = _engine(model, params, paged=paged, seed=3, admit_token_budget=4)
    for r in _requests(Request, prompts):
        e1.submit(r)
    for _ in range(2):
        e1.step()
    live = [r.rid for r in e1.active if r is not None]
    pending = [e[0].rid for e in e1._pend.values()]
    assert live and pending
    books = e1.reconcile()
    assert books["balanced"] and books["active"] == len(live) + len(pending)
    snaps = e1.drain()
    assert {s.rid for s in snaps} >= set(live + pending)
    assert [s.tokens for s in snaps if s.rid in pending] == [[]] * len(
        pending)
    assert not e1._pend and e1.reconcile()["balanced"]
    assert e1.metrics.preemptions == len(live) + len(pending)
    if paged:
        assert len(e1._free_pages) == e1.num_pages
    e2 = _engine(model, params, paged=paged, seed=50, admit_token_budget=4)
    for s in snaps:
        assert e2.resume(s) is not None
    e2.run()
    got = {**_streams(e1), **_streams(e2)}
    assert got == want
    assert e2.reconcile()["balanced"]


def test_async_rollback_releases_pending_pages(ref, monkeypatch):
    """An admission failure (injected at the page insert) leaves no page
    reserved, no pending row, and the requests back at the queue's head."""
    cfg, model, params, prompts, _, _ = ref
    eng = _engine(model, params, paged=True, admit_token_budget=BUDGET)
    for r in _requests(Request, prompts)[:2]:
        eng.submit(r)

    def boom(*a, **k):
        raise RuntimeError("injected page insert failure")

    monkeypatch.setattr(engine_mod, "insert_cache_pages", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    assert sorted(eng._free_pages) == list(range(eng.num_pages))
    assert (eng._tbl == eng.num_pages).all()
    assert not eng._pend and all(r is None for r in eng.active)
    assert [r.rid for r in eng.waiting] == [0, 1]
    monkeypatch.undo()
    assert eng.run().summary()["num_completed"] == 2
    assert len(eng._free_pages) == eng.num_pages
