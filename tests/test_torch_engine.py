"""Port serving engine against the reference engine and against itself.

Both engines serve the same requests with the same weights (carried
across with ``params_from_numpy``) at fp32, on
``reduced(llama3.2-1b, num_kv_heads=2, dtype="float32")``. Greedy token
streams and the admission schedule (``prefill_calls``) must be equal: the
port keeps the reference's bucket and chunk schedule. Sampled rows use
other random bits than the reference (threefry is not reproduced), so for
them the anchor is the port's own: batched admission == serial admission.
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
from repro_torch.models.api import build
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sampling import draw_key, sample_batch

# the request set of tests/test_serving_batched.py::_requests
LENGTHS = (8, 13, 5, 11, 7, 9)
TEMPS = (0.0, 0.7, 0.0, 1.3, 0.0, 0.7)


def _prompts(vocab, seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    m = engine.run()
    return {r.rid: list(r.tokens) for r in m.completed}, m.summary()


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_llama, num_kv_heads=2, dtype="float32")
    cfg = reduced(llama32_1b, num_kv_heads=2, dtype="float32")
    jm = jax_build(jcfg)
    jparams = jm.init_params(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    prompts = _prompts(cfg.vocab_size)
    jeng = JEngine(jm, jparams, max_batch=4, max_seq=64)
    jstreams, jsum = _run(jeng, [JRequest(rid=i, prompt=p, max_new_tokens=5)
                                 for i, p in enumerate(prompts)])
    return cfg, build(cfg), params, prompts, jstreams, jsum


def _engine(model, params, mode="batched", **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 64)
    return ServingEngine(model, params, admit_mode=mode, **kw)


def _reqs(prompts, temps=(0.0,) * len(LENGTHS), n_new=5):
    return [Request(rid=i, prompt=p, max_new_tokens=n_new, temperature=t)
            for i, (p, t) in enumerate(zip(prompts, temps))]


def test_batched_greedy_streams_match_reference(setup):
    cfg, model, params, prompts, jstreams, jsum = setup
    streams, s = _run(_engine(model, params), _reqs(prompts))
    assert s["num_completed"] == len(LENGTHS)
    assert streams == jstreams
    assert s["prefill_calls"] == jsum["prefill_calls"]
    assert s["steps"] == jsum["steps"]


def test_batched_matches_serial_with_sampled_rows(setup):
    """Per-(seed, rid, token-index) draws: the same streams whatever the
    admission path, sampled rows included."""
    cfg, model, params, prompts, _, _ = setup
    out = {mode: _run(_engine(model, params, mode), _reqs(prompts, TEMPS))
           for mode in ("serial", "batched")}
    assert out["batched"][0] == out["serial"][0]
    assert out["serial"][1]["prefill_calls"] > out["batched"][1]["prefill_calls"]


def test_free_slot_decodes_past_max_seq(setup):
    """A free slot's ``pos`` grows by one every step; past ``max_seq`` its
    cache writes must be dropped, not indexed out of range, and must not
    disturb the live slot."""
    cfg, model, params, prompts, _, _ = setup
    eng = _engine(model, params, max_batch=2, max_seq=16)
    streams = {}
    for i in range(3):                       # slot 0 serves them in turn
        s, _ = _run(eng, [Request(rid=i, prompt=prompts[i][:4],
                                  max_new_tokens=12)])
        streams.update(s)
    assert eng.metrics.decode_steps == 33
    assert int(eng.cache["pos"][1]) > eng.max_seq
    # the last request ran beside a free slot past max_seq: a fresh engine
    # gives the same stream
    alone, _ = _run(_engine(model, params, max_batch=2, max_seq=16),
                    [Request(rid=2, prompt=prompts[2][:4], max_new_tokens=12)])
    assert alone[2] == streams[2]


def test_oversized_and_empty_requests(setup):
    """Prompts that can never fit are rejected without a slot; a request
    for no tokens completes with none; the queue keeps serving."""
    cfg, model, params, prompts, _, _ = setup
    eng = _engine(model, params, max_seq=32)
    long = np.zeros(40, np.int32)
    _, s = _run(eng, [Request(rid=0, prompt=long, max_new_tokens=2),
                      Request(rid=1, prompt=prompts[0], max_new_tokens=30),
                      Request(rid=2, prompt=np.zeros(0, np.int32),
                              max_new_tokens=2),
                      Request(rid=3, prompt=prompts[1], max_new_tokens=0),
                      Request(rid=4, prompt=prompts[2], max_new_tokens=4)])
    assert {r.rid for r in eng.metrics.rejected} == {0, 1, 2}
    assert {r.rid: len(r.tokens) for r in eng.metrics.completed} == {3: 0,
                                                                     4: 4}


def test_admit_token_budget_bounds_per_step_work(setup):
    cfg, model, params, prompts, _, _ = setup
    eng = _engine(model, params, max_batch=8, admit_token_budget=16)
    for i in range(6):
        eng.submit(Request(rid=i, prompt=prompts[0], max_new_tokens=4))
    assert eng.step() == 2                   # 16-token budget -> 2 prompts
    assert len(eng.waiting) == 4
    assert eng.run().summary()["num_completed"] == 6


@pytest.mark.parametrize("kw", [dict(admit_mode="async"),
                                dict(admit_mode="async", paged=True),
                                dict(admit_mode="async", queue_watermark=4)])
def test_async_modes_serve_reference_streams(setup, kw):
    """Async engines (dense, paged, under a queue watermark) serve the JAX
    engine's greedy streams; only an admission mode neither package has
    raises."""
    cfg, model, params, prompts, jstreams, _ = setup
    streams, s = _run(ServingEngine(model, params, max_batch=4, max_seq=64,
                                    **kw), _reqs(prompts))
    assert s["num_completed"] + s["rejected"] == len(LENGTHS)
    assert streams == {rid: jstreams[rid] for rid in streams}
    with pytest.raises(ValueError):
        ServingEngine(model, params, **{**kw, "admit_mode": "eager"})


def test_sample_rows_independent_of_batch():
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    keys = [draw_key(0, rid, 7) for rid in (1, 2, 3)]
    temps = [0.0, 0.9, 1.5]
    batch = sample_batch(logits, keys, temps)
    rows = [sample_batch(logits[r:r + 1], keys[r:r + 1], temps[r:r + 1])[0]
            for r in range(3)]
    assert batch.tolist() == [int(t) for t in rows]
    assert int(batch[0]) == int(logits[0].argmax())
    assert len({draw_key(0, 1, i) for i in range(100)}
               | {draw_key(1, 1, i) for i in range(100)}) == 200
