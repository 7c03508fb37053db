"""Port paged KV cache against the reference package, and its page
accounting.

The same inputs, drawn with numpy, go through the reference (its Pallas
kernels in interpret mode, its plain versions in ``repro.kernels.ref``,
its model and its engine) and through ``repro_torch``. The reference's
pools hold P pages and drop writes through the sentinel id P; the port's
hold one more, the trash page, and ``models.convert.cache_from_numpy``
appends it. fp32 kernels agree to 2e-5 (the same math, summed in another
order); model logits to 1e-4; greedy streams exactly. The reference makes
paged and dense bitwise equal by padding the softmax sum to the dense
width; the port does not, so its paged and dense paths are held to equal
greedy streams and logits within 1e-4, not to bitwise equality.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama32_1b as jax_llama
from repro.configs.base import reduced as jax_reduced
from repro.kernels import ref as jref
from repro.kernels.decode_attention import (
    paged_decode_attention as jpaged_decode)
from repro.kernels.flash_attention import (
    paged_extend_attention as jpaged_extend)
from repro.models import transformer as JT
from repro.models.api import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import llama32_1b, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as Lyr
from repro_torch.models import transformer as T
from repro_torch.models.api import build
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import Request, ServingEngine

KTOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _mk_paged(rng, B, S, page, KVH, hd, lengths):
    """Dense rows and the same rows scattered over a permuted page pool
    (the reference's test layout); sentinel P past each row's pages. The
    port's pools carry the trash page after the P real ones."""
    maxP = S // page
    P = B * maxP
    perm = list(rng.permutation(P))
    table = np.full((B, maxP), P, np.int32)
    for b in range(B):
        for j in range(min(-(-int(lengths[b]) // page), maxP)):
            table[b, j] = perm.pop()
    kd, vd = (rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
              for _ in range(2))
    pools = [np.zeros((P + 1, page, KVH, hd), np.float32) for _ in range(2)]
    for b in range(B):
        for j in range(maxP):
            if table[b, j] < P:
                pools[0][table[b, j]] = kd[b, j * page:(j + 1) * page]
                pools[1][table[b, j]] = vd[b, j * page:(j + 1) * page]
    return kd, vd, pools[0], pools[1], table, np.asarray(lengths, np.int32)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


# ----------------------------------------------------------- plain kernels
@pytest.mark.parametrize("B,S,page,KVH,H,hd,lengths", [
    (2, 64, 16, 2, 8, 64, (17, 64)),
    (3, 32, 8, 1, 6, 16, (1, 32, 13)),
])
def test_paged_decode_plain_matches_pallas(B, S, page, KVH, H, hd, lengths):
    """The plain paged decode against the Pallas kernel (interpret mode)
    and the dense oracle, over a permutation-allocated pool."""
    rng = np.random.default_rng(0)
    kd, vd, kp, vp, tab, lens = _mk_paged(rng, B, S, page, KVH, hd, lengths)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    want = jpaged_decode(jnp.asarray(q), jnp.asarray(kp[:-1]),
                         jnp.asarray(vp[:-1]), jnp.asarray(tab),
                         jnp.asarray(lens), interpret=True)
    tq, tkp, tvp, ttab, tlens = _t(q, kp, vp, tab, lens)
    got = ops.paged_decode_attention(tq, tkp, tvp, ttab, tlens)
    _close(got, want, KTOL)
    _close(got, jref.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp[:-1]), jnp.asarray(vp[:-1]),
        jnp.asarray(tab), jnp.asarray(lens)), KTOL)
    # the gathered rows agree wherever the table maps a page (a sentinel
    # gathers the last real page there, the trash page here)
    mapped = np.repeat(tab < kp.shape[0] - 1, page, axis=1)
    np.testing.assert_array_equal(
        ref.paged_gather_ref(tkp, ttab).numpy()[mapped],
        np.asarray(jref.paged_gather_ref(jnp.asarray(kp[:-1]),
                                         jnp.asarray(tab)))[mapped])
    _close(got, jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(kd),
                                          jnp.asarray(vd),
                                          jnp.asarray(lens)), KTOL)


def test_paged_decode_plain_clamps_length_to_table_width():
    """A row's length past its (narrowed) table counts only the pages the
    table holds: the same result as the length clamped to W * page."""
    rng = np.random.default_rng(1)
    _, _, kp, vp, tab, lens = _mk_paged(rng, 2, 64, 16, 2, 16, (64, 30))
    q = rng.standard_normal((2, 8, 16)).astype(np.float32)
    tq, tkp, tvp, ttab = _t(q, kp, vp, tab[:, :2])
    lens = lambda *xs: torch.tensor(xs, dtype=torch.int32)
    long = ops.paged_decode_attention(tq, tkp, tvp, ttab, lens(900, 30))
    clamped = ops.paged_decode_attention(tq, tkp, tvp, ttab, lens(32, 30))
    torch.testing.assert_close(long, clamped, rtol=0, atol=0)


def test_paged_decode_plain_int8_fused_dequant():
    """int8 pools with per-(page, token, head) scales: the plain version's
    dequant against the Pallas kernel's fused dequant, within 2e-4."""
    rng = np.random.default_rng(1)
    B, S, page, KVH, H, hd = 2, 64, 16, 2, 8, 64
    _, _, kp, vp, tab, lens = _mk_paged(rng, B, S, page, KVH, hd, (3, 47))
    ks = np.abs(kp).max(axis=-1) / 127.0 + 1e-8
    vs = np.abs(vp).max(axis=-1) / 127.0 + 1e-8
    kq = np.clip(np.round(kp / ks[..., None]), -127, 127).astype(np.int8)
    vq = np.clip(np.round(vp / vs[..., None]), -127, 127).astype(np.int8)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    j = [jnp.asarray(a) for a in (q, kq[:-1], vq[:-1], tab, lens, ks[:-1],
                                  vs[:-1])]
    want = jpaged_decode(j[0], j[1], j[2], j[3], j[4], k_scale=j[5],
                         v_scale=j[6], interpret=True)
    tq, tkq, tvq, ttab, tlens, tks, tvs = _t(q, kq, vq, tab, lens, ks, vs)
    got = ops.paged_decode_attention(tq, tkq, tvq, ttab, tlens, k_scale=tks,
                                     v_scale=tvs)
    _close(got, want, dict(atol=2e-4, rtol=2e-4))


@pytest.mark.parametrize("B,S,page,KVH,H,hd,C,pos", [
    (2, 64, 16, 2, 8, 64, 16, (0, 33)),
    (3, 32, 8, 1, 6, 16, 8, (5, 24, 17)),
])
def test_paged_extend_plain_matches_pallas(B, S, page, KVH, H, hd, C, pos):
    """Chunk attention continued from a paged cache: the plain version
    against the Pallas kernel (interpret mode) and the reference's plain
    version."""
    rng = np.random.default_rng(2)
    _, _, kp, vp, tab, lens = _mk_paged(rng, B, S, page, KVH, hd,
                                        [p + C for p in pos])
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, C, KVH, hd)).astype(np.float32)
              for _ in range(2))
    posa = np.asarray(pos, np.int32)
    j = [jnp.asarray(a) for a in (q, kp[:-1], vp[:-1], kn, vn, tab, posa)]
    want = jpaged_extend(*j, interpret=True)
    got = ops.paged_extend_attention(*_t(q, kp, vp, kn, vn, tab, posa))
    _close(got, want, KTOL)
    _close(got, jref.paged_extend_attention_ref(*j), KTOL)


def test_sentinel_writes_leave_mapped_pages_untouched():
    """Writes through the sentinel, past the table's width, or of a row
    left out by ``rows`` land in the trash page and nowhere else."""
    rng = np.random.default_rng(3)
    P, page = 6, 4
    pool = torch.from_numpy(rng.standard_normal((P + 1, page, 2, 8))
                            .astype(np.float32))
    before = pool.clone()
    table = torch.tensor([[P, P], [2, 4], [1, P]], dtype=torch.int32)
    new = torch.ones((3, 5, 2, 8))
    # row 0: all sentinel; row 1: masked out; row 2: 1 past its page
    Lyr._paged_cache_insert_chunk(pool, new, table,
                                  torch.tensor([3, 0, 3]),
                                  rows=torch.tensor([True, False, True]))
    assert torch.equal(pool[:P][[0, 2, 3, 4, 5]], before[:P][[0, 2, 3, 4, 5]])
    assert torch.equal(pool[1, :3], before[1, :3])
    assert torch.equal(pool[1, 3], new[2, 0])    # row 2, position 3
    # one token past the narrowed width goes to the trash page too
    Lyr._paged_cache_insert(pool, -new[:, 0], table[:, :1],
                            torch.tensor([0, 4, 1]))
    assert torch.equal(pool[2, 0], before[2, 0])  # row 1 pos 4 is page 1
    assert torch.equal(pool[1, 1], -new[2, 0])


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_llama, num_kv_heads=2, dtype="float32")
    cfg = reduced(llama32_1b, num_kv_heads=2, dtype="float32")
    jm = jax_build(jcfg)
    jparams = jm.init_params(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jm, jparams, cfg, build(cfg), params


def _paged_caches(jcfg, pos, seed=0, max_seq=32, page=8):
    """A populated paged cache at per-row lengths ``pos``, both sides."""
    rng = np.random.default_rng(seed)
    B = len(pos)
    jc = JT.make_paged_decode_cache(jcfg, B, max_seq, page_size=page)
    P, maxP = jc["kv"]["k"].shape[1], max_seq // page
    perm = rng.permutation(P)
    table = perm[:B * maxP].reshape(B, maxP).astype(np.int32)
    table[0, 2:] = P                       # row 0 owns two pages only
    kv = {n: rng.standard_normal(jc["kv"][n].shape).astype(np.float32)
          for n in ("k", "v")}
    jc = {"kv": {n: jnp.asarray(a) for n, a in kv.items()},
          "table": jnp.asarray(table), "span": jc["span"],
          "pos": jnp.asarray(np.asarray(pos, np.int32))}
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    return jc, tc


def _close_pools(tc, jc):
    """Pools agree on every real page (the trash page is the port's own)."""
    for n in jc["kv"]:
        _close(tc["kv"][n][:, :-1], jc["kv"][n], TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("C", [1, 5])
def test_paged_extend_fn_matches_reference(pair, C):
    jcfg, jm, jparams, cfg, model, params = pair
    jc, tc = _paged_caches(jcfg, (3, 9))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, C),
                                             dtype=np.int32)
    jl, jc = jm.extend_fn(jparams, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = model.extend_fn(params, {"tokens": torch.tensor(toks)}, tc)
    _close(tl, jl, TOL)
    _close_pools(tc, jc)


def test_paged_decode_fn_matches_reference(pair):
    """Decode over a table narrowed to 2 of 4 pages, as the engine runs it
    (row 1 past its table's width: its output and write are junk on both
    sides, so only row 0's logits are compared)."""
    jcfg, jm, jparams, cfg, model, params = pair
    jc, tc = _paged_caches(jcfg, (13, 30))
    tok = np.asarray([7, 99], np.int32)
    for c in (jc, tc):
        c["table"] = c["table"][:, :2]
    jl, jc = jm.decode_fn(jparams, {"token": jnp.asarray(tok)}, jc)
    tl, tc = model.decode_fn(params, {"token": torch.tensor(tok)}, tc)
    _close(tl[0], jl[0], TOL)
    assert bool(torch.isfinite(tl).all())
    for n in ("k", "v"):                   # row 0's write at position 13
        page = int(np.asarray(jc["table"])[0, 1])
        _close(tc["kv"][n][:, page, 5], jc["kv"][n][:, page, 5], TOL)


def test_paged_and_dense_model_streams_agree(pair):
    """The port's paged cache against its own dense cache: prefill into
    both, then extend and greedy decode steps; logits within 1e-4 and the
    same tokens (not bitwise: the sums run in another order)."""
    _, _, _, cfg, model, params = pair
    toks = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8), dtype=np.int32))
    _, pre = model.prefill_fn(params, {"tokens": toks})
    dense = T.make_decode_cache(cfg, 2, 32, "cpu")
    paged = T.make_paged_decode_cache(cfg, 2, 32, "cpu", page_size=8,
                                      num_pages=8)
    paged["table"] = torch.tensor([[6, 1, 3, 8], [0, 7, 2, 5]],
                                  dtype=torch.int32)
    for n in ("k", "v"):
        dense["kv"][n][:, :, :8] = pre["kv"][n]
    engine_mod.insert_cache_pages(paged["kv"], pre["kv"],
                                  paged["table"][:, :1].long())
    dense["pos"] = pre["pos"].clone()
    paged["pos"] = pre["pos"].clone()
    chunk = {"tokens": toks[:, :3]}
    ld, dense = model.extend_fn(params, chunk, dense)
    lp, paged = model.extend_fn(params, chunk, paged)
    torch.testing.assert_close(lp, ld, **TOL)
    for _ in range(4):
        tok = ld.argmax(-1).to(torch.int32)
        assert torch.equal(tok, lp.argmax(-1).to(torch.int32))
        ld, dense = model.decode_fn(params, {"token": tok}, dense)
        lp, paged = model.decode_fn(params, {"token": tok}, paged)
        torch.testing.assert_close(lp, ld, **TOL)


# ----------------------------------------------------------------- engine
LENGTHS = (8, 13, 5, 11, 7, 9)


def _prompts(vocab, seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    m = engine.run()
    return {r.rid: list(r.tokens) for r in m.completed}, m.summary()


def _engine(model, params, mode="batched", **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 64)
    return ServingEngine(model, params, admit_mode=mode, **kw)


@pytest.fixture(scope="module")
def served(pair):
    """The reference's paged engine over the six prompts, greedy."""
    jcfg, jm, jparams, cfg, _, _ = pair
    prompts = _prompts(cfg.vocab_size)
    jeng = JEngine(jm, jparams, max_batch=4, max_seq=64, paged=True)
    jstreams, jsum = _run(jeng, [JRequest(rid=i, prompt=p, max_new_tokens=5)
                                 for i, p in enumerate(prompts)])
    return prompts, jstreams, jsum


@pytest.mark.parametrize("mode", ["batched", "serial"])
def test_paged_engine_streams_match_reference_and_dense(pair, served, mode):
    _, _, _, cfg, model, params = pair
    prompts, jstreams, jsum = served
    reqs = lambda: [Request(rid=i, prompt=p, max_new_tokens=5)
                    for i, p in enumerate(prompts)]
    eng = _engine(model, params, mode, paged=True)
    streams, s = _run(eng, reqs())
    dense, _ = _run(_engine(model, params, mode), reqs())
    assert streams == jstreams == dense
    if mode == "batched":
        assert s["prefill_calls"] == jsum["prefill_calls"]
        assert s["steps"] == jsum["steps"]
    assert sorted(eng._free_pages) == list(range(eng.num_pages))


def test_page_recycling_across_waves(pair):
    """Nine requests of two pages each through an 8-page pool: three
    waves, the pool really is the limit, and every page comes back."""
    _, _, _, cfg, model, params = pair
    eng = _engine(model, params, paged=True, num_pages=8)
    rng = np.random.default_rng(2)
    for i in range(9):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=12).astype(np.int32), max_new_tokens=6))
    saw_exhausted = False
    while True:
        n = eng.step()
        saw_exhausted |= (not eng._free_pages and bool(eng.waiting))
        if n == 0 and not eng.waiting:
            break
    assert saw_exhausted
    assert eng.metrics.summary()["num_completed"] == 9
    assert sorted(eng._free_pages) == list(range(eng.num_pages))
    assert all(not p for p in eng.slot_pages)
    assert (eng._tbl == eng.num_pages).all()


def test_reject_when_pages_can_never_fit_and_wait_when_exhausted(pair):
    _, _, _, cfg, model, params = pair
    eng = _engine(model, params, paged=True, num_pages=2)   # 32 tokens
    rng = np.random.default_rng(7)
    mk = lambda rid, n: Request(rid=rid, prompt=rng.integers(
        0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=4)
    for r in (mk(0, 30), mk(1, 14), mk(2, 14)):  # 3 pages; 2; 2 (waits)
        eng.submit(r)
    eng.step()
    assert [r.rid for r in eng.metrics.rejected] == [0]
    assert [r.rid for r in eng.waiting] == [2]
    m = eng.run()
    assert sorted(r.rid for r in m.completed) == [1, 2]
    assert len(eng._free_pages) == 2


def test_fragmented_free_list_still_serves(pair):
    """Releases in another order than allocations scramble the free list;
    later admissions get scattered pages and still match a dense engine."""
    _, _, _, cfg, model, params = pair
    eng = _engine(model, params, paged=True, num_pages=12)
    rng = np.random.default_rng(6)
    mk = lambda rid, n, new: Request(rid=rid, prompt=rng.integers(
        0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=new)
    _run(eng, [mk(i, n, new) for i, (n, new) in
               enumerate([(9, 6), (17, 2), (5, 5), (21, 2)])])
    assert sorted(eng._free_pages) == list(range(12))
    assert eng._free_pages != list(range(11, -1, -1))
    second = [mk(10 + i, n, 3) for i, n in enumerate([21, 9, 17])]
    got, _ = _run(eng, second)
    got = {rid: toks for rid, toks in got.items() if rid >= 10}
    for r in second:
        r.tokens, r.prefill_done_s, r.finish_s = [], None, None
    want, _ = _run(_engine(model, params), second)
    assert got == want


def test_no_page_leak_on_admission_error(pair, monkeypatch):
    """An exception at the page-pool insert rolls the round back: every
    reserved page is free again, the tables are all sentinel, and the
    requests are back in the queue in order and then served."""
    _, _, _, cfg, model, params = pair
    eng = _engine(model, params, paged=True)
    rng = np.random.default_rng(8)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=8).astype(np.int32), max_new_tokens=3))

    def boom(*a, **k):
        raise RuntimeError("injected page insert failure")

    monkeypatch.setattr(engine_mod, "insert_cache_pages", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    assert sorted(eng._free_pages) == list(range(eng.num_pages))
    assert (eng._tbl == eng.num_pages).all()
    assert all(r is None for r in eng.active)
    assert [r.rid for r in eng.waiting] == [0, 1]
    monkeypatch.undo()
    assert eng.run().summary()["num_completed"] == 2
    assert len(eng._free_pages) == eng.num_pages
