"""The qk-norm dense, encoder-decoder and vlm families against the reference.

qwen3-14b (dense, qk-norm; G = 2 here, at ``num_kv_heads=2``),
seamless-m4t-medium (encdec: a bidirectional encoder over the frontend
stub's frames, cross-attention in every decoder layer; G = 1) and
paligemma-3b (vlm: the frontend stub's patches as a bidirectional prefix
before the text, embeddings scaled by sqrt(d_model); G = 4 over its one KV
head), each at its ``reduced`` smoke config of 2 layers in fp32, with the
reference's weights
carried across by ``models.convert``. The reference side of each arch is
built once per module. Logits and caches (``kv`` and ``enc_kv``) agree to
1e-4 for prefill, extend and decode; the port engine's greedy streams
equal the reference engine's on the same requests, whatever the admission
path and cache layout; int8 caches give the logits of the reference's
int8 path within ``tests/test_torch_int8.py``'s bound. The plain dense
configs registered beside them (llama3-8b, deepseek-7b) are held field by
field. The vlm patches take cache positions: admission, pages and slot
lengths count them as the reference engine does.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import transformer as JT
from repro.models.api import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config, reduced, smoke_config
from repro_torch.models.api import build
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serving.engine import Request, ServingEngine

TOL = dict(atol=1e-4, rtol=1e-4)
MAX_SEQ = 32
# qwen3-14b at two KV heads, so that its grouped heads are exercised;
# paligemma-3b keeps its single KV head
OVERRIDES = {"qwen3-14b": dict(num_kv_heads=2), "seamless-m4t-medium": {},
             "paligemma-3b": {}}
LENGTHS = (8, 13, 5, 11, 7, 9)
N_NEW = 4


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _inputs(cfg, toks, seed=0):
    """Prefill inputs as numpy: an encdec model also takes frames, a vlm
    model patches (random, so that the frontend projection and the
    prefix mask carry values)."""
    inp = {"tokens": toks}
    stub = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
    if stub:
        inp[stub] = np.random.default_rng(seed).standard_normal(
            (toks.shape[0], cfg.num_prefix_embeddings, cfg.d_model)
        ).astype(np.float32)
    return inp


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                max_new_tokens=N_NEW) for i, n in enumerate(LENGTHS)]


def _streams(eng, reqs):
    for r in reqs:
        eng.submit(r)
    m = eng.run()
    return {r.rid: list(r.tokens) for r in m.completed}, m.summary()


@pytest.fixture(scope="module")
def families():
    """Each arch's bundle, built at first use and kept for the module."""
    return {}


@pytest.fixture(scope="module", params=sorted(OVERRIDES))
def fam(request, families):
    """One arch, both packages: weights, jitted model functions and the
    reference engine's greedy streams."""
    return _family(families, request.param)


def _family(families, arch):
    if arch not in families:
        families[arch] = _build_family(arch)
    return families[arch]


def _build_family(arch):
    jcfg = jax_reduced(jax_get_config(arch), dtype="float32",
                       **OVERRIDES[arch])
    cfg = reduced(get_config(arch), dtype="float32", **OVERRIDES[arch])
    jm = jax_build(jcfg)
    jparams = jm.init_params(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jeng = JEngine(jm, jparams, max_batch=4, max_seq=MAX_SEQ)
    jstreams, jsum = _streams(jeng, _requests(JRequest, cfg.vocab_size))
    return SimpleNamespace(
        arch=arch, jcfg=jcfg, cfg=cfg, jm=jm, jparams=jparams, params=params,
        model=build(cfg), jstreams=jstreams, jsum=jsum,
        jfns={n: jax.jit(getattr(jm, n))
              for n in ("prefill_fn", "extend_fn", "decode_fn")})


def _cache(f, pos, seed=1, paged=False):
    """A populated fp32 reference decode cache at per-row lengths ``pos``
    (random K/V, and random encoder K/V for encdec), and the port's copy."""
    rng = np.random.default_rng(seed)
    B = len(pos)
    if paged:
        jc = JT.make_paged_decode_cache(f.jcfg, B, MAX_SEQ, page_size=8)
        P = jc["kv"]["k"].shape[1]
        jc["table"] = jnp.asarray(rng.permutation(P).reshape(B, -1)
                                  .astype(np.int32))
    else:
        jc = JT.make_decode_cache(f.jcfg, B, MAX_SEQ)
    rnd = lambda a: jnp.asarray(rng.standard_normal(a.shape)
                                .astype(np.float32))
    jc["kv"] = {n: rnd(a) for n, a in jc["kv"].items()}
    if "enc_kv" in jc:
        jc["enc_kv"] = tuple(rnd(a) for a in jc["enc_kv"])
    jc["pos"] = jnp.asarray(np.asarray(pos, np.int32))
    return jc, cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")


def _close_cache(tc, jc, paged=False):
    cut = (lambda a: a[:, :-1]) if paged else (lambda a: a)
    for n in ("k", "v"):
        _close(cut(tc["kv"][n]), jc["kv"][n])
    if "enc_kv" in jc:
        for i, n in enumerate(("k", "v")):
            _close(tc["enc_kv"][n], jc["enc_kv"][i])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_prefill_matches_reference(fam):
    f = fam
    toks = np.random.default_rng(2).integers(0, f.cfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    inp = _inputs(f.cfg, toks)
    jl, jc = f.jfns["prefill_fn"](f.jparams, jax.tree.map(jnp.asarray, inp))
    tl, tc = f.model.prefill_fn(f.params,
                                {k: torch.tensor(v) for k, v in inp.items()})
    _close(tl, jl)
    _close_cache(tc, jc)
    assert ("enc_kv" in tc) == (f.cfg.family == "encdec")
    P = f.cfg.num_prefix_embeddings if f.cfg.family == "vlm" else 0
    assert tc["kv"]["k"].shape[2] == P + 12


@pytest.mark.parametrize("C", [1, 4])
def test_extend_matches_reference(fam, C):
    f = fam
    jc, tc = _cache(f, (5, 9))
    toks = np.random.default_rng(3).integers(0, f.cfg.vocab_size, (2, C),
                                             dtype=np.int32)
    jl, jc = f.jfns["extend_fn"](f.jparams, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = f.model.extend_fn(f.params, {"tokens": torch.tensor(toks)}, tc)
    _close(tl, jl)
    _close_cache(tc, jc)


def test_decode_matches_reference(fam):
    f = fam
    jc, tc = _cache(f, (1, 17, MAX_SEQ - 1))
    tok = np.asarray([3, 200, 41], np.int32)
    jl, jc = f.jfns["decode_fn"](f.jparams, {"token": jnp.asarray(tok)}, jc)
    tl, tc = f.model.decode_fn(f.params, {"token": torch.tensor(tok)}, tc)
    _close(tl, jl)
    _close_cache(tc, jc)


def test_engine_greedy_streams_match_reference(fam):
    """Batched admission: the reference engine's streams and schedule;
    serial and async admission: the same streams."""
    f = fam
    for mode in ("batched", "serial", "async"):
        eng = ServingEngine(f.model, f.params, max_batch=4, max_seq=MAX_SEQ,
                            admit_mode=mode,
                            admit_token_budget=8 if mode == "async" else None)
        streams, s = _streams(eng, _requests(Request, f.cfg.vocab_size))
        assert streams == f.jstreams, mode
        assert eng.reconcile()["balanced"]
        if mode == "batched":
            assert (s["prefill_calls"], s["steps"]) == (
                f.jsum["prefill_calls"], f.jsum["steps"])


def test_paged_streams_equal_dense(fam):
    """Paged engines (the encoder's K/V dense per slot beside the pages),
    batched and async, give the dense streams and every page back."""
    f = fam
    for mode in ("batched", "async"):
        eng = ServingEngine(f.model, f.params, max_batch=4, max_seq=MAX_SEQ,
                            admit_mode=mode, admit_token_budget=8,
                            paged=True, page_size=8)
        assert eng.paged
        streams, _ = _streams(eng, _requests(Request, f.cfg.vocab_size))
        assert streams == f.jstreams, mode
        assert len(eng._free_pages) == eng.num_pages


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_logits_match_reference(fam, paged):
    """A populated cache quantized on both sides (``enc_kv`` stays fp),
    then one extend chunk and two greedy decode steps."""
    f = fam
    jc, _ = _cache(f, (3, 11), paged=paged)
    jc = JT.quantize_decode_cache(jc)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert tc["kv"]["k"].dtype == torch.int8
    if "enc_kv" in tc:
        assert tc["enc_kv"]["k"].dtype == torch.float32
    toks = np.random.default_rng(4).integers(0, f.cfg.vocab_size, (2, 4),
                                             dtype=np.int32)
    jl, jc = f.jm.extend_fn(f.jparams, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = f.model.extend_fn(f.params, {"tokens": torch.tensor(toks)}, tc)
    _close(tl, jl)
    for _ in range(2):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        assert tok.tolist() == tl.argmax(-1).tolist()
        jl, jc = f.jm.decode_fn(f.jparams, {"token": jnp.asarray(tok)}, jc)
        tl, tc = f.model.decode_fn(f.params, {"token": torch.tensor(tok)}, tc)
        _close(tl, jl)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-7b", "qwen3-14b",
                                  "seamless-m4t-medium", "paligemma-3b"])
def test_new_configs_equal_reference(arch):
    want = jax_get_config(arch)
    got = get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(
        jax_reduced(want))
    build(got)            # every registered arch builds


def _edge_requests(cls, vocab, prefix):
    """Three 13-token prompts: the first's contract (patches + prompt +
    max_new_tokens - 1) ends exactly at MAX_SEQ, the second's one position
    past it, the third's well inside."""
    rng = np.random.default_rng(5)
    fit = MAX_SEQ - prefix - 13 + 1
    return [cls(rid=i, prompt=rng.integers(0, vocab, 13).astype(np.int32),
                max_new_tokens=n) for i, n in enumerate((fit, fit + 1, 3))]


@pytest.mark.parametrize("mode,paged", [("batched", False),
                                        ("serial", True), ("async", True)])
def test_vlm_prefix_counts_against_max_seq(families, mode, paged):
    """paligemma-3b's patches take cache positions: at the max_seq edge the
    port's engine admits and rejects in its first step what the reference
    engine does, needs the same pages (the patches' included) and reaches
    the same slot lengths; then it serves every admitted request and gives
    every page back. (Its streams equal the reference engine's in every
    admission mode: ``test_engine_greedy_streams_match_reference``.)"""
    f = _family(families, "paligemma-3b")
    P = f.cfg.num_prefix_embeddings
    kw = dict(max_batch=4, max_seq=MAX_SEQ, admit_mode=mode,
              admit_token_budget=8 if mode == "async" else None)
    if paged:
        kw.update(paged=True, page_size=8)
    jeng = JEngine(f.jm, f.jparams, **kw)
    eng = ServingEngine(f.model, f.params, **kw)
    jreqs = _edge_requests(JRequest, f.cfg.vocab_size, P)
    reqs = _edge_requests(Request, f.cfg.vocab_size, P)
    assert [P + len(r.prompt) + r.max_new_tokens - 1 for r in reqs] == [
        MAX_SEQ, MAX_SEQ + 1, P + 15]
    if paged:
        for jr, r in zip(jreqs, reqs):
            want = -(-(P + len(r.prompt) + r.max_new_tokens - 1) // 8)
            assert eng._pages_needed(r) == jeng._pages_needed(jr, P) == want
    for e, rs in ((jeng, jreqs), (eng, reqs)):
        for r in rs:
            e.submit(r)
        e.step()
    assert ([r.rid for r in eng.metrics.rejected]
            == [r.rid for r in jeng.metrics.rejected] == [1])
    if paged:
        np.testing.assert_array_equal(eng._slot_len, jeng._slot_len)
        assert eng._slot_len[0] >= P + 8      # the patches and a bucket
    m = eng.run()
    assert sorted(r.rid for r in m.completed) == [0, 2]
    assert [len(r.tokens) for r in sorted(m.completed, key=lambda r: r.rid)
            ] == [reqs[0].max_new_tokens, 3]
    if paged:
        assert len(eng._free_pages) == eng.num_pages
