"""Port MoE family (phi3.5-moe) against the reference package, on the CPU.

Kernel 6's plain version against the Pallas kernel in interpret mode; the
port's bucketed ``moe_block`` against the reference's compute-every-expert
``moe_dense_ref``; the model's prefill, extend and decode, and the serving
engine's greedy streams, against the reference's, all at fp32 on
``reduced(phi3.5-moe, dtype="float32")`` (4 experts, top-2, expert FFN 64)
with the reference's weights carried across by ``params_from_numpy``.

Tolerances: the GEMM and the MoE block 1e-5 (the same fp32 products summed
in another order); logits and caches 1e-4, as for the dense family. The
seeded inputs give gates without ties, where ``torch.topk`` and
``lax.top_k`` pick the same experts.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import phi35_moe_42b as jax_phi
from repro.configs.base import reduced as jax_reduced
from repro.kernels import ops as jax_ops
from repro.models import moe as jax_moe
from repro.models.api import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import phi35_moe_42b, reduced
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models.api import build
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serving.engine import Request, ServingEngine

TOL = dict(atol=1e-4, rtol=1e-4)
TOL_KERNEL = dict(atol=1e-5, rtol=1e-5)
MAX_SEQ = 32
LENGTHS = (8, 13, 5, 11)
TEMPS = (0.0, 0.7, 0.0, 1.3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_phi, dtype="float32")
    cfg = reduced(phi35_moe_42b, dtype="float32")
    jm = jax_build(jcfg)
    jparams = jm.init_params(jax.random.key(0))
    params = params_from_numpy(_np(jparams), cfg, "cpu")
    jfns = {n: jax.jit(getattr(jm, n))
            for n in ("prefill_fn", "extend_fn", "decode_fn")}
    return cfg, build(cfg), params, jm, jparams, jfns


@pytest.fixture(scope="module")
def reference_streams(pair):
    """The reference engine's greedy streams and schedule, built once."""
    cfg, _, _, jm, jparams, _ = pair
    eng = JEngine(jm, jparams, max_batch=4, max_seq=64)
    for r in _reqs(_prompts(cfg.vocab_size), JRequest):
        eng.submit(r)
    m = eng.run()
    return {r.rid: list(r.tokens) for r in m.completed}, m.summary()


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENGTHS]


def _reqs(prompts, cls=Request, temps=(0.0,) * len(LENGTHS)):
    return [cls(rid=i, prompt=p, max_new_tokens=5, temperature=t)
            for i, (p, t) in enumerate(zip(prompts, temps))]


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    m = engine.run()
    return {r.rid: list(r.tokens) for r in m.completed}, m.summary()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("fill", [[0, 13, 32, 7], None],
                         ids=["empty-partial-full", "default-full"])
def test_expert_matmul_ref_matches_pallas(fill):
    """E 4, C 32, D 128, F 128: a shape the Pallas kernel tiles; fill 0
    (the tile skipped), partial and C."""
    rng = np.random.default_rng(0)
    xe = rng.standard_normal((4, 32, 128), np.float32)
    w = rng.standard_normal((4, 128, 128), np.float32) / np.sqrt(128)
    jfill = None if fill is None else jnp.asarray(fill, jnp.int32)
    want = jax_ops.expert_matmul(jnp.asarray(xe), jnp.asarray(w), jfill,
                                 use_pallas=True, interpret=True)
    tfill = None if fill is None else torch.tensor(fill, dtype=torch.int32)
    got = ops.expert_matmul(torch.tensor(xe), torch.tensor(w), tfill)
    _close(got, want, TOL_KERNEL)
    if fill is not None:
        assert not got[0].any() and not got[1, 13:].any()


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_block_matches_dense_ref(shared):
    """Bucketed routing + three expert GEMMs == every expert for every
    token, with and without a shared expert; the aux loss too."""
    jcfg = jax_reduced(jax_phi, dtype="float32", num_shared_experts=shared)
    cfg = reduced(phi35_moe_42b, dtype="float32", num_shared_experts=shared)
    jp = jax_moe.moe_params(jax.random.key(1), jcfg)
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)
    x = np.random.default_rng(1).standard_normal((3, 7, cfg.d_model),
                                                 np.float32)
    want, want_aux = jax_moe.moe_dense_ref(jcfg, jp, jnp.asarray(x))
    got, aux = moe.moe_block(cfg, p, torch.tensor(x))
    assert ("shared" in p) == bool(shared)
    _close(got, want, TOL_KERNEL)
    _close(aux, want_aux, TOL_KERNEL)


def test_bucketing_fills_and_order():
    """Pairs land in their expert's bucket in token order; fill counts
    them; the rows past fill stay empty."""
    e_flat = torch.tensor([2, 0, 2, 1, 0, 2])
    slot, fill = moe._bucket(e_flat, 4)
    assert slot.tolist() == [0, 0, 1, 0, 1, 2]
    assert fill.tolist() == [2, 1, 3, 0]
    assert fill.dtype == torch.int32


def test_prefill_matches_reference(pair):
    cfg, model, params, _, jparams, jfns = pair
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    jl, jc = jfns["prefill_fn"](jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = model.prefill_fn(params, {"tokens": torch.tensor(toks)})
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["kv"][name], jc["kv"][name])


@pytest.mark.parametrize("step", ["extend", "decode"])
def test_extend_and_decode_match_reference(pair, step):
    """From a ragged populated cache: a 4-token chunk, or one token."""
    cfg, model, params, _, jparams, jfns = pair
    rng = np.random.default_rng(3)
    shape = (cfg.num_layers, 2, MAX_SEQ, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    tree = {"kv": {n: rng.standard_normal(shape, np.float32)
                   for n in ("k", "v")},
            "pos": np.asarray([5, 9], np.int32)}
    jc = jax.tree.map(jnp.asarray, tree)
    tc = cache_from_numpy(tree, "cpu")
    if step == "extend":
        toks = rng.integers(0, cfg.vocab_size, (2, 4), dtype=np.int32)
        jl, jc = jfns["extend_fn"](jparams, {"tokens": jnp.asarray(toks)}, jc)
        tl, tc = model.extend_fn(params, {"tokens": torch.tensor(toks)}, tc)
    else:
        tok = np.asarray([3, 200], np.int32)
        jl, jc = jfns["decode_fn"](jparams, {"token": jnp.asarray(tok)}, jc)
        tl, tc = model.decode_fn(params, {"token": torch.tensor(tok)}, tc)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["kv"][name], jc["kv"][name])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_engine_greedy_streams_match_reference(pair, reference_streams):
    cfg, model, params, _, _, _ = pair
    jstreams, jsum = reference_streams
    streams, s = _serve(ServingEngine(model, params, max_batch=4,
                                      max_seq=64),
                        _reqs(_prompts(cfg.vocab_size)))
    assert s["num_completed"] == len(LENGTHS)
    assert streams == jstreams
    assert s["prefill_calls"] == jsum["prefill_calls"]


@pytest.mark.parametrize("kw", [dict(admit_mode="serial"),
                                dict(paged=True, num_pages=3)],
                         ids=["serial", "paged"])
def test_engine_batched_matches_serial_and_paged(pair, kw):
    """The port's own anchors: batched == serial with sampled rows, and
    paged == dense (a pool of 3 pages of 16 tokens for requests that need
    5, so admission waits for pages)."""
    cfg, model, params, _, _, _ = pair
    prompts = _prompts(cfg.vocab_size)
    base, _ = _serve(ServingEngine(model, params, max_batch=4, max_seq=64),
                     _reqs(prompts, temps=TEMPS))
    other, s = _serve(ServingEngine(model, params, max_batch=4, max_seq=64,
                                    **kw), _reqs(prompts, temps=TEMPS))
    assert other == base
    assert s["num_completed"] == len(LENGTHS)
    assert (s["page_waits"] > 0) == bool(kw.get("paged"))


def test_init_params_layout():
    """``init_params`` draws the reference's MoE layout: [E, D, F] expert
    stacks, an fp32 [D, E] router, normal / sqrt(fan_in)."""
    cfg = dataclasses.replace(reduced(phi35_moe_42b), d_model=128,
                              moe_d_ff=256)
    p = build(cfg).init_params(torch.Generator().manual_seed(0))
    m = p["layers"][0]["moe"]
    assert "mlp" not in p["layers"][0]
    assert m["router"].dtype == torch.float32
    assert m["router"].shape == (128, cfg.num_experts)
    assert m["w_gate"].shape == (cfg.num_experts, 128, 256)
    assert m["w_down"].shape == (cfg.num_experts, 256, 128)
    assert m["w_gate"].dtype == torch.bfloat16
    assert abs(m["w_down"].float().std().item() * 16 - 1) < 0.05
