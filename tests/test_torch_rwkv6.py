"""Port RWKV6 family (rwkv6-1.6b) against the reference package, on the CPU.

Kernel 7's plain versions (``ref.wkv6_ref``, token-serial, and
``ref.wkv6_chunked_ref``, the chunked form ``ops.wkv6`` runs on the CPU)
against the reference's ``wkv6_ref`` and the Pallas ``wkv6`` in interpret
mode; the model's prefill, extend and decode logits and states, and the
serving engine's greedy streams, against the reference's, at fp32 on
``reduced(rwkv6-1.6b, dtype="float32")`` with the reference's weights
carried across by ``params_from_numpy``.

Tolerances: the recurrence 1e-5 (the same fp32 terms; the chunked forms
sum in another order than the serial one, and the port chunks any S by 32
where the reference picks 32, 8 or 1 by divisibility); logits and states
1e-4, as for the other families.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rwkv6_1b6 as jax_rwkv
from repro.configs.base import reduced as jax_reduced
from repro.kernels import ref as jax_ref
from repro.kernels.wkv6 import wkv6 as wkv6_pallas
from repro.models.api import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import reduced, rwkv6_1b6
from repro_torch.kernels import ops, ref
from repro_torch.models.api import build
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serving.engine import Request, ServingEngine

TOL = dict(atol=1e-4, rtol=1e-4)
TOL_KERNEL = dict(atol=1e-5, rtol=1e-5)
LENGTHS = (8, 13, 5, 11)
TEMPS = (0.0, 0.7, 0.0, 1.3)
STATE = ("wkv", "tm", "cm")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _wkv_inputs(B, S, H, hd, seed=0, logw=None):
    """r/k/v/logw [B,S,H,hd], u [H,hd], state0 [B,H,hd,hd] (numpy fp32);
    benign decays in [-1.5, 0) unless ``logw`` fixes one value."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd), np.float32) * 0.5
               for _ in range(3))
    if logw is None:
        w = -rng.uniform(0.01, 1.5, (B, S, H, hd)).astype(np.float32)
    else:
        w = np.full((B, S, H, hd), logw, np.float32)
    u = rng.standard_normal((H, hd), np.float32) * 0.3
    s0 = rng.standard_normal((B, H, hd, hd), np.float32) * 0.1
    return r, k, v, w, u, s0


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_rwkv, dtype="float32")
    cfg = reduced(rwkv6_1b6, dtype="float32")
    jm = jax_build(jcfg)
    jparams = jm.init_params(jax.random.key(0))
    params = params_from_numpy(_np(jparams), cfg, "cpu")
    jfns = {n: jax.jit(getattr(jm, n))
            for n in ("prefill_fn", "extend_fn", "decode_fn")}
    return cfg, build(cfg), params, jm, jparams, jfns


@pytest.mark.parametrize("S", [64, 40], ids=["S64", "ragged-S40"])
def test_wkv6_plain_versions_match_reference(S):
    """Port serial and chunked forms against the reference's serial form
    and, at an S the Pallas kernel tiles, the Pallas kernel (chunk 16,
    interpret mode)."""
    a = _wkv_inputs(2, S, 2, 16)
    want_o, want_s = jax_ref.wkv6_ref(*map(jnp.asarray, a))
    t = [torch.tensor(x) for x in a]
    for fn in (ref.wkv6_ref, ref.wkv6_chunked_ref, ops.wkv6):
        o, s = fn(*t)
        _close(o, want_o, TOL_KERNEL)
        _close(s, want_s, TOL_KERNEL)
    if S % 16 == 0:
        po, ps = wkv6_pallas(*map(jnp.asarray, a), chunk=16, interpret=True)
        o, s = ref.wkv6_chunked_ref(*t)
        _close(o, po, TOL_KERNEL)
        _close(s, ps, TOL_KERNEL)


def test_wkv6_state_chains_across_calls():
    """Two calls, the second from the first's state, equal one call."""
    r, k, v, w, u, s0 = (torch.tensor(x) for x in _wkv_inputs(1, 50, 2, 16,
                                                              seed=1))
    full_o, full_s = ref.wkv6_chunked_ref(r, k, v, w, u, s0)
    o1, s1 = ref.wkv6_chunked_ref(r[:, :19], k[:, :19], v[:, :19],
                                  w[:, :19], u, s0)
    o2, s2 = ref.wkv6_chunked_ref(r[:, 19:], k[:, 19:], v[:, 19:],
                                  w[:, 19:], u, s1)
    torch.testing.assert_close(torch.cat([o1, o2], 1), full_o, **TOL_KERNEL)
    torch.testing.assert_close(s2, full_s, **TOL_KERNEL)


def test_wkv6_at_the_decay_clamp_is_finite():
    """logw = -1.5 (the model's clamp) over 64 tokens: the port's 32-token
    chunks stay finite and match the serial form. (The Pallas kernel at
    its default chunk of 64 overflows here: exp(96) in fp32.)"""
    a = _wkv_inputs(1, 64, 2, 16, seed=2, logw=-1.5)
    want_o, want_s = jax_ref.wkv6_ref(*map(jnp.asarray, a))
    o, s = ops.wkv6(*(torch.tensor(x) for x in a))
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    _close(o, want_o, TOL_KERNEL)
    _close(s, want_s, TOL_KERNEL)


def test_prefill_matches_reference(pair):
    cfg, model, params, _, jparams, jfns = pair
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40),
                                             dtype=np.int32)
    jl, jc = jfns["prefill_fn"](jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = model.prefill_fn(params, {"tokens": torch.tensor(toks)})
    _close(tl, jl)
    for name in STATE:
        _close(tc["state"][name], jc["state"][name])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("chunk", [16, 7])
def test_plain_path_chunk_changes_only_sum_order(pair, chunk):
    """``build(reference=True, wkv_chunk=...)``: the plain path at another
    chunk (16 splits the 40-token prompt evenly, 7 leaves a ragged tail)
    still gives the reference's prefill."""
    cfg, _, params, _, jparams, jfns = pair
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40),
                                             dtype=np.int32)
    jl, jc = jfns["prefill_fn"](jparams, {"tokens": jnp.asarray(toks)})
    plain = build(cfg, reference=True, wkv_chunk=chunk)
    tl, tc = plain.prefill_fn(params, {"tokens": torch.tensor(toks)})
    _close(tl, jl)
    _close(tc["state"]["wkv"], jc["state"]["wkv"])


def _state_cache(cfg, seed=4):
    """A populated state cache for 2 rows, both sides."""
    rng = np.random.default_rng(seed)
    L, H, hd, d = (cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim,
                   cfg.d_model)
    tree = {"state": {
        "wkv": rng.standard_normal((L, 2, H, hd, hd), np.float32) * 0.1,
        "tm": rng.standard_normal((L, 2, d), np.float32),
        "cm": rng.standard_normal((L, 2, d), np.float32)},
        "pos": np.asarray([5, 9], np.int32)}
    return jax.tree.map(jnp.asarray, tree), cache_from_numpy(tree, "cpu")


@pytest.mark.parametrize("step", ["extend", "decode"])
def test_extend_and_decode_match_reference(pair, step):
    cfg, model, params, _, jparams, jfns = pair
    jc, tc = _state_cache(cfg)
    rng = np.random.default_rng(5)
    if step == "extend":
        toks = rng.integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
        jl, jc = jfns["extend_fn"](jparams, {"tokens": jnp.asarray(toks)}, jc)
        tl, tc = model.extend_fn(params, {"tokens": torch.tensor(toks)}, tc)
    else:
        tok = np.asarray([3, 200], np.int32)
        jl, jc = jfns["decode_fn"](jparams, {"token": jnp.asarray(tok)}, jc)
        tl, tc = model.decode_fn(params, {"token": torch.tensor(tok)}, tc)
    _close(tl, jl)
    for name in STATE:
        _close(tc["state"][name], jc["state"][name])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_masked_extend_leaves_other_rows_state(pair):
    """Rows outside ``rows`` keep wkv, tm, cm and pos bit for bit; the
    selected row moves exactly as in an unmasked extend."""
    cfg, model, params, _, _, _ = pair
    _, full = _state_cache(cfg)
    _, masked = _state_cache(cfg)
    before = {n: masked["state"][n].clone() for n in STATE}
    toks = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 7), dtype=np.int32))
    lf, full = model.extend_fn(params, {"tokens": toks}, full)
    lm, masked = model.extend_fn(params, {"tokens": toks}, masked,
                                 rows=torch.tensor([False, True]))
    assert masked["pos"].tolist() == [5, 16]
    torch.testing.assert_close(lm[1], lf[1], rtol=0, atol=0)
    for n in STATE:
        assert torch.equal(masked["state"][n][:, 0], before[n][:, 0])
        assert torch.equal(masked["state"][n][:, 1], full["state"][n][:, 1])


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENGTHS]


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    m = engine.run()
    return {r.rid: list(r.tokens) for r in m.completed}, m.summary()


def test_engine_greedy_streams_match_reference(pair):
    cfg, model, params, jm, jparams, _ = pair
    prompts = _prompts(cfg.vocab_size)
    jstreams, jsum = _serve(JEngine(jm, jparams, max_batch=4, max_seq=64),
                            [JRequest(rid=i, prompt=p, max_new_tokens=5)
                             for i, p in enumerate(prompts)])
    streams, s = _serve(ServingEngine(model, params, max_batch=4, max_seq=64),
                        [Request(rid=i, prompt=p, max_new_tokens=5)
                         for i, p in enumerate(prompts)])
    assert s["num_completed"] == len(LENGTHS)
    assert streams == jstreams
    assert s["prefill_calls"] == jsum["prefill_calls"]


def test_engine_batched_matches_serial(pair):
    """Free slots decode every step and their state drifts; admission
    overwrites a slot's state whole, so the streams, sampled rows
    included, do not depend on the admission path. Two slots for four
    requests: slots are reused."""
    cfg, model, params, _, _, _ = pair
    prompts = _prompts(cfg.vocab_size)
    out = {}
    for mode in ("serial", "batched"):
        out[mode], _ = _serve(
            ServingEngine(model, params, max_batch=2, max_seq=64,
                          admit_mode=mode),
            [Request(rid=i, prompt=p, max_new_tokens=6, temperature=t)
             for i, (p, t) in enumerate(zip(prompts, TEMPS))])
    assert out["batched"] == out["serial"]
    assert len(out["batched"]) == len(LENGTHS)
