"""The hybrid family (zamba2-7b) against the reference package, on the CPU.

``reduced(zamba2-7b, dtype="float32")``: 4 Mamba2 layers in 2 groups of
(the shared attention + MLP block with the group's LoRA delta, 2 Mamba2
layers), d 64, 4 heads of hd 16, SSM state 16 over 8 SSM heads of 16; and
the same at ``num_layers=5``, whose fifth layer is a tail layer. The
reference's weights are carried across by ``models.convert``, with
``lora_b`` (zero in the reference's init), ``A_log``, ``dt_bias`` and
``conv_b`` perturbed to seeded nonzero values on both sides, so that the
LoRA delta and the decay clamp are exercised.

Within 1e-4: one Mamba2 block, the chunked SSD against the token-serial
one, and the model's prefill, extend and decode logits, SSM and conv
states and ``attn`` caches. The port's chunked SSD masks the intra-chunk
decay before its exponent, so it stays finite at chunks of 64 and 128 at
the decay clamp, where the reference's does not. The port's engine gives
the reference engine's greedy streams and counters in batched, serial and
async admission, continues bit for bit after a preemption, and leaves
rows outside ``rows`` untouched. The int8 ``attn`` cache's codes stay
within one quantization step of the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import mamba2 as jax_m2
from repro.models import transformer as JT
from repro.models.api import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config, reduced, smoke_config
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_int8)
from repro_torch.kernels.paged_extend_attention import paged_extend_attention
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T
from repro_torch.models.api import FAMILIES, build
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "zamba2-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_SEQ = 32
LENGTHS = (8, 13, 5, 11, 7, 9)
N_NEW = 4
MODES = ("batched", "serial", "async")
COUNTERS = ("steps", "prefill_calls", "extend_chunks", "decode_steps")
PERTURBED = ("lora_b", "A_log", "dt_bias", "conv_b")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _requests(cls, vocab, temps=None):
    rng = np.random.default_rng(0)
    out = [cls(rid=i, prompt=rng.integers(0, vocab, size=n).astype(np.int32),
               max_new_tokens=N_NEW) for i, n in enumerate(LENGTHS)]
    for r, t in zip(out, temps or ()):
        r.temperature = t
    return out


def _engine_kw(mode):
    return dict(max_batch=4, max_seq=MAX_SEQ, admit_mode=mode,
                admit_token_budget=8 if mode == "async" else None)


def _streams(eng, reqs):
    for r in reqs:
        eng.submit(r)
    m = eng.run()
    return {r.rid: list(r.tokens) for r in m.completed}, m.summary()


@functools.cache
def _pair(layers: int):
    """Both packages' model and weights (the perturbed leaves equal on
    both sides) and the reference's jitted functions."""
    jcfg = jax_reduced(jax_get_config(ARCH), dtype="float32",
                       num_layers=layers)
    cfg = reduced(get_config(ARCH), dtype="float32", num_layers=layers)
    jm = jax_build(jcfg)
    rng = np.random.default_rng(layers)

    def perturb(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path).split("'")[-2] in PERTURBED:
            a = a + 0.3 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(
        perturb, jax.jit(jm.init_params)(jax.random.key(0)))
    return SimpleNamespace(
        jcfg=jcfg, cfg=cfg, jm=jm, tree=tree,
        jparams=jax.tree.map(jnp.asarray, tree),
        params=params_from_numpy(tree, cfg, "cpu"), model=build(cfg),
        jfns={n: jax.jit(getattr(jm, n))
              for n in ("prefill_fn", "extend_fn", "decode_fn")})


@pytest.fixture(scope="module", params=[4, 5], ids=["L4", "L5-tail"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def served():
    """The tail config and the reference engine's streams and summary in
    each admission mode."""
    f = _pair(5)
    f.jruns = {mode: _streams(JEngine(f.jm, f.jparams, **_engine_kw(mode)),
                              _requests(JRequest, f.cfg.vocab_size))
               for mode in MODES}
    return f


def _ref_cache(f, pos, seed=1, dtype=None):
    """A populated reference decode cache at per-row lengths ``pos``
    (random state and K/V; int8 codes and scales under ``dtype="int8"``),
    and the port's copy."""
    rng = np.random.default_rng(seed)
    jc = jax.tree.map(np.asarray, JT.make_decode_cache(
        f.jcfg, len(pos), MAX_SEQ, dtype=dtype))

    def fill(name, a):
        if a.dtype == np.int8:
            return rng.integers(-127, 128, a.shape).astype(np.int8)
        if name.endswith("_scale"):
            return (0.01 * np.abs(rng.standard_normal(a.shape))
                    + 1e-3).astype(a.dtype)
        return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)

    jc["state"] = {p: {n: fill(n, a) for n, a in st.items()}
                   for p, st in jc["state"].items()}
    jc["attn"] = {n: fill(n, a) for n, a in jc["attn"].items()}
    jc["pos"] = np.asarray(pos, np.int32)
    return jax.tree.map(jnp.asarray, jc), cache_from_numpy(jc, "cpu")


def _ref_state(jc, name):
    st = jc["state"]
    return np.concatenate([np.asarray(st[p][name]) for p in ("body", "tail")
                           if p in st])


def _close_cache(tc, jc, tol=TOL):
    for name in ("ssm", "conv"):
        _close(tc["state"][name], _ref_state(jc, name), tol)
    for name, leaf in tc["attn"].items():
        _close(leaf, jc["attn"][name], tol)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_config_equals_reference():
    want = jax_get_config(ARCH)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(want)
    assert dataclasses.asdict(smoke_config(ARCH)) == dataclasses.asdict(
        jax_reduced(want))
    assert get_config(ARCH).param_count() == want.param_count()
    assert "hybrid" in FAMILIES
    build(get_config(ARCH))             # the published config builds


def test_params_carry_the_reference_layout(pair):
    """Per-layer Mamba2 dicts (the tail apart), the LoRA stacks with their
    group axis, the perturbed leaves nonzero."""
    f = pair
    groups, per, tail = T._zamba_grouping(f.cfg)
    assert len(f.params["mamba"]) == groups * per
    assert len(f.params.get("mamba_tail", [])) == tail
    sh = f.params["shared"]
    d, r = f.cfg.d_model, f.cfg.shared_attn_lora_rank
    assert sh["lora_a"].shape == (groups, d, r)
    assert sh["lora_b"].shape == (groups, r, 3 * d)
    assert bool(sh["lora_b"].abs().gt(0).all())
    p = f.params["mamba"][0]
    assert p["w_in"].shape[1] == d and p["A_log"].dtype == torch.float32
    port = build(f.cfg).init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in port["mamba"][0].items()} == {
        k: tuple(v.shape) for k, v in p.items()}
    assert not port["shared"]["lora_b"].any()


def test_mamba2_block_matches_reference(pair):
    """Layer 0's block alone over 24 tokens from a random state."""
    f = pair
    jp = jax.tree.map(lambda a: a[0], f.jparams["mamba"])
    p = f.params["mamba"][0]
    rng = np.random.default_rng(3)
    d_in = f.cfg.ssm_expand * f.cfg.d_model
    H = d_in // f.cfg.ssm_head_dim
    N, W = f.cfg.ssm_state, f.cfg.ssm_conv_width
    x = rng.standard_normal((2, 24, f.cfg.d_model)).astype(np.float32)
    st = {"ssm": 0.5 * rng.standard_normal(
              (2, H, f.cfg.ssm_head_dim, N)).astype(np.float32),
          "conv": rng.standard_normal((2, W - 1, d_in + 2 * N)).astype(
              np.float32)}
    jy, jst = jax.jit(jax_m2.mamba2_block, static_argnums=0)(
        f.jcfg, jp, jnp.asarray(x), jax.tree.map(jnp.asarray, st))
    y, new = M2.mamba2_block(f.cfg, p, torch.tensor(x),
                             {k: torch.tensor(v) for k, v in st.items()})
    _close(y, jy)
    for k in ("ssm", "conv"):
        _close(new[k], jst[k])


def _ssd_inputs(B=2, S=64, H=2, P=4, N=8, seed=4, dtA=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    if dtA is None:
        dt = rng.uniform(0.05, 1.0, (B, S, H)).astype(np.float32)
        A = rng.uniform(0.2, 2.0, (H,)).astype(np.float32)
        s0 = 0.5 * rng.standard_normal((B, H, P, N)).astype(np.float32)
    else:
        dt = np.full((B, S, H), dtA, np.float32)
        A = np.ones((H,), np.float32)
        s0 = np.zeros((B, H, P, N), np.float32)
    return x, dt, Bm, Cm, A, s0


def _ssd_serial(x, dt, Bm, Cm, A, s0):
    st, ys = torch.tensor(s0), []
    for t in range(x.shape[1]):
        y, st = M2.ssd_decode(*(torch.tensor(a[:, t]) for a in
                                (x, dt, Bm, Cm)), torch.tensor(A), st)
        ys.append(y)
    return torch.stack(ys, 1), st


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_reference_and_serial(chunk):
    """The chunked scan against the reference's at the same chunk and
    against the port's token-serial update."""
    a = _ssd_inputs()
    jy, js = jax.jit(jax_m2.ssd_chunked, static_argnames="chunk")(
        *map(jnp.asarray, a), chunk=chunk)
    y, s = M2.ssd_chunked(*map(torch.tensor, a), chunk=chunk)
    _close(y, jy)
    _close(s, js)
    sy, ss = _ssd_serial(*a)
    torch.testing.assert_close(y, sy, **TOL)
    torch.testing.assert_close(s, ss, **TOL)


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_at_the_decay_clamp_is_finite(chunk):
    """dt * A = 3 on every token (clamped to LOG_A_MIN = -1.5) from a zero
    state over 128 tokens: the port's chunked scan stays finite at any
    chunk and equals the token-serial update. (The reference's, which
    exponentiates before its causal mask, gives NaN past a 32-token chunk
    here: 64 of 1024 outputs at chunk 64, 544 at 128.)"""
    a = _ssd_inputs(B=1, S=128, dtA=3.0)
    y, s = M2.ssd_chunked(*map(torch.tensor, a), chunk=chunk)
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    sy, ss = _ssd_serial(*a)
    torch.testing.assert_close(y, sy, **TOL)
    torch.testing.assert_close(s, ss, **TOL)


def test_set_ssd_chunk_changes_only_sum_order(pair, monkeypatch):
    """A prefill at chunk 64 gives the reference's at 32."""
    f = pair
    toks = np.random.default_rng(6).integers(0, f.cfg.vocab_size, (2, 64),
                                             dtype=np.int32)
    jl, _ = f.jfns["prefill_fn"](f.jparams, {"tokens": jnp.asarray(toks)})
    monkeypatch.setattr(M2, "CHUNK", 32)
    M2.set_ssd_chunk(64)
    assert M2.chunk_for(64) == 64 and M2.chunk_for(40) == 8
    tl, _ = f.model.prefill_fn(f.params, {"tokens": torch.tensor(toks)})
    _close(tl, jl)


@pytest.mark.parametrize("S", [40, 13], ids=["S40", "ragged-S13"])
def test_prefill_matches_reference(pair, S):
    """Logits, every layer's SSM and conv state and every group's K/V."""
    f = pair
    toks = np.random.default_rng(2).integers(0, f.cfg.vocab_size, (2, S),
                                             dtype=np.int32)
    jl, jc = f.jfns["prefill_fn"](f.jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = f.model.prefill_fn(f.params, {"tokens": torch.tensor(toks)})
    _close(tl, jl)
    groups = T._zamba_grouping(f.cfg)[0]
    assert tc["attn"]["k"].shape == (groups, 2, S, f.cfg.num_kv_heads,
                                     f.cfg.resolved_head_dim)
    assert tc["state"]["ssm"].shape[0] == f.cfg.num_layers
    _close_cache(tc, jc)


@pytest.mark.parametrize("C", [1, 12])
def test_extend_matches_reference(pair, C):
    """From a random cache at ragged lengths; C = 1 is the one-token SSD
    update on both sides (the reference picks by length)."""
    f = pair
    jc, tc = _ref_cache(f, (5, 9))
    toks = np.random.default_rng(3).integers(0, f.cfg.vocab_size, (2, C),
                                             dtype=np.int32)
    jl, jc = f.jfns["extend_fn"](f.jparams, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = f.model.extend_fn(f.params, {"tokens": torch.tensor(toks)}, tc)
    _close(tl, jl)
    _close_cache(tc, jc)


def test_prefill_extend_decode_chain_matches_reference(pair):
    """A 12-token prefill into a decode cache, a 4-token extend and two
    greedy decode steps: logits at every call, the same greedy tokens,
    and the caches at the end."""
    f = pair
    toks = np.random.default_rng(2).integers(0, f.cfg.vocab_size, (2, 16),
                                             dtype=np.int32)
    jl, jpre = f.jfns["prefill_fn"](f.jparams,
                                    {"tokens": jnp.asarray(toks[:, :12])})
    jc = JT.make_decode_cache(f.jcfg, 2, MAX_SEQ)
    jc["state"] = jpre["state"]
    jc["attn"] = {n: a.at[:, :, :12].set(jpre["attn"][n])
                  for n, a in jc["attn"].items()}
    jc["pos"] = jpre["pos"]
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    jl, jc = f.jfns["extend_fn"](f.jparams,
                                 {"tokens": jnp.asarray(toks[:, 12:])}, jc)
    tl, tc = f.model.extend_fn(f.params,
                               {"tokens": torch.tensor(toks[:, 12:])}, tc)
    _close(tl, jl)
    for _ in range(2):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        assert tok.tolist() == tl.argmax(-1).tolist()
        jl, jc = f.jfns["decode_fn"](f.jparams, {"token": jnp.asarray(tok)},
                                     jc)
        tl, tc = f.model.decode_fn(f.params, {"token": torch.tensor(tok)},
                                   tc)
        _close(tl, jl)
    _close_cache(tc, jc)


@pytest.mark.parametrize("step", ["extend", "decode"])
def test_masked_rows_keep_state_and_cache(pair, step):
    """Async admission's masked calls: the row left out of ``rows`` keeps
    its SSM and conv state, K/V and ``pos`` bit for bit; the other moves
    exactly as in an unmasked call."""
    f = pair
    _, full = _ref_cache(f, (5, 9))
    _, masked = _ref_cache(f, (5, 9))
    before = {p: {n: a.clone() for n, a in masked[p].items()}
              for p in ("state", "attn")}
    toks = torch.tensor([[3, 4, 5], [6, 7, 8]], dtype=torch.int32)
    rows = torch.tensor([False, True])
    if step == "extend":
        lf, full = f.model.extend_fn(f.params, {"tokens": toks}, full)
        lm, masked = f.model.extend_fn(f.params, {"tokens": toks}, masked,
                                       rows=rows)
    else:
        lf, full = f.model.decode_fn(f.params, {"token": toks[:, 0]}, full)
        lm, masked = f.model.decode_fn(f.params, {"token": toks[:, 0]},
                                       masked, rows=rows)
    n = 3 if step == "extend" else 1
    assert masked["pos"].tolist() == [5, 9 + n]
    torch.testing.assert_close(lm[1], lf[1], rtol=0, atol=0)
    for p in ("state", "attn"):
        for name, a in masked[p].items():
            assert torch.equal(a[:, 0], before[p][name][:, 0])
            assert torch.equal(a[:, 1], full[p][name][:, 1])


def test_int8_attn_within_one_quantization_step(pair):
    """``make_decode_cache(dtype="int8")`` on both sides, filled by an
    8-token extend and two decode steps: the int8 codes within one step
    of the reference's, the scales, states and logits within 1e-4."""
    f = pair
    jc, tc = _ref_cache(f, (5, 9), dtype="int8")
    assert tc["attn"]["k"].dtype == torch.int8
    assert set(tc["attn"]) == {"k", "k_scale", "v", "v_scale"}
    toks = np.random.default_rng(9).integers(0, f.cfg.vocab_size, (2, 10),
                                             dtype=np.int32)
    jl, jc = f.jfns["extend_fn"](f.jparams,
                                 {"tokens": jnp.asarray(toks[:, :8])}, jc)
    tl, tc = f.model.extend_fn(f.params, {"tokens": torch.tensor(
        toks[:, :8])}, tc)
    _close(tl, jl)
    for i in (8, 9):
        jl, jc = f.jfns["decode_fn"](f.jparams,
                                     {"token": jnp.asarray(toks[:, i])}, jc)
        tl, tc = f.model.decode_fn(f.params,
                                   {"token": torch.tensor(toks[:, i])}, tc)
        _close(tl, jl)
    for name in ("k", "v"):
        step = np.abs(tc["attn"][name].numpy().astype(np.int32)
                      - np.asarray(jc["attn"][name]).astype(np.int32))
        assert step.max() <= 1
        _close(tc["attn"][f"{name}_scale"], jc["attn"][f"{name}_scale"])
    for name in ("ssm", "conv"):
        _close(tc["state"][name], _ref_state(jc, name))


def test_quantize_leaves_a_hybrid_cache(pair):
    """``quantize_decode_cache`` leaves a hybrid cache as it is (the
    reference quantizes only ``kv``)."""
    f = pair
    jc, tc = _ref_cache(f, (5, 9))
    tq = T.quantize_decode_cache(tc)
    assert tq is not tc and set(tq) == set(tc)
    assert all(tq["attn"][n] is tc["attn"][n] for n in tc["attn"])
    jq = JT.quantize_decode_cache(jc)
    assert set(jq["attn"]) == {"k", "v"}


@pytest.mark.parametrize("mode", MODES)
def test_engine_matches_reference_engine(served, mode):
    """Greedy streams and the counters of the reference engine in the
    same admission mode; batched == serial == async; the books balance."""
    f = served
    jstreams, jsum = f.jruns[mode]
    eng = ServingEngine(f.model, f.params, **_engine_kw(mode))
    streams, s = _streams(eng, _requests(Request, f.cfg.vocab_size))
    assert s["num_completed"] == len(LENGTHS)
    assert streams == jstreams == f.jruns["batched"][0]
    assert {k: s[k] for k in COUNTERS} == {k: jsum[k] for k in COUNTERS}
    assert eng.reconcile()["balanced"]


def test_paged_engine_stays_dense(served):
    """Asked for pages, a hybrid engine keeps its dense caches, as the
    reference's does, and serves the same streams."""
    f = served
    eng = ServingEngine(f.model, f.params, paged=True, page_size=8,
                        **_engine_kw("batched"))
    assert not eng.paged and not T.supports_paged_cache(f.cfg)
    assert set(eng.cache) == {"state", "attn", "pos"}
    with pytest.raises(ValueError, match="paged layout"):
        T.make_paged_decode_cache(f.cfg, 2, MAX_SEQ, "cpu")
    streams, _ = _streams(eng, _requests(Request, f.cfg.vocab_size))
    assert streams == f.jruns["batched"][0]


@pytest.mark.parametrize("mode", ["batched", "async"])
def test_preempt_and_resume_continue_bit_identically(served, mode):
    """Drained after 2 steps and resumed on an engine with another seed:
    the uninterrupted streams, sampled rows included; no token is
    duplicated and both ledgers balance."""
    f = served
    temps = (0.0, 0.7, 0.0, 1.3, 0.0, 0.9)
    kw = _engine_kw(mode)
    want, _ = _streams(ServingEngine(f.model, f.params, seed=5, **kw),
                       _requests(Request, f.cfg.vocab_size, temps))
    e1 = ServingEngine(f.model, f.params, seed=5, **kw)
    for r in _requests(Request, f.cfg.vocab_size, temps):
        e1.submit(r)
    for _ in range(2):
        e1.step()
    done = {r.rid: list(r.tokens) for r in e1.metrics.completed}
    snaps = e1.drain()
    assert any(0 < len(s.tokens) < N_NEW for s in snaps)
    assert e1.reconcile()["balanced"]
    e2 = ServingEngine(f.model, f.params, seed=99, **kw)
    for s in snaps:
        assert e2.resume(s) is not None
    got, s2 = _streams(e2, [])
    assert {**done, **got} == want
    assert e2.metrics.duplicated_tokens == 0
    assert e2.reconcile()["balanced"]


@pytest.mark.parametrize("fn", ["paged_decode", "paged_decode_int8",
                                "paged_extend"])
def test_paged_kernels_refuse_hd_112(fn):
    """Kernels 4, 4-int8 and 5 are not built at hd 112 (no paged path
    runs it): their wrappers refuse the width before anything else."""
    B, H, hd, P, page = 2, 4, 112, 4, 16
    q = torch.zeros((B, H, hd), dtype=torch.bfloat16)
    pool = torch.zeros((P, page, H, hd), dtype=torch.bfloat16)
    table = torch.zeros((B, 2), dtype=torch.int32)
    lens = torch.ones((B,), dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim 112"):
        if fn == "paged_decode":
            paged_decode_attention(q, pool, pool, table, lens)
        elif fn == "paged_decode_int8":
            p8 = pool.to(torch.int8)
            sc = torch.ones((P, page, H), dtype=torch.float32)
            paged_decode_attention_int8(q, p8, p8, sc, sc, table, lens)
        else:
            qc = q[:, None]
            kn = torch.zeros((B, 1, H, hd), dtype=torch.bfloat16)
            paged_extend_attention(qc, pool, pool, kn, kn, table, lens)
