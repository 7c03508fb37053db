"""The MLA family (deepseek-v2-236b) against the reference package, on the CPU.

``reduced(deepseek-v2-236b, dtype="float32")`` (2 layers, d 64, 4 heads,
q_lora 48, kv_lora 32, qk nope 16 + rope 8 over v 16, 4 experts top-2
plus a shared one) with the reference's weights carried across by
``models.convert``; the reference side is built once for the module.
MLA's three functions (the expanded prefill, the absorbed extend and
decode) give the reference's outputs and latents ``ckv``/``kr`` within
1e-4; so do the model's prefill, extend and decode logits, with the same
greedy tokens. The port's engine gives the reference engine's greedy
streams and counters in batched, serial and async admission, stays dense
when asked for pages, keeps the latents through ``quantize_decode_cache``
and continues bit for bit after a preemption. The MoE block at 16 experts,
top-6, 2 shared, gives the reference's compute-every-expert output within
1e-4, and slicing its tokens changes no bit. ``attention_ref`` with a
q/k width above its v width (24 over 16, and MLA's 192 over 128) gives the
reference's ``attend`` within 1e-5.
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
from repro.models import layers as jax_layers
from repro.models import mla as jax_mla
from repro.models import moe as jax_moe
from repro.models import transformer as JT
from repro.models.api import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config, reduced, smoke_config
from repro_torch.kernels import ref
from repro_torch.models import mla, moe
from repro_torch.models import transformer as T
from repro_torch.models.api import build
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "deepseek-v2-236b"
TOL = dict(atol=1e-4, rtol=1e-4)
TOL_ATTN = dict(atol=1e-5, rtol=1e-5)
MAX_SEQ = 32
LENGTHS = (8, 13, 5, 11, 7, 9)
N_NEW = 4
MODES = ("batched", "serial", "async")
COUNTERS = ("steps", "prefill_calls", "extend_chunks", "decode_steps")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                max_new_tokens=N_NEW) for i, n in enumerate(LENGTHS)]


def _engine_kw(mode):
    return dict(max_batch=4, max_seq=MAX_SEQ, admit_mode=mode,
                admit_token_budget=8 if mode == "async" else None)


def _streams(eng, reqs):
    for r in reqs:
        eng.submit(r)
    m = eng.run()
    return {r.rid: list(r.tokens) for r in m.completed}, m.summary()


@pytest.fixture(scope="module")
def pair():
    """Both packages' model, weights and jitted functions, and the
    reference engine's streams and summary in each admission mode."""
    jcfg = jax_reduced(jax_get_config(ARCH), dtype="float32")
    cfg = reduced(get_config(ARCH), dtype="float32")
    jm = jax_build(jcfg)
    jparams = jax.jit(jm.init_params)(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jruns = {mode: _streams(JEngine(jm, jparams, **_engine_kw(mode)),
                            _requests(JRequest, cfg.vocab_size))
             for mode in MODES}
    return SimpleNamespace(
        jcfg=jcfg, cfg=cfg, jm=jm, jparams=jparams, params=params,
        model=build(cfg), jruns=jruns,
        jfns={n: jax.jit(getattr(jm, n))
              for n in ("prefill_fn", "extend_fn", "decode_fn")})


def _latent_cache(f, pos, seed=1):
    """A populated fp32 reference decode cache at per-row lengths ``pos``
    (random latents), and the port's copy."""
    rng = np.random.default_rng(seed)
    jc = JT.make_decode_cache(f.jcfg, len(pos), MAX_SEQ)
    jc["kv"] = {n: jnp.asarray(rng.standard_normal(a.shape)
                               .astype(np.float32))
                for n, a in jc["kv"].items()}
    jc["pos"] = jnp.asarray(np.asarray(pos, np.int32))
    return jc, cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")


def _close_cache(tc, jc):
    assert set(tc["kv"]) == {"ckv", "kr"}
    for n in ("ckv", "kr"):
        _close(tc["kv"][n], jc["kv"][n])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_config_equals_reference():
    want = jax_get_config(ARCH)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(want)
    assert dataclasses.asdict(smoke_config(ARCH)) == dataclasses.asdict(
        jax_reduced(want))
    build(get_config(ARCH))             # the published config builds


@pytest.mark.parametrize("step", ["prefill", "extend", "decode"])
def test_mla_functions_match_reference(pair, step):
    """Layer 0's MLA alone: the expanded prefill from scratch, a 4-token
    absorbed extend and an absorbed decode from ragged latent caches;
    the latents written agree too."""
    f = pair
    jp = jax.tree.map(lambda a: a[0], f.jparams["layers"]["attn"])
    p = f.params["layers"][0]["attn"]
    rng = np.random.default_rng(7)
    B, C = 3, {"prefill": 10, "extend": 4, "decode": 1}[step]
    x = rng.standard_normal((B, C, f.cfg.d_model)).astype(np.float32)
    if step == "prefill":
        jo, jc = jax.jit(jax_mla.mla_prefill, static_argnums=(0, 4))(
            f.jcfg, jp, jnp.asarray(x), jnp.arange(C), True)
        o, (ckv, kr) = mla.mla_prefill(f.cfg, p, torch.tensor(x),
                                       torch.arange(C))
        _close(o, jo)
        _close(ckv, jc["ckv"])
        _close(kr, jc["kr"])
        return
    pos = np.asarray([0, 9, MAX_SEQ - C], np.int32)
    cache = {n: rng.standard_normal((B, MAX_SEQ, w)).astype(np.float32)
             for n, w in (("ckv", f.cfg.kv_lora_rank),
                          ("kr", f.cfg.qk_rope_head_dim))}
    jfn = jax_mla.mla_extend if step == "extend" else jax_mla.mla_decode
    fn = mla.mla_extend if step == "extend" else mla.mla_decode
    jo, jc = jax.jit(jfn, static_argnums=0)(
        f.jcfg, jp, jnp.asarray(x),
                 {n: jnp.asarray(a) for n, a in cache.items()},
                 jnp.asarray(pos))
    tc = {n: torch.tensor(a) for n, a in cache.items()}
    o = fn(f.cfg, p, torch.tensor(x), tc, torch.tensor(pos))
    _close(o, jo)
    for n in ("ckv", "kr"):
        _close(tc[n], jc[n])


def test_prefill_extend_decode_logits_match_reference(pair):
    """A 12-token prefill into a decode cache, a 4-token extend and two
    greedy decode steps: logits within 1e-4 at every call, the same
    greedy tokens, and the latent caches at the end."""
    f = pair
    rng = np.random.default_rng(2)
    toks = rng.integers(0, f.cfg.vocab_size, (2, 16), dtype=np.int32)
    jl, jpre = f.jfns["prefill_fn"](f.jparams,
                                    {"tokens": jnp.asarray(toks[:, :12])})
    tl, tpre = f.model.prefill_fn(f.params,
                                  {"tokens": torch.tensor(toks[:, :12])})
    _close(tl, jl)
    assert tpre["kv"]["ckv"].shape == (f.cfg.num_layers, 2, 12,
                                       f.cfg.kv_lora_rank)
    _close_cache(tpre, jpre)
    jc = JT.make_decode_cache(f.jcfg, 2, MAX_SEQ)
    jc["kv"] = {n: a.at[:, :, :12].set(jpre["kv"][n])
                for n, a in jc["kv"].items()}
    jc["pos"] = jpre["pos"]
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    jl, jc = f.jfns["extend_fn"](f.jparams,
                                 {"tokens": jnp.asarray(toks[:, 12:])}, jc)
    tl, tc = f.model.extend_fn(f.params, {"tokens": torch.tensor(
        toks[:, 12:])}, tc)
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


@pytest.mark.parametrize("C", [1, 4])
def test_extend_from_ragged_cache_matches_reference(pair, C):
    """From random latents at ragged lengths; C = 1 runs the absorbed
    decode on both sides, as the reference picks by the chunk's length."""
    f = pair
    jc, tc = _latent_cache(f, (5, 9))
    toks = np.random.default_rng(3).integers(0, f.cfg.vocab_size, (2, C),
                                             dtype=np.int32)
    jl, jc = f.jfns["extend_fn"](f.jparams, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = f.model.extend_fn(f.params, {"tokens": torch.tensor(toks)}, tc)
    _close(tl, jl)
    _close_cache(tc, jc)


def test_masked_rows_write_no_latent(pair):
    """Async admission's masked calls: a row left out of ``rows`` keeps
    its latents and ``pos`` bit for bit, in extend and in decode."""
    f = pair
    _, tc = _latent_cache(f, (5, 9))
    before = {n: a.clone() for n, a in tc["kv"].items()}
    rows = torch.tensor([True, False])
    toks = torch.tensor([[3, 4, 5], [6, 7, 8]], dtype=torch.int32)
    _, tc = f.model.extend_fn(f.params, {"tokens": toks}, tc, rows=rows)
    _, tc = f.model.decode_fn(f.params, {"token": toks[:, 0]}, tc, rows=rows)
    assert tc["pos"].tolist() == [9, 9]
    for n, a in tc["kv"].items():
        assert torch.equal(a[:, 1], before[n][:, 1])
        assert not torch.equal(a[:, 0, 5:9], before[n][:, 0, 5:9])


@pytest.mark.parametrize("mode", MODES)
def test_engine_matches_reference_engine(pair, mode):
    """Greedy streams and the counters of the reference engine in the
    same admission mode; the books balance."""
    f = pair
    jstreams, jsum = f.jruns[mode]
    eng = ServingEngine(f.model, f.params, **_engine_kw(mode))
    streams, s = _streams(eng, _requests(Request, f.cfg.vocab_size))
    assert s["num_completed"] == len(LENGTHS)
    assert streams == jstreams
    assert {k: s[k] for k in COUNTERS} == {k: jsum[k] for k in COUNTERS}
    assert eng.reconcile()["balanced"]


def test_paged_engine_stays_dense(pair):
    """Asked for pages, an MLA engine keeps its dense latent cache (as the
    reference's does) and serves the same streams."""
    f = pair
    eng = ServingEngine(f.model, f.params, paged=True, page_size=8,
                        **_engine_kw("batched"))
    jeng = JEngine(f.jm, f.jparams, paged=True, page_size=8,
                   **_engine_kw("batched"))
    assert not eng.paged and not jeng.paged
    assert not T.supports_paged_cache(f.cfg)
    assert set(eng.cache["kv"]) == {"ckv", "kr"}
    with pytest.raises(ValueError, match="paged layout"):
        T.make_paged_decode_cache(f.cfg, 2, MAX_SEQ, "cpu")
    streams, _ = _streams(eng, _requests(Request, f.cfg.vocab_size))
    assert streams == f.jruns["batched"][0]


def test_quantize_leaves_latents(pair):
    """``quantize_decode_cache`` returns the latents unchanged, as the
    reference does; there is no int8 latent layout to allocate."""
    f = pair
    jc, tc = _latent_cache(f, (5, 9))
    jq = JT.quantize_decode_cache(jc)
    tq = T.quantize_decode_cache(tc)
    assert tq is not tc and set(tq["kv"]) == {"ckv", "kr"}
    for n in ("ckv", "kr"):
        assert tq["kv"][n] is tc["kv"][n]
        np.testing.assert_array_equal(np.asarray(jq["kv"][n]),
                                      np.asarray(jc["kv"][n]))
    with pytest.raises(ValueError, match="never quantized"):
        T.make_decode_cache(f.cfg, 2, MAX_SEQ, "cpu", dtype="int8")


def test_preempt_and_resume_continue_bit_identically(pair):
    """Drained after 2 steps (mid-decode: an admission step gives two
    tokens) and resumed on an engine with another seed: the uninterrupted
    streams, sampled rows included."""
    f = pair
    temps = (0.0, 0.7, 0.0, 1.3, 0.0, 0.9)

    def reqs():
        out = _requests(Request, f.cfg.vocab_size)
        for r, t in zip(out, temps):
            r.temperature = t
        return out

    want, _ = _streams(ServingEngine(f.model, f.params, seed=5,
                                     **_engine_kw("batched")), reqs())
    e1 = ServingEngine(f.model, f.params, seed=5, **_engine_kw("batched"))
    for r in reqs():
        e1.submit(r)
    for _ in range(2):
        e1.step()
    done = {r.rid: list(r.tokens) for r in e1.metrics.completed}
    snaps = e1.drain()
    assert any(0 < len(s.tokens) < N_NEW for s in snaps)
    assert e1.reconcile()["balanced"]
    e2 = ServingEngine(f.model, f.params, seed=99, **_engine_kw("batched"))
    for s in snaps:
        assert e2.resume(s) is not None
    got, _ = _streams(e2, [])
    assert {**done, **got} == want


@pytest.fixture(scope="module")
def moe_pair():
    """deepseek-v2's routing at a CPU size: 16 experts, top-6, 2 shared."""
    kw = dict(dtype="float32", num_experts=16, experts_per_token=6,
              num_shared_experts=2)
    jcfg = jax_reduced(jax_get_config(ARCH), **kw)
    cfg = reduced(get_config(ARCH), **kw)
    jp = jax.jit(jax_moe.moe_params, static_argnums=1)(jax.random.key(1),
                                                       jcfg)
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)
    x = np.random.default_rng(1).standard_normal((3, 7, cfg.d_model),
                                                 np.float32)
    return jcfg, cfg, jp, p, x


def test_moe_block_top6_shared2_matches_dense_ref(moe_pair):
    jcfg, cfg, jp, p, x = moe_pair
    want, want_aux = jax.jit(jax_moe.moe_dense_ref, static_argnums=0)(
        jcfg, jp, jnp.asarray(x))
    got, aux = moe.moe_block(cfg, p, torch.tensor(x))
    assert p["shared"]["w_gate"].shape == (cfg.d_model,
                                           2 * cfg.resolved_moe_d_ff)
    _close(got, want)
    _close(aux, want_aux)


def test_moe_token_slices_change_no_bit(moe_pair, monkeypatch):
    """21 tokens in slices of 3 (the bucket budget cut to 3 tokens) give
    the one-slice output bit for bit, and the same aux loss."""
    _, cfg, _, p, x = moe_pair
    whole, aux = moe.moe_block(cfg, p, torch.tensor(x))
    per_token = cfg.num_experts * cfg.d_model * 4
    assert moe.slice_tokens(cfg.num_experts, cfg.d_model,
                            torch.float32) >= 21
    monkeypatch.setattr(moe, "SLICE_BYTES", 3 * per_token + 5)
    assert moe.slice_tokens(cfg.num_experts, cfg.d_model, torch.float32) == 3
    sliced, aux_s = moe.moe_block(cfg, p, torch.tensor(x))
    assert torch.equal(sliced, whole) and torch.equal(aux_s, aux)


def test_slice_tokens_bounds_deepseek_buckets():
    """At deepseek-v2's width a slice's bucket stays within 1 GiB."""
    cfg = get_config(ARCH)
    Tc = moe.slice_tokens(cfg.num_experts, cfg.d_model, torch.bfloat16)
    assert Tc == 655
    assert cfg.num_experts * Tc * cfg.d_model * 2 <= moe.SLICE_BYTES
    assert moe.slice_tokens(16, 4096, torch.bfloat16) == 8192   # phi3.5


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,S,H,KVH,hd,vd", [(2, 9, 4, 2, 24, 16),
                                             (1, 20, 2, 2, 192, 128)],
                         ids=["24-16", "192-128"])
def test_attention_ref_vd_matches_reference(causal, B, S, H, KVH, hd, vd):
    """Kernel 1's plain version when v is narrower than q/k: the output
    takes v's width and the scale q's."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, vd)).astype(np.float32)
    want = jax.jit(jax_layers.attend, static_argnames="causal")(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = ref.attention_ref(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), causal=causal)
    assert got.shape == (B, S, H, vd)
    _close(got, want, TOL_ATTN)
