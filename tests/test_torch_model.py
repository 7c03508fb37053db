"""Port model: prefill, extend and decode against the reference package.

Both sides use the same weights: the reference's ``init_params`` tree,
carried across by ``repro_torch.models.convert.params_from_numpy``, on
``reduced(llama3.2-1b, num_kv_heads=2, dtype="float32")`` (two KV heads so
that GQA is exercised). Logits and caches agree to 1e-4: the same fp32
math with sums taken in another order (the port's decode inserts the new
token first and attends over ``pos + 1`` cached tokens; the reference
attends over the cache plus the new token).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama32_1b as jax_llama
from repro.configs.base import reduced as jax_reduced
from repro.models.api import build as jax_build
from repro_torch.configs import llama32_1b, reduced
from repro_torch.models import transformer as T
from repro_torch.models.api import build
from repro_torch.models.convert import params_from_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
MAX_SEQ = 32


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_llama, num_kv_heads=2, dtype="float32")
    cfg = reduced(llama32_1b, num_kv_heads=2, dtype="float32")
    jm = jax_build(jcfg)
    jparams = jm.init_params(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jfns = {n: jax.jit(getattr(jm, n))
            for n in ("prefill_fn", "extend_fn", "decode_fn")}
    return cfg, build(cfg), params, jfns, jparams


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _caches(cfg, pos, seed=0):
    """A populated decode cache at per-row lengths ``pos``, both sides."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, len(pos), MAX_SEQ, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    k, v = (rng.standard_normal(shape, np.float32) for _ in range(2))
    pos = np.asarray(pos, np.int32)
    jc = {"kv": {"k": jnp.asarray(k), "v": jnp.asarray(v)},
          "pos": jnp.asarray(pos)}
    tc = {"kv": {"k": torch.tensor(k), "v": torch.tensor(v)},
          "pos": torch.tensor(pos)}
    return jc, tc


def _close_cache(tc, jc):
    _close(tc["kv"]["k"], jc["kv"]["k"])
    _close(tc["kv"]["v"], jc["kv"]["v"])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_prefill_matches_reference(pair):
    cfg, model, params, jfns, jparams = pair
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    jl, jc = jfns["prefill_fn"](jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = model.prefill_fn(params, {"tokens": torch.tensor(toks)})
    _close(tl, jl)
    _close_cache(tc, jc)


@pytest.mark.parametrize("C", [1, 4])
def test_extend_matches_reference(pair, C):
    """Chunks continue from ragged per-row offsets (C=1 is the engine's
    smallest tail chunk)."""
    cfg, model, params, jfns, jparams = pair
    jc, tc = _caches(cfg, (5, 9))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, C),
                                             dtype=np.int32)
    jl, jc = jfns["extend_fn"](jparams, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = model.extend_fn(params, {"tokens": torch.tensor(toks)}, tc)
    _close(tl, jl)
    _close_cache(tc, jc)


def test_extend_rows_mask_leaves_other_rows(pair):
    cfg, model, params, _, _ = pair
    _, full = _caches(cfg, (5, 9))
    _, masked = _caches(cfg, (5, 9))
    before = {k: masked["kv"][k].clone() for k in ("k", "v")}
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 4), dtype=np.int32))
    lf, full = model.extend_fn(params, {"tokens": toks}, full)
    lm, masked = model.extend_fn(params, {"tokens": toks}, masked,
                                 rows=torch.tensor([True, False]))
    torch.testing.assert_close(lm[0], lf[0])
    assert masked["pos"].tolist() == [9, 9]
    for k in ("k", "v"):
        torch.testing.assert_close(masked["kv"][k][:, 0], full["kv"][k][:, 0])
        torch.testing.assert_close(masked["kv"][k][:, 1], before[k][:, 1])


def test_decode_matches_reference(pair):
    cfg, model, params, jfns, jparams = pair
    jc, tc = _caches(cfg, (1, 17, MAX_SEQ - 1))
    tok = np.asarray([3, 200, 41], np.int32)
    jl, jc = jfns["decode_fn"](jparams, {"token": jnp.asarray(tok)}, jc)
    tl, tc = model.decode_fn(params, {"token": torch.tensor(tok)}, tc)
    _close(tl, jl)
    _close_cache(tc, jc)


def test_greedy_stream_matches_reference(pair):
    """Prefill, then greedy decode steps: the token streams are equal."""
    cfg, model, params, jfns, jparams = pair
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8),
                                             dtype=np.int32)
    jl, jpre = jfns["prefill_fn"](jparams, {"tokens": jnp.asarray(toks)})
    tl, tpre = model.prefill_fn(params, {"tokens": torch.tensor(toks)})
    jc, tc = _caches(cfg, (0, 0))
    jc["kv"] = jax.tree.map(lambda c, p: c.at[:, :, :8].set(p), jc["kv"],
                            jpre["kv"])
    jc["pos"] = jpre["pos"]
    for k in ("k", "v"):
        tc["kv"][k][:, :, :8] = tpre["kv"][k]
    tc["pos"] = tpre["pos"]
    jstream, tstream = [], []
    for _ in range(6):
        jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), tl.argmax(-1)
        jstream.append(np.asarray(jt).tolist())
        tstream.append(tt.tolist())
        jl, jc = jfns["decode_fn"](jparams, {"token": jt}, jc)
        tl, tc = model.decode_fn(params, {"token": tt.to(torch.int32)}, tc)
    assert tstream == jstream


def test_init_params_scales():
    """Same initialisers as the reference: ones for norms, normal with
    std 1/sqrt(fan_in) for projections, in the [out, in] layout."""
    cfg = reduced(llama32_1b, num_kv_heads=2, d_model=128, d_ff=256,
                  dtype="float32")
    p = T.init_params(cfg, torch.Generator().manual_seed(0))
    lay = p["layers"][0]
    assert torch.equal(lay["ln1"], torch.ones(128))
    assert lay["attn"]["wq"].shape == (cfg.num_heads * 16, 128)
    assert lay["mlp"]["w_down"].shape == (128, 256)
    for w, fan_in in ((lay["attn"]["wq"], 128), (lay["mlp"]["w_down"], 256),
                      (p["embed"]["embed"], 128)):
        assert abs(w.std().item() * math.sqrt(fan_in) - 1.0) < 0.05
