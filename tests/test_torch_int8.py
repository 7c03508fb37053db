"""Port int8 KV cache against the reference package.

The same inputs, drawn with numpy, go through the reference (its Pallas
int8 decode kernel in interpret mode, its layers and its model) and
through ``repro_torch``, on ``reduced(llama3.2-1b, num_kv_heads=2,
dtype="float32")`` with the reference's weights and caches carried across
by ``models.convert``. The decode paths attend the cached tokens
dequantized and the new token at full precision, as the reference does,
so fp32 results agree to 2e-5 at the kernel and 1e-4 at the logits; the
quantized caches agree to one int8 step (a value on a rounding boundary
may round either way after sums in another order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama32_1b as jax_llama
from repro.configs.base import reduced as jax_reduced
from repro.kernels.decode_attention import decode_attention_int8 as jdec8
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import build as jax_build
from repro_torch.configs import llama32_1b, reduced
from repro_torch.kernels import ops
from repro_torch.models import layers as Lyr
from repro_torch.models import transformer as T
from repro_torch.models.api import build
from repro_torch.models.convert import cache_from_numpy, params_from_numpy

KTOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _quantized(rng, shape):
    """fp32 K or V of ``shape`` [..., KVH, hd], quantized by the
    reference: (int8 values, fp32 scales) as numpy arrays."""
    q, s = JL.quantize_kv(jnp.asarray(rng.standard_normal(shape)
                                      .astype(np.float32) * 2.0))
    return np.array(q), np.array(s)


def test_quantize_kv_matches_reference():
    x = (np.random.default_rng(0).standard_normal((3, 5, 2, 16))
         .astype(np.float32) * 3.0)
    jq, js = JL.quantize_kv(jnp.asarray(x))
    tq, ts = Lyr.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    _close(ts, js, dict(atol=0, rtol=1e-6))


@pytest.mark.parametrize("B,S,H,KVH,hd,lengths", [
    (2, 32, 8, 2, 64, (1, 32)),
    (3, 48, 6, 1, 16, (17, 0, 40)),
])
def test_decode_int8_plain_matches_pallas(B, S, H, KVH, hd, lengths):
    """Without a fresh token the plain int8 decode is the Pallas kernel's
    function: attention over the dequantized valid prefix."""
    rng = np.random.default_rng(1)
    kq, ks = _quantized(rng, (B, S, KVH, hd))
    vq, vs = _quantized(rng, (B, S, KVH, hd))
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    want = jdec8(*[jnp.asarray(a) for a in (q, kq, vq, ks, vs, lens)],
                 block_k=16, interpret=True)
    got = ops.decode_attention_int8(*[torch.from_numpy(a) for a in
                                      (q, kq, vq, ks, vs, lens)])
    live = lens > 0          # a row of length 0 is undefined on both sides
    _close(got[live], np.asarray(want)[live], KTOL)


def test_decode_int8_plain_with_fresh_token_matches_layers():
    """With the fresh token, the plain int8 decode (dense and paged) is
    the reference model's decode math over the dequantized cache."""
    rng = np.random.default_rng(2)
    B, S, H, KVH, hd, page = 2, 32, 8, 2, 16, 8
    kq, ks = _quantized(rng, (B, S, KVH, hd))
    vq, vs = _quantized(rng, (B, S, KVH, hd))
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, KVH, hd)).astype(np.float32)
              for _ in range(2))
    pos = np.asarray([0, 21], np.int32)
    kd = jnp.asarray(kq, jnp.float32) * jnp.asarray(ks)[..., None]
    vd = jnp.asarray(vq, jnp.float32) * jnp.asarray(vs)[..., None]
    want = JL.decode_attention(jnp.asarray(q)[:, None], kd, vd,
                               jnp.asarray(kn), jnp.asarray(vn),
                               jnp.asarray(pos))[:, 0]
    t = [torch.from_numpy(a) for a in (q, kq, vq, ks, vs, pos, kn, vn)]
    dense = ops.decode_attention_int8(*t[:6], k_new=t[6], v_new=t[7])
    _close(dense, want, KTOL)
    # the same rows as pages: row b's page j is pool page b * 4 + j
    pools = [torch.cat([a.reshape(B * S // page, page, *a.shape[2:]),
                        torch.zeros((1, page, *a.shape[2:]), dtype=a.dtype)])
             for a in t[1:5]]
    table = torch.arange(B * S // page, dtype=torch.int32).reshape(B, -1)
    paged = ops.paged_decode_attention(t[0], pools[0], pools[1], table, t[5],
                                       k_scale=pools[2], v_scale=pools[3],
                                       k_new=t[6], v_new=t[7])
    _close(paged, want, KTOL)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced(jax_llama, num_kv_heads=2, dtype="float32")
    cfg = reduced(llama32_1b, num_kv_heads=2, dtype="float32")
    jm = jax_build(jcfg)
    jparams = jm.init_params(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jm, jparams, cfg, build(cfg), params


def _fp_cache(jcfg, pos, paged, seed=0, max_seq=32, page=8):
    """A populated fp32 reference cache (dense, or paged with a permuted
    table) at per-row lengths ``pos``."""
    rng = np.random.default_rng(seed)
    B = len(pos)
    if paged:
        c = JT.make_paged_decode_cache(jcfg, B, max_seq, page_size=page)
        P = c["kv"]["k"].shape[1]
        c["table"] = jnp.asarray(rng.permutation(P).reshape(B, -1)
                                 .astype(np.int32))
    else:
        c = JT.make_decode_cache(jcfg, B, max_seq)
    c["kv"] = {n: jnp.asarray(rng.standard_normal(c["kv"][n].shape)
                              .astype(np.float32)) for n in ("k", "v")}
    c["pos"] = jnp.asarray(np.asarray(pos, np.int32))
    return c


def _close_cache(tc, jc, paged):
    cut = (lambda a: a[:, :-1]) if paged else (lambda a: a)
    for n in ("k", "v"):
        diff = np.abs(cut(tc["kv"][n]).numpy().astype(np.int32)
                      - np.asarray(jc["kv"][n]).astype(np.int32))
        assert diff.max() <= 1
        _close(cut(tc["kv"][f"{n}_scale"]), jc["kv"][f"{n}_scale"], TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_extend_then_decode_match_reference(pair, paged):
    """Quantize a populated cache on both sides, then one extend chunk and
    two greedy decode steps: logits within 1e-4, caches to one step."""
    jcfg, jm, jparams, cfg, model, params = pair
    jc = JT.quantize_decode_cache(_fp_cache(jcfg, (3, 11), paged))
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert tc["kv"]["k"].dtype == torch.int8
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 4),
                                             dtype=np.int32)
    jl, jc = jm.extend_fn(jparams, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = model.extend_fn(params, {"tokens": torch.tensor(toks)}, tc)
    _close(tl, jl, TOL)
    for _ in range(2):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        assert tok.tolist() == tl.argmax(-1).tolist()
        jl, jc = jm.decode_fn(jparams, {"token": jnp.asarray(tok)}, jc)
        tl, tc = model.decode_fn(params, {"token": torch.tensor(tok)}, tc)
        _close(tl, jl, TOL)
    _close_cache(tc, jc, paged)


def test_quantize_decode_cache_matches_reference(pair):
    jcfg = pair[0]
    for paged in (False, True):
        jc = _fp_cache(jcfg, (5, 9), paged, seed=6)
        want = JT.quantize_decode_cache(jc)
        got = T.quantize_decode_cache(
            cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu"))
        if paged:
            assert torch.equal(got["table"],
                               torch.tensor(np.asarray(want["table"])))
        _close_cache(got, want, paged)


def test_int8_paged_matches_int8_dense(pair):
    """The port's paged int8 cache against its dense int8 cache holding
    the same tokens: the same logits (to rounding) through extend and
    decode."""
    _, _, _, cfg, model, params = pair
    dense = T.make_decode_cache(cfg, 1, 32, "cpu", dtype="int8")
    paged = T.make_paged_decode_cache(cfg, 1, 32, "cpu", page_size=8,
                                      num_pages=4, dtype="int8")
    paged["table"] = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32)
    prompt = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 12), dtype=np.int32))
    ld, dense = model.extend_fn(params, {"tokens": prompt}, dense)
    lp, paged = model.extend_fn(params, {"tokens": prompt}, paged)
    torch.testing.assert_close(lp, ld, **TOL)
    tok = ld.argmax(-1).to(torch.int32)
    ld, dense = model.decode_fn(params, {"token": tok}, dense)
    lp, paged = model.decode_fn(params, {"token": tok}, paged)
    torch.testing.assert_close(lp, ld, **TOL)
    assert paged["kv"]["k"].dtype == torch.int8
    assert int(paged["pos"][0]) == int(dense["pos"][0]) == 13
