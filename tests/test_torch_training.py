"""The port's training path against the reference package, on the CPU.

Both sides take the same inputs: weights from the reference's
``init_params`` carried across by ``models.convert.params_from_numpy``
(its gradients mapped the same way), batches from numpy. Configs are the
reference's smoke configs at fp32 (``reduced(cfg, dtype="float32")``).
Tolerances, each with its reason: attention gradients 1e-5 (the same fp32
math, sums in another order); ``loss_fn`` 1e-5 on the loss and 1e-4 on
every gradient leaf (two layers of fp32 products, then the backward's
sums over the batch), for phi3.5-moe too, whose loss adds 0.01 times its
layers' router aux losses and whose leaves include the router, for
seamless-m4t-medium, whose batch carries frames (normal x 0.02, as the
reference's smoke test builds them), for paligemma-3b, whose batch carries
patches (the same), a bidirectional prefix that the logits drop, and for
rwkv6-1.6b; the optimizer 1e-6 (the same fp32 elementwise ops);
three train steps 1e-4 (the gradients' 1e-4 through AdamW, whose update
is bounded by the learning rate); int8 codes bitwise (the same fp32
scale, round half to even).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.kernels import ref as jax_ref
from repro.models.api import build as jax_build
from repro import training as jax_training
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ops, ref
from repro_torch.models.api import build
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import (AdamW, compress_int8, decompress_int8,
                                  default_schedule, global_norm, lr_schedule,
                                  make_train_step)
from repro_torch.tree import leaves, tree_map

ARCHS = ("llama3.2-1b", "qwen3-14b")      # dense, and dense with qk-norm
MOE = "phi3.5-moe-42b-a6.6b"               # moe (GQA): loss + 0.01 * aux
ENCDEC = "seamless-m4t-medium"             # encdec: the batch has frames
SSM = "rwkv6-1.6b"                         # ssm: the WKV6 scan
VLM = "paligemma-3b"                       # vlm: the batch has patches
NEW_FAMILIES = (ENCDEC, SSM, VLM)
LOSS_ARCHS = ARCHS + (MOE,) + NEW_FAMILIES


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------- attention

ATTN_CASES = {                  # B, Sq, Sk, H, KVH, hd, causal, prefix
    "causal_g4": (2, 9, 9, 8, 2, 16, True, 0),
    "prefix": (1, 11, 11, 4, 1, 8, True, 4),
    "non_causal": (2, 5, 7, 4, 2, 8, False, 0),
    "g8_prefix": (2, 13, 13, 8, 1, 16, True, 5),    # paligemma's G = 8
}


def _attn_inputs(case, seed=0):
    B, Sq, Sk, H, KVH, hd, causal, prefix = ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, Sq, H, hd), np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, KVH, hd), np.float32)
            for _ in range(2))
    return (q, k, v, do), dict(causal=causal, prefix_len=prefix)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_ops_flash_attention_grad_matches_jax_vjp(case):
    (q, k, v, do), kw = _attn_inputs(case)
    out, vjp = jax.vjp(lambda a, b, c: jax_ref.attention_ref(a, b, c, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = ops.flash_attention(*ts, **kw)
    np.testing.assert_allclose(_np(o), np.asarray(out), atol=1e-5, rtol=1e-5)
    got = torch.autograd.grad(o, ts, torch.tensor(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_lse_and_bwd_ref_match_autograd(case):
    """The plain versions of kernel 1's LSE and of its backward kernels
    against autograd of ``attention_ref`` and a float64 log-sum-exp."""
    (q, k, v, do), kw = _attn_inputs(case, seed=1)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = ref.attention_ref(*ts, **kw)
    want = torch.autograd.grad(o, ts, torch.tensor(do))
    o2, lse = ref.attention_lse_ref(*ts, **kw)
    assert torch.equal(o2, o)
    B, Sq, H, hd = q.shape
    KVH, G = k.shape[2], H // k.shape[2]
    s = np.einsum("bqkgd,bskd->bkgqs",
                  q.reshape(B, Sq, KVH, G, hd).astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(hd)
    if kw["causal"]:
        i, j = np.arange(Sq)[:, None], np.arange(k.shape[1])[None, :]
        s = np.where((i >= j) | (j < kw["prefix_len"]), s, -np.inf)
    m = s.max(-1, keepdims=True)
    lse64 = (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(B, H, Sq)
    np.testing.assert_allclose(_np(lse), lse64, atol=1e-5, rtol=1e-5)
    got = ref.attention_bwd_ref(*(t.detach() for t in ts), o.detach(), lse,
                                torch.tensor(do), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-5)


def test_attention_lse_ref_empty_rows():
    """A row with no key (Sk = 0) gets the finite sentinel, the output 0,
    and the backward zero gradients."""
    q = torch.randn(1, 3, 2, 8)
    k = v = torch.zeros(1, 0, 1, 8)
    o, lse = ref.attention_lse_ref(q, k, v, causal=True)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.equal(lse, torch.full((1, 2, 3), ref.LSE_EMPTY))
    dq, dk, dv = ref.attention_bwd_ref(q, k, v, o, lse, torch.randn_like(o))
    assert torch.equal(dq, torch.zeros_like(q)) and dk.shape == k.shape


# ------------------------------------------------------------- optimizer

def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5), np.float32) * scale,
            "b": rng.standard_normal((5,), np.float32) * scale,
            "layers": [rng.standard_normal((3, 4), np.float32) * scale
                       for _ in range(2)]}


def _to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def _to_torch(t):
    return tree_map(torch.tensor, t)


def _close_tree(got, want, tol):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0])   # clip off, clip on
def test_adamw_update_and_global_norm_match_reference(grad_scale):
    params, grads = _tree(0), _tree(1, grad_scale)
    jopt = jax_training.AdamW(lr=1e-2, grad_clip=1.0)
    opt = AdamW(lr=1e-2, grad_clip=1.0)
    jp, js = _to_jax(params), jopt.init(_to_jax(params))
    tp, ts = _to_torch(params), opt.init(_to_torch(params))
    gn = float(global_norm(_to_torch(grads)))
    assert abs(gn - float(jax_training.global_norm(_to_jax(grads)))) \
        <= 1e-6 * gn
    assert (gn > 1.0) == (grad_scale > 1)
    for i in range(3):
        scale = lr_schedule(i, warmup=2, total=10)
        jscale = jax_training.lr_schedule(i, warmup=2, total=10)
        assert abs(float(scale) - float(jscale)) <= 1e-6
        jp, js = jopt.update(_to_jax(grads), js, jp, lr_scale=jscale)
        tp, ts = opt.update(_to_torch(grads), ts, tp, lr_scale=scale)
    _close_tree(tp, jp, 1e-6)
    _close_tree(ts.mu, js.mu, 1e-6)
    _close_tree(ts.nu, js.nu, 1e-6)
    assert int(ts.step) == int(js.step) == 3


def test_lr_schedule_matches_reference():
    for step in (0, 1, 5, 10, 55, 99, 100, 150):
        got = float(lr_schedule(step, warmup=10, total=100))
        want = float(jax_training.lr_schedule(step, warmup=10, total=100))
        assert abs(got - want) <= 1e-6, step
    assert float(lr_schedule(torch.tensor(0, dtype=torch.int32),
                             warmup=10, total=100)) == 0.0


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 1e3, "ties"])
def test_compress_int8_matches_reference(scale):
    if scale == "ties":     # scale 1 exactly: halves round to even
        x = np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)
    else:
        x = np.random.default_rng(3).standard_normal(257).astype(
            np.float32) * scale
    jq, js = jax_training.compress_int8(jnp.asarray(x))
    q, s = compress_int8(torch.tensor(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert abs(float(s) - float(js)) <= 1e-7 * float(js)
    np.testing.assert_allclose(decompress_int8(q, s).numpy(),
                               np.asarray(jax_training.decompress_int8(jq, js)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", range(3))
def test_compress_int8_stochastic_error_bound(seed):
    """The reference test's bound, for stochastic rounding: within one
    quantisation step of x, and unbiased on average."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(seed))
    q, s = compress_int8(x, generator=torch.Generator().manual_seed(seed))
    err = decompress_int8(q, s) - x
    assert float(err.abs().max()) <= float(s) * (1 + 1e-6)
    assert abs(float(err.mean())) <= float(s) * 0.05


def test_unflatten_keeps_no_reference_to_its_leaves():
    """``tree.unflatten`` leaves no reference cycle behind: once its
    result is dropped, the leaves it was given (a microbatch's gradients
    in ``make_train_step``) are freed at once, without the garbage
    collector (they stayed until a collection while a recursive closure
    built the tree)."""
    import gc
    import weakref
    from repro_torch.tree import unflatten
    like = {"a": [torch.zeros(2), {"b": torch.zeros(3)}], "c": torch.zeros(1)}
    new = [torch.ones(2), torch.ones(3), torch.ones(1)]
    refs = [weakref.ref(t) for t in new]
    gc.disable()
    try:
        out = unflatten(like, new)
        assert [t.numel() for t in leaves(out)] == [2, 3, 1]
        del out, new
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 40)])
def test_synthetic_lm_equals_reference(seed, step):
    jd = JaxSyntheticLM(vocab_size=1000, seq_len=33, global_batch=3,
                        seed=seed)
    d = SyntheticLM(vocab_size=1000, seq_len=33, global_batch=3, seed=seed)
    want, got = jd.batch(step), d.batch(step)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["tokens"].dtype == torch.int64
    it = d.batches(start_step=step)
    assert torch.equal(next(it)["labels"], got["labels"])


# ---------------------------------------------------------------- models

@pytest.fixture(scope="module")
def pairs():
    """Per arch: the port's config and model, the reference's model, and
    the reference's init as numpy (fp32 smoke configs)."""
    out = {}
    for arch in LOSS_ARCHS:
        jcfg = jax_reduced(jax_get_config(arch), dtype="float32")
        cfg = reduced(get_config(arch), dtype="float32")
        jm = jax_build(jcfg)
        jparams = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
        out[arch] = cfg, build(cfg), jm, jparams
    return out


def _batch(cfg, B=4, S=16, seed=0):
    """``SyntheticLM`` tokens and labels; an encdec model's batch also
    carries frames [B, Se, d], a vlm model's patches [B, P, d], normal x
    0.02 from ``seed``."""
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S,
                        global_batch=B, seed=seed).batch(0)
    if cfg.family in ("encdec", "vlm"):
        rng = np.random.default_rng(seed)
        key = "frames" if cfg.family == "encdec" else "patches"
        batch[key] = torch.tensor(rng.standard_normal(
            (B, cfg.num_prefix_embeddings, cfg.d_model), np.float32) * 0.02)
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy().astype(
        np.float32 if v.is_floating_point() else np.int32))
        for k, v in batch.items()}


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_reference(pairs, arch):
    cfg, model, jm, jparams = pairs[arch]
    batch = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jax.tree.map(jnp.asarray, jparams), _jbatch(batch))
    params = params_from_numpy(jparams, cfg, "cpu")
    # a vlm model's patch projection is among the leaves held
    assert cfg.family != "vlm" or "frontend_proj" in params
    flat = [p.requires_grad_() for p in leaves(params)]
    loss = model.loss_fn(params, batch)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    grads = torch.autograd.grad(loss, flat)
    want = leaves(params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg,
                                    "cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)
    masked = dict(batch, loss_mask=(batch["labels"] % 3 > 0).float())
    jmasked = dict(_jbatch(batch), loss_mask=jnp.asarray(
        masked["loss_mask"].numpy()))
    assert abs(float(model.loss_fn(params, masked).detach())
               - float(jm.loss_fn(jax.tree.map(jnp.asarray, jparams),
                                  jmasked))) <= 1e-5


def test_moe_masked_loss_grads_match_reference(pairs):
    """phi3.5-moe's gradient under a ``loss_mask``: every leaf, router
    included, against ``jax.value_and_grad`` of the reference's masked
    loss (the aux loss is not masked, as there)."""
    cfg, model, jm, jparams = pairs[MOE]
    batch = _batch(cfg, seed=1)
    mask = (batch["labels"] % 3 > 0).float()
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jax.tree.map(jnp.asarray, jparams),
        dict(_jbatch(batch), loss_mask=jnp.asarray(mask.numpy())))
    params = params_from_numpy(jparams, cfg, "cpu")
    flat = [p.requires_grad_() for p in leaves(params)]
    loss = model.loss_fn(params, dict(batch, loss_mask=mask))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    grads = torch.autograd.grad(loss, flat)
    want = leaves(params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg,
                                    "cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_masked_loss_grads_match_reference(pairs, arch):
    """seamless-m4t-medium's, rwkv6-1.6b's and paligemma-3b's gradients
    under a ``loss_mask``: every leaf against ``jax.value_and_grad`` of
    the reference's masked loss."""
    cfg, model, jm, jparams = pairs[arch]
    batch = _batch(cfg, seed=1)
    mask = (batch["labels"] % 3 > 0).float()
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jax.tree.map(jnp.asarray, jparams),
        dict(_jbatch(batch), loss_mask=jnp.asarray(mask.numpy())))
    params = params_from_numpy(jparams, cfg, "cpu")
    flat = [p.requires_grad_() for p in leaves(params)]
    loss = model.loss_fn(params, dict(batch, loss_mask=mask))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    grads = torch.autograd.grad(loss, flat)
    want = leaves(params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg,
                                    "cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)


STEP_CASES = [(1, False, False), (2, False, False), (1, True, True),
              (2, True, True)]      # microbatches, compress_grads, schedule


@pytest.mark.parametrize("nm,compress,sched", STEP_CASES)
def test_train_step_matches_reference(pairs, nm, compress, sched):
    cfg, model, jm, jparams = pairs["llama3.2-1b"]
    kw = dict(num_microbatches=nm, compress_grads=compress,
              schedule=default_schedule(3, warmup=1) if sched else None)
    jkw = dict(kw, schedule=jax_training.default_schedule(3, warmup=1)
               if sched else None)
    jopt, opt = jax_training.AdamW(lr=1e-3), AdamW(lr=1e-3)
    jstep = jax.jit(jax_training.make_train_step(jm.loss_fn, jopt, **jkw))
    step = make_train_step(model.loss_fn, opt, **kw)
    jp = jax.tree.map(jnp.asarray, jparams)
    js = jopt.init(jp)
    params = params_from_numpy(jparams, cfg, "cpu")
    state = opt.init(params)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                       seed=5)
    for i in range(3):
        batch = data.batch(i)
        jp, js, jm_ = jstep(jp, js, _jbatch(batch))
        params, state, m = step(params, state, batch)
        for key in ("loss", "grad_norm", "lr_scale"):
            assert abs(float(m[key]) - float(jm_[key])) <= 1e-4 * max(
                1.0, abs(float(jm_[key]))), (i, key)
    want = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    for g, w in zip(leaves(params), leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)


def test_moe_train_step_matches_reference(pairs):
    """One phi3.5-moe train step at 2 microbatches against the
    reference's ``make_train_step``: metrics and every parameter. Both
    optimizers take eps 1e-6: AdamW's first update is g / (|g| + eps),
    and expert weights that few tokens reach get gradients near 1e-8,
    where the default eps 1e-8 turns the two packages' fp32 roundings of
    the gradient (within 5e-8 of each other) into parameter differences
    of up to the learning rate."""
    cfg, model, jm, jparams = pairs[MOE]
    jopt = jax_training.AdamW(lr=1e-3, eps=1e-6)
    opt = AdamW(lr=1e-3, eps=1e-6)
    jstep = jax.jit(jax_training.make_train_step(jm.loss_fn, jopt,
                                                 num_microbatches=2))
    step = make_train_step(model.loss_fn, opt, num_microbatches=2)
    jp = jax.tree.map(jnp.asarray, jparams)
    params = params_from_numpy(jparams, cfg, "cpu")
    batch = _batch(cfg, seed=2)
    jp, _, jm_ = jstep(jp, jopt.init(jp), _jbatch(batch))
    params, _, m = step(params, opt.init(params), batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm_[key])) <= 1e-4 * max(
            1.0, abs(float(jm_[key]))), key
    want = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    for g, w in zip(leaves(params), leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_family_train_step_matches_reference(pairs, arch):
    """One train step of seamless-m4t-medium and paligemma-3b (frames or
    patches in the batch, split with the tokens over 2 microbatches) and
    of rwkv6-1.6b against the reference's ``make_train_step``: metrics and
    every parameter."""
    cfg, model, jm, jparams = pairs[arch]
    jopt, opt = jax_training.AdamW(lr=1e-3), AdamW(lr=1e-3)
    jstep = jax.jit(jax_training.make_train_step(jm.loss_fn, jopt,
                                                 num_microbatches=2))
    step = make_train_step(model.loss_fn, opt, num_microbatches=2)
    jp = jax.tree.map(jnp.asarray, jparams)
    params = params_from_numpy(jparams, cfg, "cpu")
    batch = _batch(cfg, seed=2)
    jp, _, jm_ = jstep(jp, jopt.init(jp), _jbatch(batch))
    params, _, m = step(params, opt.init(params), batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm_[key])) <= 1e-4 * max(
            1.0, abs(float(jm_[key]))), key
    want = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    for g, w in zip(leaves(params), leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)


def test_microbatching_matches_full_batch(pairs):
    """The reference test's anchor: accumulated microbatch gradients give
    the full batch's update."""
    cfg, model, _, jparams = pairs["llama3.2-1b"]
    opt = AdamW(lr=1e-3)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16,
                        global_batch=8).batch(0)
    out = {}
    for nm in (1, 4):
        params = params_from_numpy(jparams, cfg, "cpu")
        out[nm] = make_train_step(model.loss_fn, opt, num_microbatches=nm)(
            params, opt.init(params), batch)
    assert abs(float(out[1][2]["loss"]) - float(out[4][2]["loss"])) <= \
        1e-5 * float(out[1][2]["loss"])
    for a, b in zip(leaves(out[1][0]), leaves(out[4][0])):
        assert float((a - b).abs().max()) < 1e-4


def test_loss_decreases_over_steps():
    """The reference test's anchor at its smoke config (bf16): a reduced
    model learns the synthetic bigram structure, by its margin of 0.3, in
    20 of its 30 steps."""
    cfg = reduced(get_config("llama3.2-1b"))
    model = build(cfg)
    params = model.init_params(torch.Generator().manual_seed(1))
    opt = AdamW(lr=3e-3)
    state = opt.init(params)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                       seed=1)
    step = make_train_step(model.loss_fn, opt, num_microbatches=2,
                           schedule=default_schedule(60, warmup=5))
    losses = []
    for i in range(20):
        params, state, m = step(params, state, data.batch(i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.3, losses[::5]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b"])
def test_loss_fn_refuses_other_families(arch):
    """Training that is not ported raises: the moe family's MLA model
    (q/k 192 over v 128, widths kernel 1's backward does not take). (The
    hybrid trains: ``tests/test_torch_hybrid_training.py``; the vlm
    family here.)"""
    cfg = reduced(get_config(arch), dtype="float32")
    model = build(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="not ported"):
        model.loss_fn(params, _batch(cfg, B=1, S=4))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "paligemma-3b"])
def test_train_loop_refuses_frames_and_patches(arch):
    """``launch/train.py`` trains on ``SyntheticLM`` batches, which carry
    no frames or patches (nor do the reference trainer's): the encdec
    and vlm families are refused with a ValueError before any step, by
    ``train_loop`` and by the command line."""
    from repro_torch.launch.train import main, train_loop
    with pytest.raises(ValueError, match="SyntheticLM has no frames"):
        train_loop(arch=arch, steps=1, global_batch=1, seq_len=4,
                   device="cpu", log_every=0)
    with pytest.raises(SystemExit):
        main(["--arch", arch, "--device", "cpu", "--steps", "1"])


@pytest.mark.parametrize("arch,d_model,ok", [
    ("rwkv6-1.6b", None, True), ("rwkv6-1.6b", 64, True),
    ("rwkv6-1.6b", 512, False), ("llama3.2-1b", 64, False),
    ("seamless-m4t-medium", None, True), ("zamba2-7b", None, True),
    ("zamba2-7b", 448, True), ("zamba2-7b", 768, False),
    ("paligemma-3b", None, True), ("llama3.2-1b", 1024, True),
    ("llama3.2-1b", 768, False)])
def test_backward_head_dims_follow_the_family(arch, d_model, ok):
    """``train_config`` on the card checks the head dims of the family's
    own backward kernels: kernel 7-bwd's (16, 64) for the ssm family,
    kernel 1-bwd's (64, 112, 128, 256) for attention, the hybrid's shared
    attention at hd 112 and paligemma-3b's hd 256 included (``--d-model
    768`` gives 192, refused). The rule is checked here from the configs
    (``train_config`` itself needs a card)."""
    from repro_torch.launch.serve import full_width_config
    from repro_torch.launch.train import backward_head_dims
    cfg = (full_width_config(arch) if d_model is None else
           reduced(get_config(arch), d_model=d_model, head_dim=None))
    dims = backward_head_dims(cfg)
    assert dims == ((16, 64) if cfg.family == "ssm" else
                    (64, 112, 128, 256))
    assert (cfg.resolved_head_dim in dims) is ok


@pytest.mark.parametrize("arch", ARCHS)
def test_default_lr_follows_the_width(arch):
    """``launch/train.py`` trains a published width at ``FULL_WIDTH_LR``
    (llama3.2-1b whole spikes its loss at 1e-4 and above) and a reduced
    config, by the smoke rule or ``--d-model``, at the reference's
    ``SMOKE_LR``; an explicit ``lr`` wins."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import (FULL_WIDTH_LR, SMOKE_LR,
                                          default_lr, train_config,
                                          train_loop)
    assert (FULL_WIDTH_LR, SMOKE_LR) == (3e-5, 3e-3)
    assert default_lr(get_config(arch)) == FULL_WIDTH_LR
    assert default_lr(smoke_config(arch)) == SMOKE_LR
    assert default_lr(train_config(arch, "cpu", d_model=256)) == SMOKE_LR
    kw = dict(arch=arch, steps=1, global_batch=1, seq_len=4, device="cpu",
              log_every=0)
    assert train_loop(**kw)["lr"] == SMOKE_LR
    assert train_loop(lr=1e-4, **kw)["lr"] == 1e-4
