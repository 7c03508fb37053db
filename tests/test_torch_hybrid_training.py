"""Training the hybrid family (zamba2-7b) against the reference, on the CPU.

``reduced(zamba2-7b, dtype="float32")`` at 4 layers (2 groups of the
shared attention + MLP block with the group's LoRA delta, then 2 Mamba2
layers) and at 5 (a tail layer), with ``lora_b`` (zero in the reference's
init), ``A_log``, ``dt_bias`` and ``conv_b`` perturbed to seeded nonzero
values on both sides, as ``tests/test_torch_hybrid.py`` does, so that the
LoRA leaves get gradients and the decay clamp is exercised. Batches of 64
tokens, two 32-token SSD chunks.

Tolerances, each with its reason: the loss and every gradient leaf 1e-4
(the same fp32 math through 2 groups of attention and 4-5 recurrent
layers, sums in another order), a train step at 2 microbatches 1e-4 (the
gradients' 1e-4 through AdamW, whose update the learning rate bounds);
kernel 1's plain backward at hd 112 1e-5 (the same fp32 math as
``jax.vjp``); the chunked SSD against the token-serial update 1e-4.

The chunked SSD's products are two-operand einsums: with
``opt_einsum`` off, as on a machine without the package, torch contracts
a three-operand einsum left to right, and the reference's inter-chunk
form would build a [B, n, C, H, P, N] tensor (7.5 GB a layer at
zamba2-7b's width and 4096 tokens). One test records every op's
outputs, forward and backward, and finds none that large.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import training as jax_training
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.kernels import ref as jax_ref
from repro.models.api import build as jax_build
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ref
from repro_torch.models import mamba2 as M2
from repro_torch.models.api import build
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import AdamW, make_train_step
from repro_torch.tree import leaves

ARCH = "zamba2-7b"
PERTURBED = ("lora_b", "A_log", "dt_bias", "conv_b")
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(t):
    return t.detach().float().numpy()


@functools.cache
def _pair(layers: int):
    """Both packages' models and weights (the perturbed leaves equal on
    both sides)."""
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
    return SimpleNamespace(cfg=cfg, jm=jm, tree=tree, model=build(cfg))


@pytest.fixture(scope="module", params=[4, 5], ids=["L4", "L5-tail"])
def pair(request):
    return _pair(request.param)


def _batch(cfg, B=2, S=64, seed=0, masked=False):
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S,
                        global_batch=B, seed=seed).batch(0)
    if masked:
        batch["loss_mask"] = (batch["labels"] % 3 > 0).float()
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy().astype(
        np.float32 if v.is_floating_point() else np.int32))
        for k, v in batch.items()}


def test_grouping_has_groups_and_a_tail():
    """The two depths cover both shapes of the stack: 2 groups of 2, and
    the same with a tail layer."""
    from repro_torch.models.transformer import _zamba_grouping
    assert _zamba_grouping(_pair(4).cfg) == (2, 2, 0)
    assert _zamba_grouping(_pair(5).cfg) == (2, 2, 1)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_loss_and_grads_match_reference(pair, masked):
    """``loss_fn`` and every gradient leaf (the shared block's, summed
    over the groups, each group's LoRA slice, every Mamba2 layer's)
    against ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    f = pair
    batch = _batch(f.cfg, seed=int(masked), masked=masked)
    jloss, jgrads = jax.jit(jax.value_and_grad(f.jm.loss_fn))(
        jax.tree.map(jnp.asarray, f.tree), _jbatch(batch))
    params = params_from_numpy(f.tree, f.cfg, "cpu")
    flat = [p.requires_grad_() for p in leaves(params)]
    loss = f.model.loss_fn(params, batch)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4
    grads = torch.autograd.grad(loss, flat)
    want = leaves(params_from_numpy(jax.tree.map(np.asarray, jgrads), f.cfg,
                                    "cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    lora = next(i for i, p in enumerate(flat)
                if p is params["shared"]["lora_a"])
    assert bool((grads[lora].abs().sum(dim=(1, 2)) > 0).all())   # each group


def test_train_step_matches_reference():
    """One train step at 2 microbatches, with a tail layer, against the
    reference's ``make_train_step``: metrics and every parameter. Both
    optimizers take eps 1e-6, as the MoE step's test does: AdamW's first
    update is g / (|g| + eps), and w_in entries whose gradients are 1e-9
    to 5e-7 turn the two packages' fp32 roundings into parameter
    differences of up to 4e-4 at the default eps 1e-8."""
    f = _pair(5)
    jopt = jax_training.AdamW(lr=1e-3, eps=1e-6)
    opt = AdamW(lr=1e-3, eps=1e-6)
    jstep = jax.jit(jax_training.make_train_step(f.jm.loss_fn, jopt,
                                                 num_microbatches=2))
    step = make_train_step(f.model.loss_fn, opt, num_microbatches=2)
    jp = jax.tree.map(jnp.asarray, f.tree)
    params = params_from_numpy(f.tree, f.cfg, "cpu")
    batch = _batch(f.cfg, B=4, seed=2)
    jp, _, jm_ = jstep(jp, jopt.init(jp), _jbatch(batch))
    params, _, m = step(params, opt.init(params), batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm_[key])) <= 1e-4 * max(
            1.0, abs(float(jm_[key]))), key
    want = params_from_numpy(jax.tree.map(np.asarray, jp), f.cfg, "cpu")
    for g, w in zip(leaves(params), leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_train_loop_trains_the_hybrid_on_the_cpu():
    """``launch/train.py`` trains the hybrid's smoke config on the CPU:
    finite losses, the smoke depth."""
    from repro_torch.launch.train import train_loop
    out = train_loop(arch=ARCH, steps=2, global_batch=2, seq_len=32,
                     device="cpu", log_every=0)
    assert out["cfg"].family == "hybrid" and out["steps_run"] == 2
    assert np.isfinite(out["losses"]).all()


# ------------------------------------------- kernel 1's backward at hd 112

ATTN_CASES = {                  # B, Sq, Sk, H, KVH, causal, prefix
    "causal_g1": (2, 9, 9, 2, 2, True, 0),
    "prefix_g4": (1, 11, 11, 4, 1, True, 4),
    "non_causal": (1, 5, 7, 4, 2, False, 0),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_bwd_ref_at_hd_112_matches_jax_vjp(case):
    """``ref.attention_bwd_ref`` (the plain version of kernel 1-bwd) from
    ``attention_lse_ref``'s output and LSE at zamba2's head dim, against
    ``jax.vjp`` of the reference's attention."""
    B, Sq, Sk, H, KVH, causal, prefix = ATTN_CASES[case]
    kw = dict(causal=causal, prefix_len=prefix)
    rng = np.random.default_rng(7)
    q, do = (rng.standard_normal((B, Sq, H, 112), np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, KVH, 112), np.float32)
            for _ in range(2))
    out, vjp = jax.vjp(lambda a, b, c: jax_ref.attention_ref(a, b, c, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    ts = [torch.tensor(a) for a in (q, k, v)]
    o, lse = ref.attention_lse_ref(*ts, **kw)
    np.testing.assert_allclose(_np(o), np.asarray(out), atol=1e-5, rtol=1e-5)
    got = ref.attention_bwd_ref(*ts, o, lse, torch.tensor(do), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------- chunked SSD

def _ssd_inputs(B=2, S=128, H=3, P=4, N=8, dtA=None, seed=3):
    """Seeded SSD inputs from a nonzero state; ``dtA`` sets dt * A on every
    token (3.0: past the decay clamp)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    A = rng.uniform(0.5, 1.5, H).astype(np.float32)
    if dtA is None:
        dt = rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    else:
        dt = np.broadcast_to(dtA / A, (B, S, H)).astype(np.float32).copy()
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, Bm, Cm, A, s0


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("dtA", [None, 3.0], ids=["decay", "clamp"])
def test_ssd_chunked_matches_token_serial(chunk, dtA):
    """The chunked scan against the token-serial ``ssd_decode``, from a
    nonzero state (so the inter-chunk term carries it), at chunks 32, 64
    and 128, with seeded decays and at the clamp."""
    a = _ssd_inputs(dtA=dtA)
    y, s = M2.ssd_chunked(*map(torch.tensor, a), chunk=chunk)
    st, ys = torch.tensor(a[5]), []
    for t in range(a[0].shape[1]):
        yt, st = M2.ssd_decode(*(torch.tensor(v[:, t]) for v in a[:4]),
                               torch.tensor(a[4]), st)
        ys.append(yt)
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    torch.testing.assert_close(y, torch.stack(ys, 1), **TOL)
    torch.testing.assert_close(s, st, **TOL)


class _Outputs(TorchDispatchMode):
    """Records the element count of every op's tensor outputs."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.sizes.append((t.numel(), str(func)))
        return out


def test_ssd_chunked_builds_no_six_way_tensor():
    """With ``opt_einsum`` off, no op of ``ssd_chunked``'s forward or
    backward outputs B*n*C*H*P*N elements or more (the reference's
    three-operand inter-chunk einsum forms that outer product first)."""
    B, S, H, P, N, chunk = 1, 128, 8, 16, 16, 32
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((B, S, H, P)), dtype=torch.float32,
                     requires_grad=True)
    dt = torch.tensor(rng.uniform(0.01, 0.5, (B, S, H)), dtype=torch.float32)
    Bm, Cm = (torch.tensor(rng.standard_normal((B, S, N)),
                           dtype=torch.float32, requires_grad=True)
              for _ in range(2))
    A = torch.ones(H)
    s0 = torch.zeros(B, H, P, N)
    six_way = B * (S // chunk) * chunk * H * P * N
    was = torch.backends.opt_einsum.enabled
    torch.backends.opt_einsum.enabled = False
    try:
        with _Outputs() as rec:
            y, s = M2.ssd_chunked(x, dt, Bm, Cm, A, s0, chunk=chunk)
            (y.sum() + s.sum()).backward()
    finally:
        torch.backends.opt_einsum.enabled = was
    big = [(n, f) for n, f in rec.sizes if n >= six_way]
    assert not big, big
    assert max(n for n, _ in rec.sizes) >= B * S * H * P  # it recorded
