"""The MoE family's training path against autograd and the reference
package, on the CPU.

Kernel 6's backward has a plain version, ``ref.expert_matmul_bwd_ref``,
which the card's dX and dW kernels are held against; here it is held
against autograd of ``ref.expert_matmul_ref`` at fills 0, 1, ragged and C
with ragged D and F (1e-6: the same fp32 products), and its dX is zero
past each expert's fill. ``moe_block``'s gradient through the plain path
(buckets, three GEMMs, the weighted combine, the router and its aux loss)
is held against ``jax.vjp`` of the reference's compute-every-expert
``moe_dense_ref`` at 1e-5 (the same fp32 products summed in another
order), with and without a shared expert, at top-2 and at top-3 (k > 2).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import phi35_moe_42b as jax_phi
from repro.configs.base import reduced as jax_reduced
from repro.models import moe as jax_moe
from repro_torch.configs import phi35_moe_42b, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import moe

TOL = dict(atol=1e-5, rtol=1e-5)

# E, C, D, F, fill (None: every row live)
BWD_CASES = {
    "fill_0": (3, 9, 20, 13, [0, 0, 0]),
    "fill_1": (3, 9, 20, 13, [1, 1, 1]),
    "ragged": (4, 11, 21, 30, [0, 1, 7, 11]),
    "full": (2, 8, 24, 17, [8, 8]),
    "default": (2, 5, 7, 9, None),
}


def _bwd_inputs(case, seed=0):
    E, C, D, F, fill = BWD_CASES[case]
    g = torch.Generator().manual_seed(seed)
    xe = torch.randn((E, C, D), generator=g)
    w = torch.randn((E, D, F), generator=g) / D ** 0.5
    dy = torch.randn((E, C, F), generator=g)
    f = None if fill is None else torch.tensor(fill, dtype=torch.int32)
    return xe, w, f, dy


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_expert_matmul_bwd_ref_equals_autograd(case):
    xe, w, fill, dy = _bwd_inputs(case)
    a, b = xe.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(ref.expert_matmul_ref(a, b, fill), (a, b), dy)
    got = ref.expert_matmul_bwd_ref(xe, w, fill, dy)
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and g_.dtype == w_.dtype
        torch.testing.assert_close(g_, w_, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", ["fill_0", "fill_1", "ragged"])
def test_expert_matmul_bwd_ref_zero_past_fill(case):
    """dX past an expert's fill is zero (its output rows are constants);
    an expert with fill 0 gets a zero dW."""
    xe, w, fill, dy = _bwd_inputs(case, seed=1)
    dxe, dw = ref.expert_matmul_bwd_ref(xe, w, fill, dy)
    rows = torch.arange(xe.shape[1])[None, :]
    assert not dxe[rows.expand(len(fill), -1) >= fill[:, None].long()].any()
    assert not dw[fill == 0].any()
    assert dxe[rows.expand(len(fill), -1) < fill[:, None].long()].any() \
        == bool(fill.any())


def test_ops_expert_matmul_differentiates_on_the_cpu():
    """``ops.expert_matmul`` on CPU tensors is the plain version, which
    autograd differentiates to ``expert_matmul_bwd_ref``'s gradient."""
    xe, w, fill, dy = _bwd_inputs("ragged", seed=2)
    a, b = xe.clone().requires_grad_(), w.clone().requires_grad_()
    got = torch.autograd.grad(ops.expert_matmul(a, b, fill), (a, b), dy)
    for g_, w_ in zip(got, ref.expert_matmul_bwd_ref(xe, w, fill, dy)):
        torch.testing.assert_close(g_, w_, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("body,E,rows,cols,ok", [
    ("wgmma", 16, 4096, 6400, True),
    ("wgmma", 160, 2 ** 16, 2 ** 16, True),       # 160 x 2^17 tiles
    ("wgmma", 2 ** 14, 2 ** 16, 2 ** 16, False),  # 2^31 tiles
    ("mma.sync", 65535, 128 * 65535, 8, True),
    ("mma.sync", 65536, 128, 8, False),
    ("mma.sync", 1, 128 * 65535 + 1, 8, False),
    ("fma", 1, 64 * 65535, 8, True),
    ("fma", 1, 64 * 65535 + 1, 8, False)])
def test_expert_matmul_bwd_grid_limits(body, E, rows, cols, ok):
    """The wrapper's grid check per body of kernel 6's backward (no card
    needed): the persistent wgmma body numbers its 128 x 256 tiles in an
    int; the mma.sync and FMA bodies put E in grid z and their 128- and
    64-row tiles in y, each at most 65535."""
    from repro_torch.kernels import expert_matmul as EM
    assert EM._grid_ok(body, E, rows, cols) is ok


@pytest.mark.parametrize("shared,k", [(0, 2), (1, 2), (0, 3)],
                         ids=["top2", "shared", "top3"])
def test_moe_block_grad_matches_jax_vjp(shared, k):
    """The port's bucketed ``moe_block`` differentiated by autograd
    against ``jax.vjp`` of ``moe_dense_ref``: the gradient of x and of
    every weight (router, expert stacks, shared expert) for cotangents of
    both the output and the aux loss."""
    kw = dict(dtype="float32", num_shared_experts=shared,
              experts_per_token=k)
    jcfg = jax_reduced(jax_phi, **kw)
    cfg = reduced(phi35_moe_42b, **kw)
    jp = jax_moe.moe_params(jax.random.key(3), jcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, cfg.d_model), np.float32)
    dy = rng.standard_normal(x.shape, np.float32)
    daux = np.float32(0.7)
    (want_y, want_aux), vjp = jax.vjp(
        lambda p, a: jax_moe.moe_dense_ref(jcfg, p, a), jp, jnp.asarray(x))
    want_dp, want_dx = vjp((jnp.asarray(dy), jnp.asarray(daux)))

    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(),
                     jp)
    xt = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe_block(cfg, p, xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), **TOL)
    flat, tree = jax.tree.flatten(p)
    grads = torch.autograd.grad((y, aux), [xt, *flat],
                                (torch.tensor(dy), torch.tensor(daux)))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_dx), **TOL)
    want_flat = jax.tree.leaves(want_dp)
    assert len(want_flat) == len(flat) == (7 if shared else 4)
    for g_, w_ in zip(grads[1:], want_flat):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)
