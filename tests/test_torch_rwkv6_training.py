"""The ssm family's training path (kernel 7's backward) on the CPU.

Kernel 7-bwd has a plain version, ``ref.wkv6_chunked_bwd_ref`` (explicit
formulas from the forward's chunk-start states), which the card's kernel
is held against; here it is held against autograd of
``ref.wkv6_chunked_ref`` and against ``jax.vjp`` of the reference's
``repro.models.rwkv6.wkv6_chunked``, and ``ops.wkv6``'s gradients on the
CPU (autograd of the plain chunked form) against ``jax.vjp`` too; its
dS pass (``ref.wkv6_bwd_ds_ref``) against the dS the single-loop form
carried, bit for bit. Cases cover a ragged last chunk, a nonzero state0
and final-state gradient, the decay clamp (logw -1.5, where 32 tokens
reach e^{+-48}) and logw near ``LOG_W_MAX`` (-1e-6). Tolerance 1e-5
(abs + rel) within the port: the same fp32 products summed in another
order; against XLA's, 1e-5 of each gradient's largest magnitude (its
CPU dots sum the head dim's 64 products in another blocking: up to
1.5e-6 of the largest).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jax_rwkv6
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as W6

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_XLA = 1e-5

# B, S, H, hd, logw (None: U(-1.5, 0)), nonzero state0, nonzero dstate
BWD_CASES = {
    "ragged": (2, 33, 3, 16, None, True, True),
    "clamp": (1, 70, 2, 16, -1.5, True, False),
    "near_zero_decay": (1, 40, 2, 16, -1e-6, True, True),
    "one_token": (2, 1, 2, 16, None, True, True),
    "zero_state": (2, 5, 2, 16, None, False, False),
    "hd64": (1, 64, 1, 64, None, True, True),
}


def _inputs(case, seed=0):
    """r/k/v/logw [B,S,H,hd], u [H,hd], state0 [B,H,hd,hd], dout and
    dstate (None when the case has none), numpy fp32."""
    B, S, H, hd, logw, s0, ds = BWD_CASES[case]
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd), np.float32) * 0.5
               for _ in range(3))
    w = (-rng.uniform(0.0, 1.5, (B, S, H, hd)).astype(np.float32)
         if logw is None else np.full((B, S, H, hd), logw, np.float32))
    w = np.minimum(w, np.float32(-1e-6))
    u = rng.standard_normal((H, hd), np.float32) * 0.3
    st = rng.standard_normal((B, H, hd, hd), np.float32) * 0.1
    if not s0:
        st = np.zeros_like(st)
    dout = rng.standard_normal((B, S, H, hd), np.float32)
    dstate = (rng.standard_normal((B, H, hd, hd), np.float32) if ds
              else None)
    return (r, k, v, w, u, st), dout, dstate


def _autograd(ins, dout, dstate, fn):
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    out, state = fn(*ts)
    outs, cots = [out], [torch.tensor(dout)]
    if dstate is not None:
        outs.append(state)
        cots.append(torch.tensor(dstate))
    return torch.autograd.grad(outs, ts, cots)


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_wkv6_chunked_bwd_ref_equals_autograd(case):
    ins, dout, dstate = _inputs(case)
    want = _autograd(ins, dout, dstate, ref.wkv6_chunked_ref)
    ts = [torch.tensor(a) for a in ins]
    out, state, states = ref.wkv6_chunked_ref(*ts, chunk_states=True)
    got = ref.wkv6_chunked_bwd_ref(
        *ts, states, torch.tensor(dout),
        None if dstate is None else torch.tensor(dstate))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, **TOL)


def _carried_ds(r, logw, dout, dstate, chunk=32):
    """The dS that the single-loop backward carried: walking the chunks in
    reverse, dS at each chunk's end as the loop reached it, then the dS
    it ended with (dstate0)."""
    B, S, H, hd = r.shape
    dS = torch.zeros((B, H, hd, hd)) if dstate is None else dstate
    seen = {}
    for i in reversed(range(-(-S // chunk))):
        seen[i] = dS
        sl = slice(i * chunk, min((i + 1) * chunk, S))
        c = torch.cumsum(logw[:, sl], dim=1)
        A = r[:, sl] * torch.exp(c - logw[:, sl])
        dS = (torch.exp(c[:, -1])[..., None] * dS
              + torch.einsum("bthk,bthv->bhkv", A, dout[:, sl]))
    return [seen[i] for i in range(len(seen))], dS


@pytest.mark.parametrize("case", ["ragged", "clamp", "one_token",
                                  "zero_state"])
def test_wkv6_bwd_ds_ref_is_the_carried_ds(case):
    """The plain dS pass (``ref.wkv6_bwd_ds_ref``, what kernel 7-bwd's
    local and scan passes compute) gives bit for bit the dS the
    single-loop form carried at each chunk's end, the final state's
    gradient as its last entry, and dstate0 as the dS that loop ended
    with, which ``wkv6_chunked_bwd_ref`` returns: a ragged S (33, 70),
    the clamp (-1.5) and a zero final-state gradient."""
    ins, dout, dstate = _inputs(case, seed=5)
    r, logw = torch.tensor(ins[0]), torch.tensor(ins[3])
    dout = torch.tensor(dout)
    dstate = None if dstate is None else torch.tensor(dstate)
    ds, dstate0 = ref.wkv6_bwd_ds_ref(r, logw, dout, dstate)
    want, want0 = _carried_ds(r, logw, dout, dstate)
    B, S, H, hd = r.shape
    assert ds.shape == (B, W6.n_chunks(S), H, hd, hd)
    assert dstate0.shape == (B, H, hd, hd)
    for i, w in enumerate(want):
        assert torch.equal(ds[:, i], w), i
    assert torch.equal(ds[:, -1], torch.zeros_like(dstate0)
                       if dstate is None else dstate)
    assert torch.equal(dstate0, want0)
    ts = [torch.tensor(a) for a in ins]
    _, _, states = ref.wkv6_chunked_ref(*ts, chunk_states=True)
    assert torch.equal(ref.wkv6_chunked_bwd_ref(*ts, states, dout,
                                                dstate)[5], dstate0)


@pytest.mark.parametrize("S", [1, 32, 70])
def test_chunk_states_are_the_prefix_states(S):
    """The state at chunk i's start is the final state of the first 32 i
    tokens (the same chunks, bit for bit); the first is state0."""
    ins, _, _ = _inputs("clamp")
    ts = [torch.tensor(a) for a in ins]
    ts[:4] = [t[:, :S] for t in ts[:4]]
    out, state, states = ref.wkv6_chunked_ref(*ts, chunk_states=True)
    assert states.shape == (1, -(-S // 32), 2, 16, 16)
    assert torch.equal(states[:, 0], ts[5])
    for i in range(1, states.shape[1]):
        pre = [t[:, :32 * i] for t in ts[:4]] + ts[4:]
        assert torch.equal(states[:, i], ref.wkv6_chunked_ref(*pre)[1])
    assert torch.equal(out, ref.wkv6_chunked_ref(*ts)[0])


def _jax_vjp(ins, dout, dstate):
    (out, state), vjp = jax.vjp(jax_rwkv6.wkv6_chunked,
                                *(jnp.asarray(a) for a in ins))
    ds = np.zeros(state.shape, np.float32) if dstate is None else dstate
    return vjp((jnp.asarray(dout), jnp.asarray(ds)))


@pytest.mark.parametrize("case", ["hd64", "clamp"])
def test_ops_wkv6_grads_match_jax_vjp(case):
    """``ops.wkv6`` on CPU tensors (the plain chunked form, autograd):
    the gradients of all six inputs against ``jax.vjp`` of the
    reference's ``wkv6_chunked``, at S a multiple of its chunk; and the
    plain backward against the same."""
    ins, dout, dstate = _inputs(case, seed=3)
    S = ins[0].shape[1] // 32 * 32
    ins = tuple(a[:, :S] for a in ins[:4]) + ins[4:]
    dout = dout[:, :S]
    want = _jax_vjp(ins, dout, dstate)
    got = _autograd(ins, dout, dstate, ops.wkv6)
    ts = [torch.tensor(a) for a in ins]
    _, _, states = ref.wkv6_chunked_ref(*ts, chunk_states=True)
    plain = ref.wkv6_chunked_bwd_ref(
        *ts, states, torch.tensor(dout),
        None if dstate is None else torch.tensor(dstate))
    for g, p, w in zip(got, plain, want):
        w = np.asarray(w)
        tol = dict(atol=TOL_XLA * np.abs(w).max(), rtol=TOL_XLA)
        np.testing.assert_allclose(g.numpy(), w, **tol)
        np.testing.assert_allclose(p.numpy(), w, **tol)


def test_wkv6_fn_refuses_what_it_does_not_take():
    """``WKV6Fn`` has no fallback: a head dim kernel 7-bwd is not built
    for, or CPU tensors, raise; ``ops.wkv6`` sends CPU tensors to the
    plain version instead."""
    ins, _, _ = _inputs("zero_state")
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    with pytest.raises(ValueError, match="CUDA tensors"):
        W6.WKV6Fn.apply(*ts)
    wide = [torch.zeros(1, 4, 1, 32, requires_grad=True) for _ in range(4)]
    with pytest.raises(ValueError, match="kernel 7-bwd is built for"):
        W6.WKV6Fn.apply(*wide, torch.zeros(1, 32), torch.zeros(1, 1, 32, 32))
    assert W6.BWD_HEAD_DIMS == W6.HEAD_DIMS == (16, 64)
    out, _ = ops.wkv6(*ts)
    assert out.grad_fn is not None


def test_wkv6_bwd_entries_refuse_cpu_tensors():
    """Kernel 7-bwd's entries take CUDA tensors only (no fallback to the
    plain version): the whole backward, its dS pass alone and the pass
    timers raise on CPU tensors; the passes run in this order."""
    ins, dout, dstate = _inputs("ragged")
    ts = [torch.tensor(a) for a in ins]
    _, _, states = ref.wkv6_chunked_ref(*ts, chunk_states=True)
    dout, dstate = torch.tensor(dout), torch.tensor(dstate)
    with pytest.raises(ValueError, match="CUDA tensors"):
        W6.wkv6_bwd(*ts[:5], states, dout, dstate)
    with pytest.raises(ValueError, match="CUDA tensors"):
        W6.wkv6_bwd_ds(ts[0], ts[3], dout, dstate)
    with pytest.raises(ValueError, match="CUDA tensors"):
        W6.bwd_pass_timers(*ts[:5], states, dout, dstate)
    assert W6.PASSES == ("local", "scan", "chunk", "du")


def test_rwkv6_trains_through_train_loop_on_the_cpu():
    """``launch/train.py`` trains the ssm family: rwkv6-1.6b's smoke
    config, 3 steps, finite losses."""
    from repro_torch.launch.train import train_loop
    out = train_loop(arch="rwkv6-1.6b", steps=3, global_batch=2, seq_len=40,
                     device="cpu", log_every=0)
    assert out["cfg"].family == "ssm" and out["steps_run"] == 3
    assert np.isfinite(out["losses"]).all()
