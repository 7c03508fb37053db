"""The train step: microbatched gradients, compression, the optimizer.

Port of ``repro/training/train_step.py``, without its ``grad_spec`` (a
sharding constraint; sharding comes with the port's ``distributed/``).
``make_train_step`` builds ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``:

  * **microbatch gradient accumulation**: the global batch is split into
    ``num_microbatches`` slices, each one's gradient added into an fp32
    accumulator, the sum divided by their count and the losses averaged,
    as the reference's ``scan``; one microbatch takes the gradient in the
    parameters' dtype, as there;
  * **gradient compression** (``compress_grads``): each gradient through
    int8 and back (``compression.py``), one absmax scale per tensor of the
    reference's tree: a weight's copies in the layer list share one, as
    the reference stacks them into one [L, ...] leaf (``_compress``);
  * ``schedule(opt_state.step)`` scales the learning rate.

The gradient is autograd's: on the card the attention's backward is kernel
1's backward kernels (``kernels.flash_attention.FlashAttentionFn``).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.training.compression import compress_int8, decompress_int8
from repro_torch.training.optimizer import AdamW, AdamWState, global_norm
from repro_torch.training.optimizer import lr_schedule
from repro_torch.tree import leaves, tree_map, unflatten


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): ``loss_fn(params, batch)`` and its gradient, a tree
    like ``params`` in their dtypes. The parameters themselves are not
    marked as requiring grad: the loss runs on detached aliases."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(params, grads)


def _compress(grads):
    """The int8 round trip of every gradient, one scale per leaf of the
    reference's tree: a list of layer dicts is stacked leaf by leaf
    first."""
    def round_trip(g):
        return decompress_int8(*compress_int8(g))

    if isinstance(grads, dict):
        return {k: _compress(v) for k, v in grads.items()}
    if isinstance(grads, list) and grads and isinstance(grads[0], dict):
        stacked = tree_map(lambda *gs: round_trip(torch.stack(gs)),
                           grads[0], *grads[1:])
        return [tree_map(lambda g: g[i], stacked) for i in range(len(grads))]
    if isinstance(grads, (list, tuple)):
        return type(grads)(_compress(g) for g in grads)
    return round_trip(grads)


def make_train_step(loss_fn: Callable, opt: AdamW, *,
                    num_microbatches: int = 1, compress_grads: bool = False,
                    schedule: Optional[Callable] = None):
    """Build ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. ``loss_fn(params, batch) -> scalar``; ``batch`` leaves are
    [B, ...] with B % num_microbatches == 0. ``metrics``: ``loss``,
    ``grad_norm`` and ``lr_scale`` (fp32 scalar tensors)."""

    def step(params, opt_state: AdamWState, batch: dict):
        if num_microbatches <= 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % num_microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{num_microbatches} microbatches")
            mb = B // num_microbatches
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            losses = []
            for i in range(num_microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss_i, g_i = value_and_grad(loss_fn, params, part)
                tree_map(lambda a, g: a.add_(g), acc, g_i)
                losses.append(loss_i.float())
                del g_i
            grads = tree_map(lambda a: a.div_(num_microbatches), acc)
            loss = torch.stack(losses).mean()

        if compress_grads:
            grads = _compress(grads)

        lr_scale = (schedule(opt_state.step) if schedule is not None
                    else torch.tensor(1.0))
        lr_scale = torch.as_tensor(lr_scale, dtype=torch.float32)
        metrics = {"loss": loss, "grad_norm": global_norm(grads),
                   "lr_scale": lr_scale}
        new_params, new_state = opt.update(grads, opt_state, params,
                                           lr_scale=lr_scale)
        return new_params, new_state, metrics

    return step


def default_schedule(total_steps: int, warmup: int = 100):
    return functools.partial(lr_schedule, warmup=warmup, total=total_steps)
