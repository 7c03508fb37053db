"""Public model API: one ``Model`` bundle per architecture.

``build(cfg)`` returns a bundle exposing::

    init_params(generator)            -> params (on generator.device)
    prefill_fn(params, inputs)        -> (logits, cache)
    extend_fn(params, inputs, cache)  -> (logits, cache)   cache in place
    decode_fn(params, inputs, cache)  -> (logits, cache)   cache in place

``build(cfg, reference=True)`` runs attention through the plain PyTorch
versions of the kernels on any device: the oracle path that the card's
kernel path is held against.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable
    prefill_fn: Callable
    extend_fn: Callable
    decode_fn: Callable


def build(cfg: ModelConfig, *, reference: bool = False) -> Model:
    if cfg.family != "dense" or cfg.qk_norm or cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA family is ported so far")
    return Model(
        cfg=cfg,
        init_params=functools.partial(T.init_params, cfg),
        prefill_fn=functools.partial(T.prefill_fn, cfg, reference=reference),
        extend_fn=functools.partial(T.extend_fn, cfg, reference=reference),
        decode_fn=functools.partial(T.decode_fn, cfg, reference=reference),
    )
