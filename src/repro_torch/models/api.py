"""Public model API: one ``Model`` bundle per architecture.

``build(cfg)`` returns a bundle exposing::

    init_params(generator)            -> params (on generator.device)
    loss_fn(params, batch)            -> scalar (the dense family;
                                         others raise NotImplementedError)
    prefill_fn(params, inputs)        -> (logits, cache)   (+ "frames"
                                                            for encdec,
                                                            "patches"
                                                            for vlm)
    extend_fn(params, inputs, cache)  -> (logits, cache)   cache in place
    decode_fn(params, inputs, cache)  -> (logits, cache)   cache in place

``build(cfg, reference=True)`` runs every kernel call (attention, the
expert GEMM, the WKV6 scan) through its plain PyTorch version on any
device: the oracle path that the card's kernel path is held against;
``wkv_chunk`` sets that path's WKV6 chunk (the ssm family's prefill and
extend), which changes only the order of its fp32 sums.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import WKV6_CHUNK
from repro_torch.models import transformer as T

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable
    prefill_fn: Callable
    extend_fn: Callable
    decode_fn: Callable
    loss_fn: Optional[Callable] = None


def build(cfg: ModelConfig, *, reference: bool = False,
          wkv_chunk: int = WKV6_CHUNK) -> Model:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: only the {', '.join(FAMILIES)} families are "
            "ported so far")
    return Model(
        cfg=cfg,
        init_params=functools.partial(T.init_params, cfg),
        prefill_fn=functools.partial(T.prefill_fn, cfg, reference=reference,
                                     wkv_chunk=wkv_chunk),
        extend_fn=functools.partial(T.extend_fn, cfg, reference=reference,
                                    wkv_chunk=wkv_chunk),
        decode_fn=functools.partial(T.decode_fn, cfg, reference=reference),
        loss_fn=functools.partial(T.loss_fn, cfg, reference=reference),
    )
