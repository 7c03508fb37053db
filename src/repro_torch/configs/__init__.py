"""Architecture registry of the port: every family of the reference (dense,
with and without qk-norm, moe with GQA or MLA attention, ssm, hybrid,
encdec and vlm), plus the reduced smoke configs.
``PAPER_MODEL`` is the paper's own model, which the co-sim's lookup table
is built from; it is a configuration only, never served."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.deepseek_7b import CONFIG as deepseek_7b
from repro_torch.configs.deepseek_v2_236b import CONFIG as deepseek_v2_236b
from repro_torch.configs.llama31_70b import CONFIG as llama31_70b
from repro_torch.configs.llama32_1b import CONFIG as llama32_1b
from repro_torch.configs.llama3_8b import CONFIG as llama3_8b
from repro_torch.configs.paligemma_3b import CONFIG as paligemma_3b
from repro_torch.configs.phi35_moe_42b import CONFIG as phi35_moe_42b
from repro_torch.configs.qwen3_14b import CONFIG as qwen3_14b
from repro_torch.configs.rwkv6_1b6 import CONFIG as rwkv6_1b6
from repro_torch.configs.seamless_m4t_medium import (
    CONFIG as seamless_m4t_medium)
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b

PAPER_MODEL: ModelConfig = llama31_70b

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [llama32_1b, phi35_moe_42b, rwkv6_1b6, llama3_8b,
                        qwen3_14b, deepseek_7b, seamless_m4t_medium,
                        paligemma_3b, deepseek_v2_236b, zamba2_7b]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    return reduced(get_config(name))


__all__ = ["ModelConfig", "ARCHS", "PAPER_MODEL", "get_config",
           "smoke_config", "reduced"]
