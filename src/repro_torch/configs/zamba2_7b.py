"""zamba2-7b — Mamba2 backbone + shared attention block (hybrid).

81 Mamba2 layers; one *shared* attention(+FFN) block is invoked every 6
layers with a per-invocation LoRA delta.

[arXiv:2411.15242; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    shared_attn_every=6,
    shared_attn_lora_rank=128,
    rope_theta=10000.0,
    source="arXiv:2411.15242",
)
