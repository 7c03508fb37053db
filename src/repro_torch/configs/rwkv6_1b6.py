"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay WKV6.

[arXiv:2404.05892; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,              # WKV heads, head_dim 64
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    attn_free=True,
    source="arXiv:2404.05892",
)
