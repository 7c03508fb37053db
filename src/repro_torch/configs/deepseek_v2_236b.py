"""deepseek-v2-236b — MLA (kv_lora=512) + 2 shared / 160 routed top-6 MoE.

[arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # MLA: latent cache shared by all heads
    d_ff=1536,                 # per-expert hidden per the assignment
    vocab_size=102400,
    num_experts=160,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1536,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    rope_theta=10000.0,
    source="arXiv:2405.04434",
)
