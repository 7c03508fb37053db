"""paligemma-3b — gemma decoder backbone, SigLIP frontend STUB (MQA kv=1).

The vision frontend is a stub: the decoder takes precomputed patch
embeddings ``patches`` [B, 256, d_model] (the serving engine feeds zeros)
as a bidirectional prefix before the text.

[arXiv:2407.07726; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    frontend="siglip_stub",
    num_prefix_embeddings=256,  # 16x16 patches from the (stubbed) SigLIP tower
    rope_theta=10000.0,
    tie_embeddings=True,
    source="arXiv:2407.07726",
)
