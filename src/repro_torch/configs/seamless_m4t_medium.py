"""seamless-m4t-medium — encoder-decoder, audio frontend STUB.

The modality frontend is a stub: the encoder takes precomputed frame
embeddings ``frames`` [B, 160, d_model] (the serving engine feeds zeros).

[arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,             # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    frontend="audio_stub",
    num_prefix_embeddings=160,  # precomputed audio frames fed to the encoder
    rope_theta=10000.0,
    source="arXiv:2308.11596",
)
