"""llama3.1-70b — the PAPER'S OWN profiling/serving model (§5.1).

The model the paper profiles on H100 DGX + vLLM, so the Heron §5
experiments (goodput, tradeoff, stickiness, elasticity) build their lookup
tables against it. A configuration only: the port never serves it.

[arXiv:2407.21783; meta-llama/Llama-3.1-70B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    source="arXiv:2407.21783",
)
