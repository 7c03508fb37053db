"""Model configuration dataclass and the tiny smoke-test reduction.

A copy of the reference package's ``configs/base.py`` (``ModelConfig`` and
``reduced``): the port keeps its own so that it imports nothing of the
JAX package. Configs are pure data; model construction lives in
``repro_torch.models``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    # trunk
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: Optional[int] = None  # per-expert hidden (defaults to d_ff)
    # MLA (DeepSeek-V2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # SSM / hybrid
    attn_free: bool = False          # RWKV6: no attention at all
    ssm_state: int = 0               # Mamba2 state size
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    shared_attn_every: int = 0       # Zamba2: shared attn block cadence
    shared_attn_lora_rank: int = 0   # per-invocation LoRA on shared block
    # encoder-decoder
    encoder_layers: int = 0
    # modality frontend stubs ([audio]/[vlm]): precomputed embeddings
    frontend: Optional[str] = None   # 'audio_stub' | 'siglip_stub'
    num_prefix_embeddings: int = 0   # frames / patches provided by input_specs
    # misc
    qk_norm: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    source: str = ""                 # provenance tag from the assignment

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    # -- parameter accounting (used by roofline's useful-FLOPs ratio and the
    # power/latency lookup-table generator) --
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.attn_free:
            # RWKV6 time-mix: r,k,v,g,o projections + decay/bonus params
            return 5 * d * d + 2 * d
        if self.use_mla:
            p = d * self.kv_lora_rank                                   # W_DKV
            p += self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)  # W_UK, W_UV
            p += d * self.qk_rope_head_dim                              # shared rope key
            if self.q_lora_rank:
                p += d * self.q_lora_rank
                p += self.q_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            else:
                p += d * self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            p += self.num_heads * self.v_head_dim * d                   # W_O
            return p
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        return q + kv + o

    def _ffn_params_dense(self) -> int:
        return 3 * self.d_model * self.d_ff  # SwiGLU

    def _ffn_params_expert(self) -> int:
        return 3 * self.d_model * self.resolved_moe_d_ff

    def param_count(self) -> int:
        """Total parameters (embeddings included once; tied heads counted once)."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = self._attn_params()
        if self.family == "ssm":      # RWKV: channel-mix ffn
            per_layer += 2 * d * self.d_ff + d * d
        elif self.family == "hybrid":
            # mamba2 block params
            d_in = self.ssm_expand * d
            per_layer = 2 * d * d_in + d_in * d + d_in * (2 * self.ssm_state + 8)
        elif self.is_moe:
            per_layer += self.num_experts * self._ffn_params_expert()
            per_layer += self.num_shared_experts * self._ffn_params_expert()
            per_layer += d * self.num_experts  # router
        else:
            per_layer += self._ffn_params_dense()
        total = emb + self.num_layers * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            # one shared attention+ffn block (+ tiny LoRA per invocation)
            shared = self._attn_params() + self._ffn_params_dense()
            n_inv = self.num_layers // self.shared_attn_every
            total += shared + n_inv * self.shared_attn_lora_rank * 4 * d
        if self.family == "encdec":
            # encoder stack + cross-attention in decoder
            enc = self.encoder_layers * (self._attn_params() + self._ffn_params_dense())
            cross = self.num_layers * self._attn_params()
            total += enc + cross
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (== param_count for dense)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = self._attn_params()
        per_layer += (self.experts_per_token + self.num_shared_experts) * self._ffn_params_expert()
        per_layer += d * self.num_experts
        return int(emb + self.num_layers * per_layer)

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """KV-cache bytes per generated/cached token (decode memory term)."""
        if self.attn_free:
            return 0  # recurrent state, O(1) in sequence
        if self.use_mla:
            per = self.kv_lora_rank + self.qk_rope_head_dim
            return self.num_layers * per * bytes_per_el
        hd = self.resolved_head_dim
        if self.family == "hybrid":
            n_attn = self.num_layers // max(1, self.shared_attn_every)
            return n_attn * 2 * self.num_kv_heads * hd * bytes_per_el
        n_layers = self.num_layers + (self.num_layers if self.family == "encdec" else 0)
        return n_layers * 2 * self.num_kv_heads * hd * bytes_per_el

    def matmul_param_count(self) -> int:
        """Active params that actually cost matmul FLOPs per token.

        The input embedding table is a gather (0 FLOPs); only the lm_head
        projection costs. Tied embeddings count once already (the single
        table IS the lm_head), so nothing is subtracted.
        """
        n = self.active_param_count()
        if not self.tie_embeddings:
            n -= self.vocab_size * self.d_model
        return int(n)

    def flops_per_token(self, seq_len: int, phase: str = "train") -> float:
        """Model FLOPs per token: 6·N_matmul·(1) + attention context term."""
        n = self.matmul_param_count()
        mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[phase]
        base = mult * n
        if not self.attn_free:
            n_attn = self.num_layers
            if self.family == "hybrid" and self.shared_attn_every:
                n_attn = self.num_layers // self.shared_attn_every
            if self.use_mla and phase == "decode":
                # absorbed decode attends over the latent: scores against
                # (kv_lora + rope) dims, values against kv_lora dims
                per_pos = self.num_heads * (2 * self.kv_lora_rank
                                            + self.qk_rope_head_dim)
            elif self.use_mla:
                # expanded train/prefill form: per-head qk and v dims
                per_pos = self.num_heads * (self.qk_nope_head_dim
                                            + self.qk_rope_head_dim
                                            + self.v_head_dim)
            else:
                per_pos = 2 * self.num_heads * self.resolved_head_dim
            # qk^T + av; causal halves the average context in prefill/train
            ctx = seq_len / 2 if phase in ("train", "prefill") else seq_len
            base += mult * n_attn * per_pos * ctx
        return base


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads else 4,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
    )
    if cfg.is_moe:
        base.update(num_experts=4, experts_per_token=min(2, cfg.experts_per_token),
                    num_shared_experts=min(1, cfg.num_shared_experts), moe_d_ff=64)
    if cfg.use_mla:
        base.update(kv_lora_rank=32, q_lora_rank=48, qk_rope_head_dim=8,
                    qk_nope_head_dim=16, v_head_dim=16, head_dim=None)
    if cfg.family in ("ssm", "hybrid"):
        base.update(ssm_state=16, ssm_head_dim=16)
    if cfg.family == "hybrid":
        base.update(num_layers=4, shared_attn_every=2, shared_attn_lora_rank=4)
    if cfg.family == "encdec":
        base.update(encoder_layers=2)
    if cfg.num_prefix_embeddings:
        base.update(num_prefix_embeddings=8)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
