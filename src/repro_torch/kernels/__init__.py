"""Kernels of the port: hand-written CUDA for Hopper
(``csrc/``), their wrappers, the plain PyTorch versions (``ref``) and the
device dispatch (``ops``).

  flash_attention  — prefill attention (repro/kernels/flash_attention.py),
                     with an optional log-sum-exp output for training
  flash_attention_bwd_dot/_dkdv/_dq — its backward (D, dK/dV, dQ; no TPU
                     kernel: the reference differentiates XLA attention)
  decode_attention — one-token attention over a ragged dense cache
                     (repro/kernels/decode_attention.py)
  decode_attention_int8  — the same over an int8 cache with scales
  paged_decode_attention — one-token attention through a block table,
                     fp or int8 pools (repro/kernels/decode_attention.py)
  paged_extend_attention — chunk attention continued from page pools
                     (repro/kernels/flash_attention.py)
  expert_matmul    — capacity-bucketed MoE expert GEMM
                     (repro/kernels/grouped_matmul.py)
  expert_matmul_bwd_dx/_dw — its backward (no TPU kernel: the reference
                     differentiates the expert FFN's einsums in XLA)
  wkv6             — chunked RWKV6 recurrence (repro/kernels/wkv6.py)
"""
