"""Attention kernels of the port: hand-written CUDA for Hopper
(``csrc/``), their wrappers, the plain PyTorch versions (``ref``) and the
device dispatch (``ops``).

  flash_attention  — prefill attention (repro/kernels/flash_attention.py)
  decode_attention — one-token attention over a ragged dense cache
                     (repro/kernels/decode_attention.py)
"""
