"""PyTorch + CUDA port of the Heron serving stack (``repro`` is the JAX
reference it is held against).

Imports ``torch``, never ``jax`` and nothing of ``repro``. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; see ``device``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
