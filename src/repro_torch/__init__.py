"""repro_torch — the PyTorch/CUDA port of the SIMDive system.

A second package beside ``repro`` (the JAX reference): same sub-package and
file names where a counterpart exists, PyTorch's idiom inside. Plain tensor
code is PyTorch; every fused kernel of the reference is a hand-written CUDA
kernel under ``kernels/csrc`` that is compiled at its first launch, never
at import — importing this package needs neither a compiler nor a GPU.

This package imports ``torch`` and ``numpy`` only: never ``jax``, and
nothing from ``repro``.
"""

__all__ = ["core", "kernels", "configs", "models", "launch", "metrics"]
