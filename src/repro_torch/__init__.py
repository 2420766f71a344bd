"""PyTorch/CUDA port of the UTP task layer (TaskUniVerse).

Mirrors the JAX package ``repro`` module for module; imports neither JAX
nor ``repro``.  Entry points put their data on CUDA unless the caller
passes ``device="cpu"``.
"""

from . import core, kernels, linalg

__all__ = ["core", "kernels", "linalg"]
