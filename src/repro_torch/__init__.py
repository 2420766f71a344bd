"""PyTorch/CUDA port of the UTP task layer (TaskUniVerse).

Mirrors the JAX package ``repro`` module for module; imports neither JAX
nor ``repro``.  Entry points put their data on CUDA unless the caller
passes ``device="cpu"``.
"""

from . import configs, core, data, kernels, launch, linalg, models, optim, serve, serving, testing, train

__all__ = ["configs", "core", "data", "kernels", "launch", "linalg", "models", "optim", "serve", "serving",
           "testing", "train"]
