"""Modality frontends (the JAX package's ``models/frontend.py``).

``[audio]`` / ``[vlm]`` architectures specify the transformer backbone only;
their frontend is a stub that delivers precomputed (B, S, d_model)
frame/patch embeddings.  Only the predicate is ported so far: the stub
embedders and the families that use them wait for ROADMAP A11, and
``build_model`` raises for them.
"""

from __future__ import annotations

from ..configs.base import ArchConfig


def uses_stub_frontend(cfg: ArchConfig) -> bool:
    return cfg.frontend in ("audio", "vision")
