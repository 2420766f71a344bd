"""The ``"cuda"`` backend's leaves: single-tile entry points over the
batched tile kernels (``(b, b)`` in, ``(b, b)`` out), the batched kernels
and the fused grid table.  CUDA kernel on the card, plain version on the
CPU."""

from __future__ import annotations

import torch

from .tile_linalg import (
    GRID_FUSED,
    batched_gemm,
    batched_potrf,
    batched_syrk,
    batched_trsm,
)


def potrf(a: torch.Tensor) -> torch.Tensor:
    return batched_potrf(a[None])[0]


def trsm(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return batched_trsm(l[None], b[None])[0]


def syrk(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return batched_syrk(a[None], c[None])[0]


def gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return batched_gemm(a[None], b[None], c[None])[0]


__all__ = [
    "GRID_FUSED",
    "batched_gemm",
    "batched_potrf",
    "batched_syrk",
    "batched_trsm",
    "gemm",
    "potrf",
    "syrk",
    "trsm",
]
