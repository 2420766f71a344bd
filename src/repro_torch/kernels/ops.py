"""The ``"cuda"`` backend's leaves: single-tile entry points over the
batched tile kernels (one tile in, one tile out), the batched kernels and
the fused grid table, plus the two standalone kernels ``matmul`` and
``flash_attention``.  CUDA kernel on the card, plain version on the
CPU."""

from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .tile_linalg import (
    GRID_FUSED,
    batched_gemm,
    batched_gemmnn,
    batched_getrf,
    batched_potrf,
    batched_syrk,
    batched_trsm,
    batched_trsml,
    batched_trsmu,
    batched_trsmul,
    matmul,
)


def potrf(a: torch.Tensor) -> torch.Tensor:
    return batched_potrf(a[None])[0]


def trsm(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return batched_trsm(l[None], b[None])[0]


def syrk(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return batched_syrk(a[None], c[None])[0]


def gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return batched_gemm(a[None], b[None], c[None])[0]


def getrf(a: torch.Tensor) -> torch.Tensor:
    return batched_getrf(a[None])[0]


def trsml(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return batched_trsml(l[None], b[None])[0]


def trsmu(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return batched_trsmu(u[None], b[None])[0]


def trsmul(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return batched_trsmul(u[None], b[None])[0]


def gemmnn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return batched_gemmnn(a[None], b[None], c[None])[0]


def lu_solve(a: torch.Tensor, b: torch.Tensor):
    """Single-tile factor + forward/backward substitution (the LUSOLVE
    leaf): the three batched kernels composed, no kernel of its own.
    Returns ``(packed, x)``, one updated array per READWRITE argument."""
    packed = batched_getrf(a[None])
    y = batched_trsml(packed, b[None])
    return packed[0], batched_trsmul(packed, y)[0]


__all__ = [
    "GRID_FUSED",
    "batched_gemm",
    "batched_gemmnn",
    "batched_getrf",
    "batched_potrf",
    "batched_syrk",
    "batched_trsm",
    "batched_trsml",
    "batched_trsmu",
    "batched_trsmul",
    "flash_attention",
    "gemm",
    "gemmnn",
    "getrf",
    "lu_solve",
    "matmul",
    "potrf",
    "syrk",
    "trsm",
    "trsml",
    "trsmu",
    "trsmul",
]
