"""Plain reference for the lower Cholesky factorization: PyTorch alone,
nothing of ``repro_torch``.

Right-looking and blocked in tiles: each diagonal tile is factored by
``torch.linalg.cholesky``, the panel below it is multiplied by the inverse
of its transpose (as MAGMA's trsm applies inverted diagonal blocks), and
the trailing matrix is updated.  Every product goes through ``mm``, so the
same code gives the float64 reference and the control in float32 with TF32
products (``compare.py``).  Leading
batch dimensions are carried through.
"""

from __future__ import annotations

from typing import Callable

import torch

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def cholesky(a: torch.Tensor, tile: int, mm: Matmul = torch.matmul) -> torch.Tensor:
    """Lower L with L L^T = ``a`` (upper triangle zero), in ``a``'s dtype."""
    a = a.clone()
    n = a.shape[-1]
    eye = torch.eye(tile, dtype=a.dtype, device=a.device)
    for k in range(0, n, tile):
        e = k + tile
        d = torch.linalg.cholesky(a[..., k:e, k:e])
        a[..., k:e, k:e] = d
        if e < n:
            inv = torch.linalg.solve_triangular(d, eye.expand_as(d), upper=False)
            a[..., e:, k:e] = mm(a[..., e:, k:e], inv.mT)
            panel = a[..., e:, k:e]
            a[..., e:, e:] -= mm(panel, panel.mT)
    return torch.tril(a)
