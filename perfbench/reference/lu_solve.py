"""Plain reference for the pivot-free LU factor-and-solve: PyTorch alone,
nothing of ``repro_torch``.

Right-looking and blocked in tiles: each diagonal tile is factored column
by column, the tiles beside it are multiplied by the inverse of its
triangles (as MAGMA's trsm applies inverted diagonal blocks), and the
trailing matrix is updated; the solves run the same way.  Every product
goes through ``mm``, so the same code gives the float64 reference and the
control, which runs it in float32 with TF32 products (``compare.py``).
Leading batch dimensions are carried through.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _lu_tile(d: torch.Tensor) -> None:
    """Pivot-free LU of the tiles ``d`` (..., t, t) in place: unit L below
    the diagonal, U on and above it."""
    t = d.shape[-1]
    for j in range(t - 1):
        d[..., j + 1 :, j] /= d[..., j : j + 1, j]
        d[..., j + 1 :, j + 1 :] -= d[..., j + 1 :, j : j + 1] * d[..., j : j + 1, j + 1 :]


def factor(a: torch.Tensor, tile: int, mm: Matmul = torch.matmul,
           update: Optional[Matmul] = None) -> Tuple[torch.Tensor, List, List]:
    """(packed L\\U of ``a``, inverses of L's diagonal tiles, of U's), in
    ``a``'s dtype; the trailing updates' products through ``update``
    (by default ``mm``)."""
    update = update or mm
    a = a.clone()
    n = a.shape[-1]
    eye = torch.eye(tile, dtype=a.dtype, device=a.device)
    linv, uinv = [], []
    for k in range(0, n, tile):
        e = k + tile
        d = a[..., k:e, k:e]
        _lu_tile(d)
        ones = eye.expand_as(d)
        li = torch.linalg.solve_triangular(torch.tril(d, -1) + eye, ones, upper=False, unitriangular=True)
        ui = torch.linalg.solve_triangular(torch.triu(d), ones, upper=True)
        if e < n:
            a[..., k:e, e:] = mm(li, a[..., k:e, e:])
            a[..., e:, k:e] = mm(a[..., e:, k:e], ui)
            a[..., e:, e:] -= update(a[..., e:, k:e], a[..., k:e, e:])
        linv.append(li)
        uinv.append(ui)
    return a, linv, uinv


def solve(lu: torch.Tensor, linv: List, uinv: List, b: torch.Tensor, tile: int,
          mm: Matmul = torch.matmul) -> torch.Tensor:
    """x with ``a @ x == b`` for ``b`` (..., n, m), from ``factor``'s
    result: forward then backward substitution by tiles."""
    x = b.to(lu.dtype).clone()
    n = lu.shape[-1]
    p = n // tile
    for k in range(p):
        s, e = k * tile, (k + 1) * tile
        if k:
            x[..., s:e, :] -= mm(lu[..., s:e, :s], x[..., :s, :])
        x[..., s:e, :] = mm(linv[k], x[..., s:e, :])
    for k in reversed(range(p)):
        s, e = k * tile, (k + 1) * tile
        if e < n:
            x[..., s:e, :] -= mm(lu[..., s:e, e:], x[..., e:, :])
        x[..., s:e, :] = mm(uinv[k], x[..., s:e, :])
    return x


def lu_solve(a: torch.Tensor, b: torch.Tensor, tile: int, mm: Matmul = torch.matmul) -> torch.Tensor:
    """x with ``a @ x == b``, ``b`` (..., n, m), in ``a``'s dtype."""
    lu, linv, uinv = factor(a, tile, mm)
    return solve(lu, linv, uinv, b, tile, mm)
