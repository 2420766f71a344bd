"""Torch library oracles for the Cholesky tile kernels.

These are the leaves of the ``"torch"`` backend (graphs g1/g2), as the
JAX package's ``kernels/ref.py`` is for its ``"jnp"`` backend, and the
allclose targets of the tests.  Conventions match the blocked left-looking
Cholesky (paper Fig. 2b):

    potrf(a)      -> lower Cholesky factor L of a
    trsm(l, b)    -> b @ inv(l)^T         (right, lower, transposed)
    syrk(a, c)    -> c - a @ a^T
    gemm(a, b, c) -> c - a @ b^T

All oracles compute in float32 and cast back to the input dtype.  On the
card, float32 matmuls must not drop to TF32 (about three decimal digits),
or they would miss the reference tolerances: the matmul oracles, and the
kernels' plain versions, run under ``fp32_matmul``, which sets
``torch.backends.cuda.matmul.allow_tf32 = False`` for the call whatever the
caller has set.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def fp32_matmul():
    """Run the enclosed float32 matmuls in full float32 on the card (no
    TF32), then restore the caller's setting.  Also a decorator.  The
    setting is process-wide, so it holds for other threads meanwhile."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def potrf(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cholesky(a.float()).to(a.dtype)


def trsm(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # x @ l^T = b: a right-side solve against the upper factor l^T
    x = torch.linalg.solve_triangular(l.float().mT, b.float(), upper=True, left=False)
    return x.to(b.dtype)


@fp32_matmul()
def syrk(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    a = a.float()
    return (c.float() - a @ a.mT).to(c.dtype)


@fp32_matmul()
def gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (c.float() - a.float() @ b.float().mT).to(c.dtype)
