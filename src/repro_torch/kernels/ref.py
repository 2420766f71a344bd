"""Torch library oracles for the tile kernels.

These are the leaves of the ``"torch"`` backend (graphs g1/g2), as the
JAX package's ``kernels/ref.py`` is for its ``"jnp"`` backend, and the
allclose targets of the tests.  Conventions match the blocked left-looking
Cholesky (paper Fig. 2b):

    potrf(a)      -> lower Cholesky factor L of a
    trsm(l, b)    -> b @ inv(l)^T         (right, lower, transposed)
    syrk(a, c)    -> c - a @ a^T
    gemm(a, b, c) -> c - a @ b^T

and the blocked right-looking pivot-free LU:

    getrf(a)        -> packed L\\U factors (L unit-lower implicit, U upper)
    trsml(l, b)     -> inv(tril(l, unit)) @ b   (left, lower, unit-diagonal)
    trsmu(u, b)     -> b @ inv(triu(u))         (right, upper, non-unit)
    trsmul(u, b)    -> inv(triu(u)) @ b         (left, upper, non-unit)
    gemmnn(a, b, c) -> c - a @ b
    lu_solve(a, b)  -> (packed L\\U of a, x with a @ x == b)

and the oracles of the two standalone kernels:

    matmul(a, b)                -> a @ b in float32, cast to a's dtype
    flash_attention(q, k, v)    -> causal / windowed GQA attention,
                                   (B, Hq, S, D) with (B, Hkv, S, D) K, V

The triangular-solve oracles read only their own triangle (plus U's
diagonal), so packed L\\U blocks pass without masking.  PyTorch has no
pivot-free LU on the CPU (``lu_factor_ex(pivot=False)`` is CUDA-only), so
``getrf`` runs the plain recurrence ``tile_linalg.getrf_plain`` on CPU
tensors (as the JAX oracle delegates to its tile body: pivot-free LU has
one defined recurrence) and ``lu_factor_ex(pivot=False)``, whose packed
``LU`` is exactly L\\U, on CUDA tensors (through cuSOLVER or cuBLAS:
``cusolver_linalg``).

All oracles compute in float32 and cast back to the input dtype, and take
any leading batch dimensions.  On the card, float32 matmuls must not drop
to TF32 (about three decimal digits), or they would miss the reference
tolerances: the matmul oracles, and the kernels' plain versions, run under
``fp32_matmul``, which sets ``torch.backends.cuda.matmul.allow_tf32 =
False`` for the call whatever the caller has set.
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
    """A matrix that is not positive definite comes back all NaN, as
    ``jnp.linalg.cholesky`` returns it.  ``cholesky_ex`` leaves its status
    on the device, so the call never synchronizes (``cholesky`` would check
    it on the host) and a launch list holding it can be captured."""
    L, info = torch.linalg.cholesky_ex(a.float())
    return L.masked_fill_((info != 0)[..., None, None], float("nan")).to(a.dtype)


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


@contextmanager
def cusolver_linalg():
    """Run the enclosed CUDA factorizations on cuSOLVER and cuBLAS, then
    restore the caller's choice.  For more than 16 tiles of edge 128,
    PyTorch's default picks MAGMA's batched LU, which waits on the host
    and so cannot be captured into a CUDA graph; the cuSOLVER and cuBLAS
    routes never wait.  The setting is process-wide, as ``fp32_matmul``'s."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def getrf(a: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cuda":
        with cusolver_linalg():
            return torch.linalg.lu_factor_ex(a.float(), pivot=False).LU.to(a.dtype)
    from .tile_linalg import getrf_plain

    return getrf_plain(a).to(a.dtype)


def trsml(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = torch.linalg.solve_triangular(
        l.float(), b.float(), upper=False, left=True, unitriangular=True
    )
    return x.to(b.dtype)


def trsmu(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = torch.linalg.solve_triangular(u.float(), b.float(), upper=True, left=False)
    return x.to(b.dtype)


def trsmul(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = torch.linalg.solve_triangular(u.float(), b.float(), upper=True, left=True)
    return x.to(b.dtype)


@fp32_matmul()
def gemmnn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (c.float() - a.float() @ b.float()).to(c.dtype)


def lu_solve(a: torch.Tensor, b: torch.Tensor):
    """Factor then both substitutions on one block; returns ``(packed, x)``,
    one updated array per READWRITE argument of the composed LUSOLVE."""
    packed = getrf(a)
    return packed, trsmul(packed, trsml(packed, b))


@fp32_matmul()
def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


@fp32_matmul()
def flash_attention(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    causal: bool = True,
    window: int = 0,  # 0 = global; >0 = local sliding window
    scale: float | None = None,
) -> torch.Tensor:
    """Reference attention with GQA head-group broadcasting (K and V
    repeated to the query heads), softmax over -inf masks."""
    B, Hq, S, D = q.shape
    g = Hq // k.shape[1]
    scale = (D ** -0.5) if scale is None else scale
    kq = k.float().repeat_interleave(g, dim=1)
    vq = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kq)
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)
