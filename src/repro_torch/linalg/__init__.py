"""Blocked dense linear algebra on the UTP core (the paper's technical +
application layers).

    run_cholesky(a)     lower Cholesky factor of SPD ``a``
    run_lu(a)           pivot-free blocked LU -> (L, U)
    run_lu_many(mats)   several LUs in ONE multi-root drain (segment fusion)
    run_lu_batched(mats) N same-geometry LUs as ONE stacked drain
    run_solve(a, b)     blocked triangular solve (TRSML / TRSMU / TRSMUL)
    run_lu_solve(a, b)  factor + forward + backward solve in ONE drain
    run_lu_solve_batched(mats, rhss)  N such solves as ONE stacked drain
    run_inv(a)          matrix inverse via the same composed pipeline

``utp_*`` create one root task on an existing dispatcher.  The operation
singletons (POTRF .. LUSOLVE) are the registry entries the dispatcher and
executors operate on — see ``linalg/ops.py``.
"""

from .cholesky import run_cholesky, utp_cholesky
from .lu import (
    run_inv,
    run_lu,
    run_lu_batched,
    run_lu_many,
    run_lu_solve,
    run_lu_solve_batched,
    run_solve,
    utp_getrf,
    utp_lu_solve,
    utp_solve,
)
from .ops import GEMM, GEMMNN, GETRF, LUSOLVE, POTRF, SYRK, TRSM, TRSML, TRSMU, TRSMUL

__all__ = [
    "GEMM",
    "GEMMNN",
    "GETRF",
    "LUSOLVE",
    "POTRF",
    "SYRK",
    "TRSM",
    "TRSML",
    "TRSMU",
    "TRSMUL",
    "run_cholesky",
    "run_inv",
    "run_lu",
    "run_lu_batched",
    "run_lu_many",
    "run_lu_solve",
    "run_lu_solve_batched",
    "run_solve",
    "utp_cholesky",
    "utp_getrf",
    "utp_lu_solve",
    "utp_solve",
]
