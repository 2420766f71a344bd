"""Blocked dense linear algebra on the UTP core (the paper's technical +
application layers).

    run_cholesky(a)     lower Cholesky factor of SPD ``a``

``utp_cholesky`` creates one root task on an existing dispatcher.  The
operation singletons (POTRF, TRSM, SYRK, GEMM) are the registry entries
the dispatcher and executors operate on — see ``linalg/ops.py``.
"""

from .cholesky import run_cholesky, utp_cholesky
from .ops import GEMM, POTRF, SYRK, TRSM

__all__ = ["GEMM", "POTRF", "SYRK", "TRSM", "run_cholesky", "utp_cholesky"]
