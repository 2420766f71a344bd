"""Blocked Cholesky Operations (paper Fig. 2b) on the UTP core.

The Cholesky family, closed under hierarchical splitting (DESIGN.md §6):

    POTRF(A)       A -> L L^T (lower factor written back into A)
    TRSM(L, B)     B <- B @ inv(L)^T
    SYRK(A, C)     C <- C - A @ A^T
    GEMM(A, B, C)  C <- C - A @ B^T

``split`` reproduces the JAX package's left-looking blocked expansion (the
paper's Fig. 2b) child for child, so both packages build identical task
streams.  ``leaf_fn``/``batched_leaf_fn`` provide the ``"torch"`` leaves
(library calls, the cpuBLAS analog) and the ``"cuda"`` leaves (the
hand-written tile kernels, the cuBLAS analog); ``grid_fused_fn`` hands
``build_program`` the fused grid kernels for the ``"cuda"`` backend.
The LU family comes with a later slice of the port.
"""

from __future__ import annotations

from typing import Callable

from ..core.operation import Operation, OpRegistry
from ..core.task import Access, GTask
from ..kernels import ops as kops
from ..kernels import ref as kref


class _TileOp(Operation):
    """Leaf hooks shared by the four ops: the op's name selects its oracle,
    its single-tile and batched kernels and its fused grid kernel."""

    def leaf_fn(self, backend: str) -> Callable:
        return getattr(kops if backend == "cuda" else kref, self.name)

    def batched_leaf_fn(self, backend: str) -> Callable:
        if backend == "cuda":
            return getattr(kops, f"batched_{self.name}")
        return super().batched_leaf_fn(backend)

    def grid_fused_fn(self, backend: str):
        return kops.GRID_FUSED[self.name] if backend == "cuda" else None


class PotrfOp(_TileOp):
    name = "potrf"

    def default_modes(self, n):
        return [Access.READWRITE]

    def split(self, task: GTask, submit) -> None:
        # Paper Fig. 2(b): left-looking blocked Cholesky on A's next level.
        A = task.args[0]
        n = A.row_part_num()
        for i in range(n):
            for j in range(i):
                submit(GTask(SYRK, task, [A(i, j), A(i, i)]))
                for k in range(i + 1, n):
                    submit(GTask(GEMM, task, [A(k, j), A(i, j), A(k, i)]))
            submit(GTask(POTRF, task, [A(i, i)]))
            for j in range(i + 1, n):
                submit(GTask(TRSM, task, [A(i, i), A(j, i)]))


class TrsmOp(_TileOp):
    name = "trsm"

    def default_modes(self, n):
        return [Access.READ, Access.READWRITE]

    def split(self, task: GTask, submit) -> None:
        # X L^T = B blocked: X(p,i) = (B(p,i) - sum_{k<i} X(p,k) L(i,k)^T) L(i,i)^-T
        L, B = task.args
        n = L.row_part_num()
        m = B.row_part_num()
        for i in range(n):
            for p in range(m):
                for k in range(i):
                    submit(GTask(GEMM, task, [B(p, k), L(i, k), B(p, i)]))
                submit(GTask(TRSM, task, [L(i, i), B(p, i)]))


class SyrkOp(_TileOp):
    name = "syrk"

    def default_modes(self, n):
        return [Access.READ, Access.READWRITE]

    def split(self, task: GTask, submit) -> None:
        # C -= A A^T blocked over C's grid; diagonal uses SYRK, rest GEMM.
        A, C = task.args
        n = C.row_part_num()
        kk = A.col_part_num()
        for i in range(n):
            for j in range(n):
                for k in range(kk):
                    if i == j:
                        submit(GTask(SYRK, task, [A(i, k), C(i, i)]))
                    else:
                        submit(GTask(GEMM, task, [A(i, k), A(j, k), C(i, j)]))


class GemmOp(_TileOp):
    name = "gemm"

    def default_modes(self, n):
        return [Access.READ, Access.READ, Access.READWRITE]

    def split(self, task: GTask, submit) -> None:
        # C -= A B^T blocked
        A, B, C = task.args
        m = C.row_part_num()
        n = C.col_part_num()
        kk = A.col_part_num()
        for i in range(m):
            for j in range(n):
                for k in range(kk):
                    submit(GTask(GEMM, task, [A(i, k), B(j, k), C(i, j)]))


POTRF = OpRegistry.register(PotrfOp())
TRSM = OpRegistry.register(TrsmOp())
SYRK = OpRegistry.register(SyrkOp())
GEMM = OpRegistry.register(GemmOp())
