"""Blocked linear-algebra Operations (paper Fig. 2b) on the UTP core.

Two operation families, each closed under hierarchical splitting
(DESIGN.md §6).  The Cholesky family:

    POTRF(A)       A -> L L^T (lower factor written back into A)
    TRSM(L, B)     B <- B @ inv(L)^T
    SYRK(A, C)     C <- C - A @ A^T
    GEMM(A, B, C)  C <- C - A @ B^T

the LU family (pivot-free, Doolittle: L unit-lower, U non-unit upper):

    GETRF(A)         A -> L\\U packed in place
    TRSML(L, B)      B <- inv(L) @ B     (left, lower, unit-diagonal)
    TRSMU(U, B)      B <- B @ inv(U)     (right, upper, non-unit)
    TRSMUL(U, B)     B <- inv(U) @ B     (left, upper, non-unit)
    GEMMNN(A, B, C)  C <- C - A @ B

and one *composed* workload over the LU family (DESIGN.md §4):

    LUSOLVE(A, B)    A -> L\\U packed;  B <- inv(A) @ B

``split`` reproduces the JAX package's blocked expansions (left-looking
Cholesky per the paper's Fig. 2b, right-looking LU) child for child, so
both packages build identical task streams.  LUSOLVE's split emits the
factor expansion followed by the forward (TRSML) and backward (TRSMUL)
block substitutions into ONE scope, so one drain runs the whole pipeline.
``leaf_fn``/``batched_leaf_fn`` provide the ``"torch"`` leaves (library
calls, the cpuBLAS analog) and the ``"cuda"`` leaves (the hand-written
tile kernels, the cuBLAS analog); ``grid_fused_fn`` hands
``build_program`` the fused grid kernels for the ``"cuda"`` backend.
"""

from __future__ import annotations

from typing import Callable

from ..core.operation import Operation, OpRegistry
from ..core.task import Access, GTask
from ..kernels import ops as kops
from ..kernels import ref as kref


class _TileOp(Operation):
    """Leaf hooks shared by the tile ops: the op's name selects its oracle,
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


# --------------------------------------------------------------------------
# Blocked expansions of the LU family, shared between the per-op splits and
# the composed LUSOLVE split (which emits all three into one scope).  Each
# is a pure function of argument geometry (the drain-memo contract).
# --------------------------------------------------------------------------
def _expand_getrf(task: GTask, A, submit) -> None:
    # Right-looking blocked LU on A's next level: factor the diagonal
    # block, solve the U row panel (left/lower) and the L column panel
    # (right/upper), then one Schur rank-b update of the trailing blocks.
    n = A.row_part_num()
    for k in range(n):
        submit(GTask(GETRF, task, [A(k, k)]))
        for j in range(k + 1, n):
            submit(GTask(TRSML, task, [A(k, k), A(k, j)]))
        for i in range(k + 1, n):
            submit(GTask(TRSMU, task, [A(k, k), A(i, k)]))
        for i in range(k + 1, n):
            for j in range(k + 1, n):
                submit(GTask(GEMMNN, task, [A(i, k), A(k, j), A(i, j)]))


def _expand_trsml(task: GTask, L, B, submit) -> None:
    # X(i,q) = inv(L(i,i)) (B(i,q) - sum_{k<i} L(i,k) X(k,q)): block
    # forward substitution down B's rows, for every column of blocks.
    n = L.row_part_num()
    m = B.col_part_num()
    for i in range(n):
        for q in range(m):
            for k in range(i):
                submit(GTask(GEMMNN, task, [L(i, k), B(k, q), B(i, q)]))
            submit(GTask(TRSML, task, [L(i, i), B(i, q)]))


def _expand_trsmul(task: GTask, U, B, submit) -> None:
    # X(i,q) = inv(U(i,i)) (B(i,q) - sum_{k>i} U(i,k) X(k,q)): block
    # backward substitution up B's rows.  Descending submission order makes
    # versioning read the FINAL X(k,q) (k > i), not the forward-pass value.
    n = U.row_part_num()
    m = B.col_part_num()
    for i in reversed(range(n)):
        for q in range(m):
            for k in range(i + 1, n):
                submit(GTask(GEMMNN, task, [U(i, k), B(k, q), B(i, q)]))
            submit(GTask(TRSMUL, task, [U(i, i), B(i, q)]))


class GetrfOp(_TileOp):
    name = "getrf"

    def default_modes(self, n):
        return [Access.READWRITE]

    def split(self, task: GTask, submit) -> None:
        _expand_getrf(task, task.args[0], submit)


class TrsmLowerOp(_TileOp):
    """B <- inv(L) @ B, L unit-lower (forward substitution, left side)."""

    name = "trsml"

    def default_modes(self, n):
        return [Access.READ, Access.READWRITE]

    def split(self, task: GTask, submit) -> None:
        _expand_trsml(task, task.args[0], task.args[1], submit)


class TrsmUpperOp(_TileOp):
    """B <- B @ inv(U), U upper non-unit (backward substitution, right side)."""

    name = "trsmu"

    def default_modes(self, n):
        return [Access.READ, Access.READWRITE]

    def split(self, task: GTask, submit) -> None:
        # X(q,j) = (B(q,j) - sum_{k<j} X(q,k) U(k,j)) inv(U(j,j)): block
        # substitution across B's columns, for every row of blocks.
        U, B = task.args
        n = U.col_part_num()
        m = B.row_part_num()
        for j in range(n):
            for q in range(m):
                for k in range(j):
                    submit(GTask(GEMMNN, task, [B(q, k), U(k, j), B(q, j)]))
                submit(GTask(TRSMU, task, [U(j, j), B(q, j)]))


class TrsmUpperLeftOp(_TileOp):
    """B <- inv(U) @ B, U upper non-unit (backward substitution, left side).

    The fourth TRSM orientation — the one that closes ``A x = b``: after a
    pivot-free LU, ``x = inv(U) @ inv(L) @ b`` is one TRSML followed by one
    TRSMUL.  Like the other solve leaves it reads only its own triangle
    (plus the diagonal), so packed L\\U blocks pass through unmasked.
    """

    name = "trsmul"

    def default_modes(self, n):
        return [Access.READ, Access.READWRITE]

    def split(self, task: GTask, submit) -> None:
        _expand_trsmul(task, task.args[0], task.args[1], submit)


class LuSolveOp(Operation):
    """Composed workload: factor A pivot-free and solve A X = B, in place.

    ``split`` emits the full right-looking LU expansion followed by the
    forward (TRSML) and backward (TRSMUL) block substitutions — all into
    ONE scope, so data versioning orders the pipeline as a single task DAG
    and the dispatcher builds one launch list for the whole factor+solve
    drain, where the cross-wave fusion pass overlaps early solve groups
    with late factor groups (DESIGN.md §4).  Every child is a plain member
    of the LU family; the executors never see LUSOLVE below the root level,
    so it has no batched leaf and no fused grid kernel of its own.
    """

    name = "lu_solve"

    def default_modes(self, n):
        # A -> packed L\U in place; B -> X in place
        return [Access.READWRITE, Access.READWRITE]

    def leaf_fn(self, backend: str) -> Callable:
        # only reached when the root runs unsplit (g1, or 1-level data):
        # factor + both substitutions on the whole matrices
        return kops.lu_solve if backend == "cuda" else kref.lu_solve

    def split(self, task: GTask, submit) -> None:
        A, B = task.args
        _expand_getrf(task, A, submit)
        _expand_trsml(task, A, B, submit)
        _expand_trsmul(task, A, B, submit)


class GemmNNOp(_TileOp):
    name = "gemmnn"

    def default_modes(self, n):
        return [Access.READ, Access.READ, Access.READWRITE]

    def split(self, task: GTask, submit) -> None:
        # C -= A B blocked: C(i,j) -= sum_k A(i,k) B(k,j)
        A, B, C = task.args
        m = C.row_part_num()
        n = C.col_part_num()
        kk = A.col_part_num()
        for i in range(m):
            for j in range(n):
                for k in range(kk):
                    submit(GTask(GEMMNN, task, [A(i, k), B(k, j), C(i, j)]))


POTRF = OpRegistry.register(PotrfOp())
TRSM = OpRegistry.register(TrsmOp())
SYRK = OpRegistry.register(SyrkOp())
GEMM = OpRegistry.register(GemmOp())
GETRF = OpRegistry.register(GetrfOp())
TRSML = OpRegistry.register(TrsmLowerOp())
TRSMU = OpRegistry.register(TrsmUpperOp())
TRSMUL = OpRegistry.register(TrsmUpperLeftOp())
GEMMNN = OpRegistry.register(GemmNNOp())
LUSOLVE = OpRegistry.register(LuSolveOp())
