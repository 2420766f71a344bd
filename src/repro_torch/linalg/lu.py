"""Application + technical layers for LU, triangular solve, and the
end-to-end ``lu_solve`` drain (DESIGN.md §4/§6).

Mirrors ``cholesky.py``: ``utp_getrf`` / ``utp_solve`` / ``utp_lu_solve``
are the technical-layer subroutines (create one root task, submit it);
``run_lu`` / ``run_lu_many`` / ``run_lu_batched`` / ``run_solve`` /
``run_lu_solve`` / ``run_lu_solve_batched`` / ``run_inv`` are whole
application programs — define data + partitions,
call the subroutine, drain.  They run on the same dispatcher and executors
as Cholesky with no executor changes: the dispatcher only sees Operations.

Conventions (pivot-free Doolittle, see ``linalg/ops.py``):

    run_lu(a)                -> (L, U) with L unit-lower, U upper, L@U == a
    run_solve(a, b)          -> x with tril(a, unit) @ x == b
    run_solve(a, b, lower=False)              -> x with x @ triu(a) == b
    run_solve(a, b, lower=False, side="left") -> x with triu(a) @ x == b
    run_lu_solve(a, b)       -> x with a @ x == b  (factor+solve, ONE drain)
    run_inv(a)               -> inv(a)             (lu_solve against I)

``run_solve`` reads only the relevant triangle of ``a``, so a packed L\\U
factor can be passed straight back in for forward/backward substitution.
Inputs are numpy arrays or tensors; every entry point puts its data on
``device``, which is CUDA unless the caller names another, and returns
tensors there.  ``mesh`` (a ``torch.distributed`` ``DeviceMesh``) runs the
distributed graphs g3/g4/g3flat: the data goes on the mesh's device
(``cuda:<local rank>`` or the CPU), a ``device`` naming another raises, and
a result the mesh splits stays split, as the JAX package's sharded arrays
do: a ``DTensor`` whose ``to_local()`` is this rank's rows (``full_tensor()``
is a collective every rank calls).  Inputs may be whole on every rank or
``DTensor``s split that way.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core import Dispatcher, GData, GTask
from ..core.data import like, local_part, resolve_device
from ..core.executors.sharded import drained, mesh_device, mesh_group
from ..errors import NumericalError
from .ops import GETRF, LUSOLVE, TRSML, TRSMU, TRSMUL

Partitions = Tuple[Tuple[int, int], ...]


def check_finite_result(name: str, *arrays: Optional[torch.Tensor]) -> None:
    """Raise ``NumericalError`` if any result array is non-finite.

    The pivot-free expansions have no singular-pivot detection (the paper's
    fixed task-flow shape), so a zero pivot silently propagates inf/NaN
    through the trailing updates; ``check_finite=True`` on the run_* entry
    points turns that into a typed error (DESIGN.md §10).  Opt-in: the
    check synchronizes with the card.  A split result is checked on each
    rank's part and the verdict agreed over the mesh, so every rank raises
    or none does.
    """
    for a in arrays:
        if a is None:
            continue
        ok = torch.isfinite(local_part(a)[0]).all()
        if isinstance(a, DTensor):
            ok = ok.to(torch.int32)
            dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh_group(a.device_mesh))
        if not bool(ok):
            raise NumericalError(
                f"{name}: non-finite values in result (singular pivot or "
                f"overflow; input not factorizable without pivoting?)"
            )


def _gdata(a: Any, partitions: Partitions, device) -> GData:
    dtype = a.dtype if torch.is_tensor(a) else torch.float32
    return GData(tuple(a.shape), partitions=partitions, dtype=dtype, value=a, device=device)


def _unpack(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unit-lower L, upper U) of a packed factor, whole or split: each on
    this rank's part, by its offset."""
    local, (r0, c0) = local_part(packed)
    eye = torch.zeros_like(local)
    eye.diagonal(r0 - c0).fill_(1)
    return like(packed, torch.tril(local, r0 - c0 - 1) + eye), like(packed, torch.triu(local, r0 - c0))


def _column(x: torch.Tensor) -> torch.Tensor:
    """Column 0 of ``x`` (n, 1), whole or split, as a vector."""
    return like(x, local_part(x)[0][:, 0], (x.shape[0],))


def utp_getrf(dispatcher: Dispatcher, A: GData) -> GTask:
    task = GTask(GETRF, None, [A.root_view()])
    dispatcher.submit_task(task)
    return task


def utp_solve(
    dispatcher: Dispatcher,
    A: GData,
    B: GData,
    lower: bool = True,
    side: Optional[str] = None,
) -> GTask:
    """Submit one triangular-solve root task (technical layer).

    ``side`` defaults to the algebra's native orientation per triangle:
    "left" for lower (TRSML, forward substitution) and "right" for upper
    (TRSMU).  ``lower=False, side="left"`` selects TRSMUL — the left-upper
    backward substitution that closes ``A x = b`` end-to-end.
    """
    if side is None:
        side = "left" if lower else "right"
    if lower:
        if side != "left":
            raise ValueError("lower solves are left-sided (TRSML) only")
        op = TRSML
    else:
        if side not in ("left", "right"):
            raise ValueError(f"side must be 'left' or 'right', got {side!r}")
        op = TRSMUL if side == "left" else TRSMU
    task = GTask(op, None, [A.root_view(), B.root_view()])
    dispatcher.submit_task(task)
    return task


def utp_lu_solve(dispatcher: Dispatcher, A: GData, B: GData) -> GTask:
    """Submit ONE composed factor+solve root task (LUSOLVE, DESIGN.md §4):
    one scope, one task DAG, one launch list for the whole pipeline."""
    task = GTask(LUSOLVE, None, [A.root_view(), B.root_view()])
    dispatcher.submit_task(task)
    return task


def run_lu(
    a: Any,
    graph: str = "g2",
    partitions: Partitions = ((4, 4),),
    check_finite: bool = False,
    mesh=None,
    device=None,
    verify: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pivot-free blocked LU of ``a``; returns (L, U) unpacked.

    ``a`` must admit LU without pivoting (e.g. diagonally dominant); the
    expansion has no singular-pivot detection, but ``check_finite=True``
    raises ``NumericalError`` instead of returning inf/NaN.
    """
    device = mesh_device(mesh, device)
    d = Dispatcher(graph=graph, mesh=mesh, verify=verify)
    A = _gdata(a, partitions, device)
    utp_getrf(d, A)
    d.run()
    packed = drained(d.executor, A)
    if check_finite:
        check_finite_result("run_lu", packed)
    return _unpack(packed)


def run_lu_many(
    mats: Sequence[Any],
    graph: str = "g2",
    partitions: Partitions = ((4, 4),),
    mesh=None,
    device=None,
    verify: Optional[bool] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Pivot-free blocked LU of several matrices in ONE dispatcher drain.

    Every factorization is its own root task; the scheduler interleaves the
    independent task DAGs and the fusion pass merges their same-signature
    groups into shared launches, one segment per root (the matrices may
    differ in shape).  Stacking is deliberately OFF here: this is the
    per-root *segment fusion* form, the baseline the stacked
    ``run_lu_batched`` is compared against (DESIGN.md §7).
    """
    device = mesh_device(mesh, device)
    d = Dispatcher(graph=graph, mesh=mesh, stack_roots=False, verify=verify)
    roots = []
    for a in mats:
        A = _gdata(a, partitions, device)
        utp_getrf(d, A)
        roots.append(A)
    d.run()
    return [_unpack(drained(d.executor, A)) for A in roots]


def run_lu_batched(
    mats: Sequence[Any],
    graph: str = "g2",
    partitions: Partitions = ((4, 4),),
    mesh=None,
    device=None,
    verify: Optional[bool] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Pivot-free blocked LU of N same-geometry matrices as ONE *stacked*
    batched drain (DESIGN.md §7).

    All matrices must share shape/dtype; the dispatcher detects the
    homogeneous root stream, stacks the roots along a new leading batch
    dimension padded to a pow2 bucket, and expands/builds the task graph
    ONCE — launch count and built-list count are flat in N (any N hits one
    of O(log N) bucket lists), unlike ``run_lu_many`` whose fused groups
    still carry one gather/scatter segment per root.
    """
    device = mesh_device(mesh, device)
    d = Dispatcher(graph=graph, mesh=mesh, verify=verify)
    roots = []
    for a in mats:
        A = _gdata(a, partitions, device)
        utp_getrf(d, A)
        roots.append(A)
    d.run()
    return [_unpack(drained(d.executor, A)) for A in roots]


def run_solve(
    a: Any,
    b: Any,
    lower: bool = True,
    graph: str = "g2",
    partitions: Partitions = ((4, 4),),
    b_partitions: Optional[Partitions] = None,
    side: Optional[str] = None,
    check_finite: bool = False,
    mesh=None,
    device=None,
    verify: Optional[bool] = None,
) -> torch.Tensor:
    """Blocked triangular solve as a task workload.

    ``lower=True``: x = inv(tril(a, unit-diagonal)) @ b (forward subst.).
    ``lower=False``: x = b @ inv(triu(a)) (backward substitution from the
    right), or x = inv(triu(a)) @ b with ``side="left"`` (TRSMUL).
    ``b_partitions`` defaults to ``partitions``; give it explicitly for
    non-square block counts (b's row grid must match a's for left-sided
    solves, its column grid for the right-sided one).
    """
    device = mesh_device(mesh, device)
    d = Dispatcher(graph=graph, mesh=mesh, verify=verify)
    A = _gdata(a, partitions, device)
    B = _gdata(b, partitions if b_partitions is None else b_partitions, device)
    utp_solve(d, A, B, lower=lower, side=side)
    d.run()
    x = drained(d.executor, B)
    if check_finite:
        check_finite_result("run_solve", x)
    return x


def run_lu_solve(
    a: Any,
    b: Any,
    graph: str = "g2",
    partitions: Partitions = ((4, 4),),
    b_partitions: Optional[Partitions] = None,
    check_finite: bool = False,
    mesh=None,
    device=None,
    verify: Optional[bool] = None,
) -> torch.Tensor:
    """Solve ``a @ x == b`` by pivot-free LU — factor AND solve in ONE drain.

    The whole pipeline is one composed LUSOLVE root: one task DAG, one
    launch list, replayed through the drain memo on structurally repeated
    calls.  ``b`` may be a matrix ``(n, m)`` or a vector ``(n,)``;
    ``b_partitions`` defaults to ``partitions`` with the column counts
    collapsed to 1 for a vector right-hand side.  ``check_finite=True``
    raises ``NumericalError`` on a non-finite solution.
    """
    if b.shape[0] != a.shape[0]:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)} vs b {tuple(b.shape)}")
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    if b_partitions is None:
        b_partitions = tuple((pr, 1 if vec else pc) for pr, pc in partitions)
    device = mesh_device(mesh, device)
    d = Dispatcher(graph=graph, mesh=mesh, verify=verify)
    A = _gdata(a, partitions, device)
    B = _gdata(b2, b_partitions, device)
    utp_lu_solve(d, A, B)
    d.run()
    x = drained(d.executor, B)
    if check_finite:
        check_finite_result("run_lu_solve", x)
    return _column(x) if vec else x


def run_lu_solve_batched(
    mats: Sequence[Any],
    rhss: Sequence[Any],
    graph: str = "g2",
    partitions: Partitions = ((4, 4),),
    b_partitions: Optional[Partitions] = None,
    mesh=None,
    device=None,
    verify: Optional[bool] = None,
) -> List[torch.Tensor]:
    """Solve N same-geometry systems ``a_i @ x_i == b_i`` in ONE stacked
    drain (DESIGN.md §7): N composed LUSOLVE roots stack into a single
    batched launch list — the serving hot path ``BatchServer`` drains per
    tick.  Geometry rules follow ``run_lu_solve`` (vector or matrix b)."""
    if len(mats) != len(rhss):
        raise ValueError(f"{len(mats)} matrices vs {len(rhss)} right-hand sides")
    device = mesh_device(mesh, device)
    d = Dispatcher(graph=graph, mesh=mesh, verify=verify)
    outs = []
    for a, b in zip(mats, rhss):
        if b.shape[0] != a.shape[0]:
            raise ValueError(f"shape mismatch: a {tuple(a.shape)} vs b {tuple(b.shape)}")
        vec = b.ndim == 1
        b2 = b[:, None] if vec else b
        bp = b_partitions
        if bp is None:
            bp = tuple((pr, 1 if vec else pc) for pr, pc in partitions)
        A = _gdata(a, partitions, device)
        B = _gdata(b2, bp, device)
        utp_lu_solve(d, A, B)
        outs.append((B, vec))
    d.run()
    return [_column(drained(d.executor, B)) if vec else drained(d.executor, B) for B, vec in outs]


def run_inv(
    a: Any,
    graph: str = "g2",
    partitions: Partitions = ((4, 4),),
    mesh=None,
    device=None,
    verify: Optional[bool] = None,
) -> torch.Tensor:
    """Matrix inverse via LU: ``run_lu_solve(a, I)`` — the same composed
    pipeline against the identity, with no new operation."""
    device = mesh_device(mesh, device)
    dtype = a.dtype if torch.is_tensor(a) else torch.float32
    eye = torch.eye(a.shape[0], dtype=dtype, device=resolve_device(device))
    return run_lu_solve(a, eye, graph=graph, partitions=partitions, mesh=mesh, device=device, verify=verify)
