"""The port's planner on the LU main path's partition (32 x 32 blocks, here
with 4 x 4 tiles so that nothing is large): plan only, no execution.  The
port's task, group, prefusion-group and slot counts, and its groups per
operation, equal the JAX planner's for run_lu and for run_lu_solve with a
matrix and a vector right-hand side."""

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.executors import plan_schedule as jplan
from repro.linalg import ops as jops
from repro_torch.core.executors import plan_schedule as tplan
from repro_torch.linalg import GETRF, LUSOLVE


def _leaf_plan(core, op, n, p, rhs_cols=None, **kw):
    """Split one root over a p x p partition and plan its leaf schedule."""
    A = core.GData((n, n), partitions=((p, p),), value=np.eye(n, dtype=np.float32), **kw)
    args = [A.root_view()]
    if rhs_cols is not None:
        pc = min(rhs_cols, 4)
        B = core.GData((n, rhs_cols), partitions=((p, pc),), value=np.zeros((n, rhs_cols), np.float32), **kw)
        args.append(B.root_view())
    children = []
    op.split(core.GTask(op, None, args), children.append)
    tracker = core.DepTracker()
    for t in children:
        tracker.add(t)
    plan = (tplan if core is tcore else jplan)(tracker.waves(), tracker.dag())
    return len(children), plan


@pytest.mark.parametrize(
    "root,rhs_cols,want,per_op",
    [
        ("getrf", None, (11440, 125, 125, 94), {"getrf": 32, "trsml": 31, "trsmu": 31, "gemmnn": 31}),
        ("lu_solve", 16, (15664, 654, 716, 623),
         {"getrf": 32, "trsml": 32, "trsmu": 31, "trsmul": 32, "gemmnn": 527}),
        ("lu_solve", 1, (12496, 716, 716, 623),
         {"getrf": 32, "trsml": 63, "trsmu": 31, "trsmul": 32, "gemmnn": 558}),
    ],
)
def test_plan_at_the_main_path_partition(root, rhs_cols, want, per_op):
    """32 x 32 partitions (the card's main path, here with 4 x 4 tiles): the
    port's tasks, groups, prefusion groups, slots and groups per op equal
    the JAX planner's (a b (n, 16) with 32 x 4 partitions has the block
    counts of the card's b (4096, 512))."""
    top = GETRF if root == "getrf" else LUSOLVE
    jop = jops.GETRF if root == "getrf" else jops.LUSOLVE
    n_t, tp = _leaf_plan(tcore, top, 128, 32, rhs_cols, device="cpu")
    n_j, jp = _leaf_plan(jcore, jop, 128, 32, rhs_cols)
    got = (n_t, tp.n_groups, tp.n_groups_prefusion, tp.n_slots)
    assert got == (n_j, jp.n_groups, jp.n_groups_prefusion, jp.n_slots) == want
    counts = {}
    for g in tp.groups():
        counts[g.op.name] = counts.get(g.op.name, 0) + 1
    assert counts == per_op
    assert [[(g.op.name, g.segments, g.write_pos) for g in s] for s in tp.slots] == [
        [(g.op.name, g.segments, g.write_pos) for g in s] for s in jp.slots
    ]


def test_lu_solve_plan_group_sizes():
    """The matrix-RHS solve's GEMMNN groups: 496 groups of 4 solve tasks
    and 31 large groups fused across the factor and the forward solve
    (two segments each, so on the gather path with TRSML's 31), the
    largest 1085 tasks (961 + 124) — equal in both planners."""
    _, tp = _leaf_plan(tcore, LUSOLVE, 128, 32, 16, device="cpu")
    _, jp = _leaf_plan(jcore, jops.LUSOLVE, 128, 32, 16)
    for plan in (tp, jp):
        gemmnn = [g for g in plan.groups() if g.op.name == "gemmnn"]
        small = [g.size for g in gemmnn if len(g.segments) == 1]
        fused = [(g.size, tuple(s for _, s in g.segments)) for g in gemmnn if len(g.segments) > 1]
        assert small == [4] * 496
        assert len(fused) == 31 and sum(s for s, _ in fused) == 12400
        assert max(fused) == (1085, (961, 124))
        multi = sorted(g.op.name for g in plan.groups() if len(g.segments) > 1)
        assert multi == ["gemmnn"] * 31 + ["trsml"] * 31
