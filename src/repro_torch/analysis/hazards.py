"""Hazard analysis: independent re-derivation of the dependence DAG.

The drain-memo, fusion, and stacking machinery all rest on one claim: the
``DepTracker`` edge DAG orders every true data dependence of a scope.  A
missing edge is a *race* — two conflicting accesses the scheduler is free
to reorder or fuse into one launch, producing plausible-but-wrong floats
that no end-to-end test reliably catches.  This pass re-derives the ground
truth from first principles and cross-checks the tracker (DESIGN.md §11):

1. Recompute every task's block-level read/write footprint straight from
   ``GTask.accesses()`` — (datum, region, level, access mode), nothing
   shared with the tracker's incremental last-writer/readers state.
2. Re-derive the full conflict relation by exact rectangle overlap: a pair
   of accesses conflicts iff the regions of the SAME datum overlap and at
   least one writes (RAW / WAR / WAW by program order and modes).
3. Cross-check: every conflicting pair must be *ordered* by the tracker
   DAG — connected by a path in program-order direction (direct edges are
   not required: the tracker legitimately drops transitively implied
   edges, e.g. WAW chains through the last writer).  A conflicting pair
   with no path is a RACE -> ``ScheduleVerificationError``.
4. Converse check: every tracker edge must be implied by some conflict
   path.  A tracker edge between truly independent tasks is not a
   correctness bug but *lost parallelism* — the fusion pass will refuse
   legal merges — reported as a ``LostParallelismWarning``.

The pass is deliberately O(accesses^2) per datum (exact, no uniform-grid
fast path): its job is to distrust every shortcut the production tracker
takes.  Verify mode only runs it on non-replay drains, where Python task
expansion dominates anyway; replayed drains re-execute a verified capture
and pay nothing (DESIGN.md §11 cost model).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from ..core.task import GTask
from ..core.versioning import TaskDag
from ..errors import ScheduleVerificationError


class LostParallelismWarning(UserWarning):
    """A tracker edge orders two provably independent tasks (spurious
    dependence): correct but pessimal — fusion/slotting lose parallelism."""


@dataclass(frozen=True)
class Conflict:
    """One true dependence: ``pred`` must run before ``succ``."""

    kind: str  # "RAW" | "WAR" | "WAW"
    pred: int  # task id, earlier in program order
    succ: int  # task id, later in program order
    data_name: str
    region: Tuple[int, int, int, int]  # succ-side (r0, c0, rows, cols)


@dataclass
class HazardReport:
    """Outcome of one scope's hazard cross-check."""

    n_tasks: int
    n_conflicts: int
    races: List[Conflict] = field(default_factory=list)
    spurious: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.races


def _conflict_kind(pred_writes: bool, succ_writes: bool) -> str:
    if pred_writes:
        # successor reads after the write (RAW) or overwrites it (WAW)
        return "WAW" if succ_writes else "RAW"
    return "WAR"  # successor writes over a region the predecessor read


def recompute_conflicts(tasks: Sequence[GTask]) -> List[Conflict]:
    """The ground-truth dependence relation of a scope, from footprints.

    Program order is task submission order (ascending ``GTask.id`` — ids
    are allocated monotonically at construction, which the dispatcher does
    in submission order).  For each datum, every ordered pair of accesses
    with overlapping regions and at least one write is a dependence.
    Within one task, multiple accesses to the same datum collapse to the
    strongest mode per region pair (a task never races itself).
    """
    order = sorted(tasks, key=lambda t: t.id)
    # datum id -> [(task id, region, writes, data name)] in program order
    per_datum: Dict[int, List[tuple]] = {}
    for t in order:
        for view, mode in t.accesses():
            per_datum.setdefault(view.data.id, []).append(
                (t.id, view.region, mode.writes, view.data.name)
            )
    conflicts: List[Conflict] = []
    seen = set()
    for accesses in per_datum.values():
        for j in range(len(accesses)):
            tj, rj, wj, name = accesses[j]
            for i in range(j):
                ti, ri, wi, _ = accesses[i]
                if ti == tj or not (wi or wj):
                    continue
                if not ri.overlaps(rj):
                    continue
                kind = _conflict_kind(wi, wj)
                key = (ti, tj, kind)
                if key in seen:
                    continue
                seen.add(key)
                conflicts.append(
                    Conflict(
                        kind, ti, tj, name, (rj.r0, rj.c0, rj.rows, rj.cols)
                    )
                )
    return conflicts


def analyze_hazards(
    tasks: Sequence[GTask],
    dag: TaskDag,
    raise_on_race: bool = True,
    warn_on_spurious: bool = True,
) -> HazardReport:
    """Cross-check ``dag`` (the tracker's edge DAG) against the recomputed
    ground truth; see the module docstring for the two directions.

    Raises ``ScheduleVerificationError`` on the first detected race set
    (all races are gathered into one message) unless ``raise_on_race`` is
    False; spurious edges warn ``LostParallelismWarning`` and are returned
    on the report either way.
    """
    conflicts = recompute_conflicts(tasks)
    report = HazardReport(n_tasks=len(tasks), n_conflicts=len(conflicts))

    # direction 1: every true dependence must be a tracker path
    for c in conflicts:
        if not dag.path(c.pred, c.succ):
            report.races.append(c)

    # direction 2: every tracker edge must be implied by a conflict path.
    # Build the true DAG from the conflict pairs and reuse TaskDag's bitset
    # reachability — the same machinery, fed independent inputs.
    true_edges: Dict[int, set] = {}
    true_preds: Dict[int, set] = {}
    for c in conflicts:
        true_edges.setdefault(c.pred, set()).add(c.succ)
        true_preds.setdefault(c.succ, set()).add(c.pred)
    true_dag = TaskDag(dict(dag.tasks), true_edges, true_preds)
    for pred, succs in dag.edges.items():
        for succ in succs:
            if not true_dag.path(pred, succ):
                report.spurious.append((pred, succ))

    if report.spurious and warn_on_spurious:
        pairs = ", ".join(f"{a}->{b}" for a, b in report.spurious[:5])
        warnings.warn(
            f"tracker orders {len(report.spurious)} independent task "
            f"pair(s) ({pairs}{'...' if len(report.spurious) > 5 else ''}): "
            f"correct but loses parallelism",
            LostParallelismWarning,
            stacklevel=2,
        )
    if report.races and raise_on_race:
        ops = dag.tasks
        lines = []
        for c in report.races[:5]:
            po = ops[c.pred].op.name if c.pred in ops else "?"
            so = ops[c.succ].op.name if c.succ in ops else "?"
            lines.append(
                f"{c.kind} on {c.data_name}{list(c.region)}: "
                f"task {c.pred} ({po}) -> task {c.succ} ({so}) unordered"
            )
        first = report.races[0]
        raise ScheduleVerificationError(
            "hazards",
            f"{len(report.races)} race(s) — dependence(s) missing from the "
            f"versioning DAG: " + "; ".join(lines),
            pair=(first.pred, first.succ),
        )
    return report


__all__ = [
    "Conflict",
    "HazardReport",
    "LostParallelismWarning",
    "analyze_hazards",
    "recompute_conflicts",
]
