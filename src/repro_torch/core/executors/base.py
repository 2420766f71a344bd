"""Unified executor (framework-wrapper) interface — paper §2.1.

The paper requires every framework wrapper to implement predefined
interfaces for data definition and task creation/submission/execution/
completion so the dispatcher can talk to any of them generically.  Here the
interface is ``execute_schedule``: the dispatcher hands over the Kahn level
schedule (list of waves of independent tasks) together with the exact task
DAG behind it (``versioning.TaskDag``), so capable executors can issue
dependency-exactly and fuse groups across wave boundaries; ``execute_waves``
is the DAG-less barrier form.  Completion is reported back via the returned
count (synchronous SPMD world) and the per-task callback for the
paper-faithful eager path.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..task import GTask


def group_wave(wave: Sequence[GTask]) -> Dict[tuple, List[GTask]]:
    """Group independent tasks by (op, arg signature) for batched execution.

    Signature captures everything static about the batched launch: operation
    name, per-arg access mode, root datum and block shape.  Tasks sharing a
    signature differ only in block *indices* -> one batched/fused-kernel
    launch.  Modes are part of the key because the fused launch scatters by
    the GROUP's write positions: two same-op tasks whose mode vectors
    differ must never share a launch or the minority task's writes would be
    dropped (registry operations have fixed modes, so for real workloads
    this never splits a group — but the invariant must hold for any task
    stream the dispatcher accepts).
    """
    groups: Dict[tuple, List[GTask]] = defaultdict(list)
    for t in wave:
        key = (
            t.op.name,
            tuple(t.modes),
            tuple((v.data.id, v.region.shape) for v in t.args),
        )
        groups[key].append(t)
    return groups


class Executor:
    """Base wrapper. ``name`` identifies it in task-flow graph configs."""

    name = "base"

    def __init__(self, on_task_finished: Optional[Callable[[GTask], None]] = None):
        self.on_task_finished = on_task_finished
        self.stats = defaultdict(int)
        # Static verification flag (DESIGN.md §11), set by the owning
        # Dispatcher.  It lives on the executor — not only on dispatcher
        # drain paths — so EVERY route into plan_schedule is covered.
        self.verify = False

    def execute_schedule(self, waves: List[List[GTask]], dag=None) -> int:
        """Run a leaf schedule: the Kahn level waves plus (optionally) the
        exact task DAG behind them (``versioning.TaskDag``).

        Executors that can exploit the DAG — dependency-exact issue slots,
        cross-wave group fusion — override this; the default ignores it and
        runs the barrier-wave schedule, which is always a correct (if
        conservative) linearization of the DAG."""
        return self.execute_waves(waves)

    def execute_waves(self, waves: List[List[GTask]]) -> int:
        """Run all waves in order; within a wave tasks are independent."""
        n = 0
        for wave in waves:
            n += self.execute_wave(wave)
        return n

    def execute_wave(self, wave: List[GTask]) -> int:
        raise NotImplementedError

    def _finished(self, task: GTask) -> None:
        if self.on_task_finished is not None:
            self.on_task_finished(task)
