"""The central dispatcher (paper §2.1): orchestrates task flow between the
program and the framework wrappers according to a task-flow graph.

Program-facing API is the paper's:  ``dispatcher.submit_task(t)`` during
program execution, ``dispatcher.run()`` (== ``utp_finalize``) to drain.

Semantics: tasks are expanded level by level.  A wave of ready tasks at
level ``l`` is split (each task's Operation creates children on the next
partition level, paper Fig. 2b); the union of their children forms the next
scope whose DAG is built by data versioning.  At ``graph.split_levels`` the
leaf executor runs the waves (DESIGN.md §2).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ..analysis.hazards import analyze_hazards
from .executors.base import Executor
from .executors.inline import InlineExecutor
from .executors.jit_wave import _DRAIN_MEMO, CudaExecutor, WaveExecutor
from .graph import TaskFlowGraph, get_graph
from .task import GTask, TaskState
from .versioning import DepTracker


def _make_executor(graph: TaskFlowGraph, on_finished) -> Executor:
    if graph.distributed:
        raise NotImplementedError(
            f"graph {graph.name} needs the sharded executor, which is not "
            "ported yet (ROADMAP queue A10)"
        )
    if graph.leaf_executor == "inline":
        return InlineExecutor(on_task_finished=on_finished)
    if graph.leaf_executor == "cuda":
        return CudaExecutor(on_task_finished=on_finished)
    return WaveExecutor(on_task_finished=on_finished)


class Dispatcher:
    def __init__(self, graph="g2", verify: Optional[bool] = None):
        self.graph = get_graph(graph) if isinstance(graph, str) else graph
        # Static verification (DESIGN.md §11): when on, every non-replay
        # scope is hazard-cross-checked and every planned schedule proven
        # legal before launch.  Default comes from REPRO_VERIFY ("" / "0"
        # = off) so whole test runs can opt in without code changes.
        if verify is None:
            verify = os.environ.get("REPRO_VERIFY", "") not in ("", "0")
        self.verify = bool(verify)
        self.executor = _make_executor(self.graph, self._on_finished)
        self.executor.verify = self.verify
        self._pending_roots: List[GTask] = []
        self._capture_valid = True
        self.finished_count = 0
        self.stats: Dict[str, int] = {
            "submitted": 0,
            "split": 0,
            "waves": 0,
            "memo_hits": 0,
            "memo_misses": 0,
            "verified_scopes": 0,
        }

    # -- paper-facing API ------------------------------------------------------
    def submit_task(self, task: GTask) -> None:
        task.state = TaskState.SUBMITTED
        self.stats["submitted"] += 1
        if task.parent is not None:
            task.parent.add_child(task)
        self._pending_roots.append(task)

    def task_finished(self, task: GTask) -> None:
        """Paper Fig. 2(a) line 36 — completion report from a leaf wrapper."""
        task.state = TaskState.FINISHED
        self._on_finished(task)

    def run(self) -> int:
        """Drain all submitted tasks; returns number of leaf tasks executed.

        Drain memo (DESIGN.md §2): task splitting is a pure function of the
        root tasks' operations and argument geometry, so a drain whose root
        stream structurally matches a previous one must produce the same
        leaf schedule.  The first such drain is captured (the sequence of
        launch-list executions); repeats skip Python re-splitting and
        re-versioning entirely and replay the lists on the fresh data.
        """
        roots, self._pending_roots = self._pending_roots, []
        before = self.finished_count
        key = self._drain_memo_key(roots)
        memo = _DRAIN_MEMO.get(key) if key is not None else None
        if memo is not None:
            self.stats["memo_hits"] += 1
            self._replay_drain(memo, roots)
            return self.finished_count - before
        if key is not None:
            self.stats["memo_misses"] += 1
        capturing = key is not None
        if capturing:
            slot_of = {
                d.id: i for i, d in enumerate(self._root_datas(roots))
            }
            self.executor.begin_capture(slot_of)
            stats_before = (self.stats["split"], self.stats["waves"])
            self._capture_valid = True
        try:
            self._process_scope(roots, level=0)
        except BaseException:
            # failed drain hardening (DESIGN.md §10): discard the partial
            # capture so no half-captured entry can reach the drain memo
            # and the executor's capture window is closed for the retry
            if capturing:
                self.executor.end_capture()
            raise
        if capturing:
            records, ok = self.executor.end_capture()
            if ok and self._capture_valid:
                _DRAIN_MEMO[key] = {
                    "records": records,
                    "leaf_total": self.finished_count - before,
                    "split": self.stats["split"] - stats_before[0],
                    "waves": self.stats["waves"] - stats_before[1],
                }
        return self.finished_count - before

    @staticmethod
    def _root_datas(roots: List[GTask]) -> List:
        """Root-argument data handles in first-appearance order — THE slot
        order; memo key, capture, and replay must all derive from this."""
        datas = []
        seen = set()
        for t in roots:
            for v in t.args:
                if v.data.id not in seen:
                    seen.add(v.data.id)
                    datas.append(v.data)
        return datas

    def _drain_memo_key(self, roots: List[GTask]) -> Optional[tuple]:
        """Structural key of a root-task stream, or None if not memoizable.

        Captures everything task expansion depends on: graph config,
        executor identity, and per root task the operation plus each
        argument's (data slot, region, level, root shape/dtype/device/
        partitions, access mode).  Data *identity* is slot-relative, so a
        fresh GData with the same geometry hits the memo.  The device is
        part of the key because a captured record holds its index tensor
        on the device it was planned for."""
        if not roots:
            return None
        if not hasattr(self.executor, "begin_capture"):
            return None
        if not all(t.op.memoizable for t in roots):
            return None
        slot_of = {d.id: i for i, d in enumerate(self._root_datas(roots))}
        parts: List[tuple] = [
            (self.graph.name, self.graph.split_levels),
            self.executor.memo_key_extra(),
        ]
        for t in roots:
            args = []
            for v, m in zip(t.args, t.modes):
                d = v.data
                slot = slot_of[d.id]
                r = v.region
                args.append(
                    (
                        slot,
                        (r.r0, r.c0, r.rows, r.cols),
                        v.level,
                        d.shape,
                        str(d.dtype),
                        str(d.device),
                        tuple(d.partitions),
                        m.value,
                    )
                )
            parts.append((t.op.name, tuple(args)))
        return tuple(parts)

    def _replay_drain(self, memo: dict, roots: List[GTask]) -> None:
        datas = self._root_datas(roots)
        for rec in memo["records"]:
            self.executor.replay_program(rec, [datas[s] for s in rec.root_slots])
        for t in roots:
            t.state = TaskState.FINISHED
        self.stats["split"] += memo["split"]
        self.stats["waves"] += memo["waves"]
        self.finished_count += memo["leaf_total"]

    # -- internal --------------------------------------------------------------
    def _on_finished(self, task: GTask) -> None:
        self.finished_count += 1
        parent = task.parent
        while parent is not None and parent.child_finished():
            parent.state = TaskState.FINISHED
            parent = parent.parent

    def _process_scope(self, tasks: List[GTask], level: int) -> None:
        if not tasks:
            return
        tracker = DepTracker()
        for t in tasks:
            tracker.add(t)
        waves = tracker.waves()
        self.stats["waves"] += len(waves)
        if level >= self.graph.split_levels:
            # hand over the exact task DAG, not just the level schedule:
            # the executor's scheduling pass issues dependency-exactly and
            # fuses groups across former wave boundaries (DESIGN.md §2)
            dag = tracker.dag()
            if self.verify:
                analyze_hazards(tasks, dag)
                self.stats["verified_scopes"] += 1
            self.executor.execute_schedule(waves, dag)
            return
        if self.verify:
            # inner scopes carry dependences too (a wrong inner-level wave
            # order reorders whole subtree expansions) — cross-check every
            # scope, not just the leaf one (DESIGN.md §11)
            analyze_hazards(tasks, tracker.dag())
            self.stats["verified_scopes"] += 1
        for wave in waves:
            children: List[GTask] = []

            def submit_child(child: GTask) -> None:
                if child.parent is not None:
                    child.parent.add_child(child)
                child.state = TaskState.SUBMITTED
                children.append(child)

            for t in wave:
                if t.op.can_split(t):
                    if not t.op.memoizable:
                        # value-dependent expansion somewhere below a
                        # memoizable root: this drain must not be replayed
                        self._capture_valid = False
                    t.state = TaskState.SPLIT
                    self.stats["split"] += 1
                    t.op.split(t, submit_child)
                    if not t.children:
                        # degenerate split (e.g. 1x1 partition): run as leaf
                        children.append(t)
                else:
                    children.append(t)
            self._process_scope(children, level + 1)
