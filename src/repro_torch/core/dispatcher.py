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
import time
from typing import Dict, List, Optional

from ..analysis.hazards import analyze_hazards
from ..analysis.verify import verify_stacked_members
from ..errors import DrainStalledError
from ..testing import faults
from .executors.base import Executor
from .executors.inline import InlineExecutor
from .executors.jit_wave import _DRAIN_MEMO, CudaExecutor, WaveExecutor
from .executors.sharded import ShardExecutor
from .graph import TaskFlowGraph, get_graph
from .task import GTask, TaskState
from .versioning import DepTracker, InFlightEpoch


def _make_executor(graph: TaskFlowGraph, mesh, on_finished) -> Executor:
    if graph.distributed:
        if mesh is None:
            raise ValueError(f"graph {graph.name} is distributed but mesh is None")
        backend = "cuda" if graph.leaf_executor == "cuda" else "torch"
        return ShardExecutor(
            mesh, backend=backend, shard_axes=graph.shard_axes,
            on_task_finished=on_finished,
        )
    if graph.leaf_executor == "inline":
        return InlineExecutor(on_task_finished=on_finished)
    if graph.leaf_executor == "cuda":
        return CudaExecutor(on_task_finished=on_finished)
    return WaveExecutor(on_task_finished=on_finished)


class DrainHandle:
    """Handle over one overlapped (asynchronously launched) drain
    (DESIGN.md §12).

    ``run_async`` returns it right after the drain's kernels have been
    LAUNCHED — the card keeps executing while the host plans the next
    drain.  ``wait()`` is the optional fence; it also carries the in-flight
    extension of the capture-window hardening: a drain that fails AFTER
    launch (device-side error, injected ``drain.inflight`` fault) may have
    stored drain-memo entries this execution can no longer vouch for, so a
    failing ``wait`` discards exactly the keys this drain wrote before
    re-raising — the next healthy occurrence simply re-captures them.
    """

    def __init__(
        self,
        leaves: int,
        epochs: List[InFlightEpoch],
        memo_keys: List[tuple],
    ):
        self.leaves = leaves
        self.epochs = epochs
        self._memo_keys = memo_keys

    def is_ready(self) -> bool:
        """Non-blocking: True iff every launch has finished on the device."""
        return all(ep.is_ready() for ep in self.epochs)

    def invalidate_memo(self) -> None:
        """Discard the drain-memo entries this drain stored (idempotent)."""
        keys, self._memo_keys = self._memo_keys, []
        for key in keys:
            _DRAIN_MEMO.discard(key)

    def wait(self, timeout: Optional[float] = None) -> float:
        """Fence: block until every launch has finished; returns host
        seconds spent blocked.  Epochs are fenced in launch order.

        ``timeout`` (seconds) arms the hung-drain watchdog (DESIGN.md §14):
        a CUDA event wait cannot be interrupted, so the budget is a polling
        deadline — readiness is polled until the wall clock expires, at
        which point this drain's memo keys are invalidated and a
        ``DrainStalledError`` raised.  The hung kernels' device resources
        are NOT reclaimed (only a process restart does that); the watchdog
        bounds how long the host-side tick loop can be held hostage,
        nothing more.
        """
        try:
            if timeout is not None:
                deadline = time.monotonic() + timeout
                # The stall site fires BEFORE the first readiness poll so an
                # injected delay_s fault deterministically blows the budget
                # even when results are already finished.
                faults.fire(
                    "drain.stall", epochs=len(self.epochs), leaves=self.leaves
                )
                while not self.is_ready():
                    if time.monotonic() >= deadline:
                        raise DrainStalledError(
                            f"drain fence not ready within {timeout:.3f}s "
                            f"budget ({len(self.epochs)} epoch(s), "
                            f"{self.leaves} leaves)"
                        )
                    time.sleep(min(0.001, timeout / 10))
                if time.monotonic() >= deadline:
                    raise DrainStalledError(
                        f"drain fence blew its {timeout:.3f}s budget "
                        f"({len(self.epochs)} epoch(s), {self.leaves} leaves)"
                    )
            faults.fire(
                "drain.inflight", epochs=len(self.epochs), leaves=self.leaves
            )
            return sum(ep.wait() for ep in self.epochs)
        except BaseException:
            self.invalidate_memo()
            raise


class _StackedAbort(Exception):
    """Raised when a collect-mode expansion hits a value-dependent
    (non-memoizable) split: such an expansion may read values that earlier
    leaf scopes would have computed, and in collect mode nothing has
    executed yet — the stacked path must abort BEFORE that split runs and
    redo the drain through the normal interleaved expand/execute path."""


class Dispatcher:
    def __init__(
        self,
        graph="g2",
        mesh=None,
        stack_roots: bool = True,
        verify: Optional[bool] = None,
    ):
        self.graph = get_graph(graph) if isinstance(graph, str) else graph
        # Static verification (DESIGN.md §11): when on, every non-replay
        # scope is hazard-cross-checked and every planned schedule proven
        # legal before launch.  Default comes from REPRO_VERIFY ("" / "0"
        # = off) so whole test runs can opt in without code changes.
        if verify is None:
            verify = os.environ.get("REPRO_VERIFY", "") not in ("", "0")
        self.verify = bool(verify)
        self.mesh = mesh
        self.executor = _make_executor(self.graph, mesh, self._on_finished)
        self.executor.verify = self.verify
        # Homogeneous-root stacking (DESIGN.md §7): a drain whose root
        # stream is N structurally identical, data-disjoint tasks runs as
        # ONE batched launch list over a pow2-padded batch axis instead of N
        # fused per-root segments.  ``stack_roots=False`` pins the
        # segment-fusion behaviour (``run_lu_many``, the comparison baseline).
        self.stack_roots = stack_roots
        self._pending_roots: List[GTask] = []
        self._capture_valid = True
        # drain-memo keys stored by the CURRENT drain — handed to the
        # DrainHandle so an in-flight failure can invalidate exactly them
        self._drain_keys: List[tuple] = []
        self.finished_count = 0
        self.stats: Dict[str, int] = {
            "submitted": 0,
            "split": 0,
            "waves": 0,
            "memo_hits": 0,
            "memo_misses": 0,
            "stacked_drains": 0,
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
        # Homogeneous-root stacking (DESIGN.md §7): N structurally identical
        # roots drain as ONE batched list over a pow2-bucketed batch axis;
        # the returned leaf count is then the TEMPLATE's (each leaf computes
        # all N lanes at once).  Heterogeneous streams keep per-root
        # expansion + cross-root segment fusion.
        roots, self._pending_roots = self._pending_roots, []
        before = self.finished_count
        self._drain_keys = []
        if self.stack_roots and self._stackable(roots):
            self._run_stacked(roots)
            return self.finished_count - before
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
                self._drain_keys.append(key)
        return self.finished_count - before

    def run_async(self) -> DrainHandle:
        """Drain all submitted tasks WITHOUT fencing device execution.

        Identical host-side work to ``run()`` — expansion, versioning,
        planning, memoization and kernel launches all happen now — but the
        kernels execute asynchronously: the returned ``DrainHandle``
        carries the drain's in-flight epochs so the caller can overlap the
        next drain's host work with this one's device work and fence later.
        Synchronous executors return an already-complete handle, so callers
        need no capability check (DESIGN.md §12)."""
        leaves = self.run()
        return DrainHandle(
            leaves, self.executor.take_inflight(), list(self._drain_keys)
        )

    # -- homogeneous-root stacking (DESIGN.md §7) ------------------------------
    def _stackable(self, roots: List[GTask]) -> bool:
        """True iff the root stream is a batch of structurally identical,
        data-disjoint tasks the executor can stack (DESIGN.md §7): same
        operation singleton, same per-arg geometry (region, level, shape,
        dtype, device, partitions, mode), every argument datum private to
        its root, and an executor with the stacked path.  Distributed graphs
        never stack."""
        if len(roots) < 2 or self.graph.distributed:
            return False
        if not hasattr(self.executor, "execute_stacked"):
            return False
        t = roots[0]
        if not t.op.memoizable:
            return False
        seen_ids = set()
        for r in roots:
            if r.op is not t.op or len(r.args) != len(t.args):
                return False
            for v, tv, m, tm in zip(r.args, t.args, r.modes, t.modes):
                d, td = v.data, tv.data
                if (
                    m is not tm
                    or v.region != tv.region
                    or v.level != tv.level
                    or d.shape != td.shape
                    or d.dtype != td.dtype
                    or d.device != td.device
                    or tuple(d.partitions) != tuple(td.partitions)
                ):
                    return False
                if d.id in seen_ids or not d.has_value:
                    return False
                seen_ids.add(d.id)
        return True

    def _stacked_members(self, roots: List[GTask]) -> List[List]:
        """Per template root slot, the member data handles across requests
        (template = roots[0]; slot order = first-appearance arg order)."""
        arg_pos: List[int] = []
        seen = set()
        for j, v in enumerate(roots[0].args):
            if v.data.id not in seen:
                seen.add(v.data.id)
                arg_pos.append(j)
        return [[r.args[j].data for r in roots] for j in arg_pos]

    def _run_stacked(self, roots: List[GTask]) -> None:
        """Drain a homogeneous root stream as ONE batched launch-list set.

        Only the TEMPLATE root (roots[0]) is expanded — splitting is a pure
        function of geometry, and all roots share it.  The batch count is
        padded to a pow2 bucket, so any N hits one of O(log N) built lists
        and the drain-memo key is independent of the exact N.  Falls back
        internally (the whole drain through the normal path) when the
        executor cannot take the whole-program stacked path."""
        template = roots[0]
        n = len(roots)
        bucket = 1
        while bucket < n:
            bucket *= 2
        before = self.finished_count
        base_key = self._drain_memo_key([template])
        key = None if base_key is None else base_key + (("stacked", bucket),)
        memo = _DRAIN_MEMO.get(key) if key is not None else None
        members = self._stacked_members(roots)
        if faults.fires("plan.alias_lane", n_lanes=n):
            # corrupt the lane map BEFORE the memo branch so both the
            # capture and the replay path see the aliased lanes
            members = [[ms[0], ms[0], *ms[2:]] for ms in members]
        if self.verify:
            # V5 runs on every stacked drain (replays included): lane
            # membership is per-drain data identity, not plan structure,
            # so it cannot ride the structural verdict cache — but it is
            # one O(lanes) set walk, not a re-verification of the plan.
            verify_stacked_members(members)
        if memo is not None:
            self.stats["memo_hits"] += 1
            self.stats["stacked_drains"] += 1
            for rec in memo["records"]:
                self.executor.replay_program(
                    rec, [members[s] for s in rec.root_slots]
                )
            for t in roots:
                t.state = TaskState.FINISHED
            self.stats["split"] += memo["split"]
            self.stats["waves"] += memo["waves"]
            self.finished_count += memo["leaf_total"]
            return
        capturing = key is not None
        stats_before = (self.stats["split"], self.stats["waves"])
        if capturing:
            self.stats["memo_misses"] += 1
            slot_of = {
                d.id: i for i, d in enumerate(self._root_datas([template]))
            }
            self.executor.begin_capture(slot_of)
            self._capture_valid = True
        schedules: List[tuple] = []
        try:
            self._process_scope([template], level=0, collect=schedules)
        except _StackedAbort:
            done = None
        except BaseException:
            if capturing:
                self.executor.end_capture()
            raise
        else:
            slot_datas = self._root_datas([template])
            member_of = {d.id: ms for d, ms in zip(slot_datas, members)}
            try:
                done = self.executor.execute_stacked(schedules, member_of, bucket)
            except BaseException:
                # failed drain hardening (DESIGN.md §10): close the capture
                # window so no half-captured entry survives into the memo
                if capturing:
                    self.executor.end_capture()
                raise
        if done is None:
            # stacked path unavailable (non-grid-uniform schedule, or a
            # value-dependent split aborted the collect): discard the
            # template pre-expansion (its orphaned children never execute)
            # and redo the WHOLE drain through the normal path — all roots
            # in one scope, so cross-root segment fusion is kept.  No memo
            # for this drain (the template stats were rolled back, and the
            # root-level capture window has already been consumed).
            if capturing:
                self.executor.end_capture()
            self.stats["split"], self.stats["waves"] = stats_before
            self._process_scope(roots, level=0)
            for t in roots:
                t.state = TaskState.FINISHED
            return
        self.stats["stacked_drains"] += 1
        if capturing:
            records, ok = self.executor.end_capture()
            if ok and self._capture_valid:
                _DRAIN_MEMO[key] = {
                    "records": records,
                    "leaf_total": self.finished_count - before,
                    "split": self.stats["split"] - stats_before[0],
                    "waves": self.stats["waves"] - stats_before[1],
                }
                self._drain_keys.append(key)
        for t in roots:
            t.state = TaskState.FINISHED

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

    def _process_scope(
        self, tasks: List[GTask], level: int, collect: Optional[List] = None
    ) -> None:
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
            # fuses groups across former wave boundaries (DESIGN.md §2).
            # ``collect`` gathers the leaf schedules instead of executing
            # (the stacked drain path plans them all before running any)
            dag = tracker.dag()
            if faults.fires("plan.drop_edge", level=level, n_tasks=len(tasks)):
                faults.mutate_drop_edges(dag)
            if self.verify:
                analyze_hazards(tasks, dag)
                self.stats["verified_scopes"] += 1
            if collect is not None:
                collect.append((waves, dag))
            else:
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
                    # the fault site makes a matched split behave exactly
                    # like a value-dependent (non-memoizable) one, so the
                    # _StackedAbort fallback and the capture opt-out are
                    # exercisable without a bespoke Operation (DESIGN.md §10)
                    if not t.op.memoizable or faults.fires(
                        "split.value_dependent", op=t.op.name, level=level
                    ):
                        if collect is not None:
                            # collect mode defers all execution, but a
                            # value-dependent split may read values earlier
                            # leaf scopes produce — abort BEFORE it runs
                            raise _StackedAbort()
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
            self._process_scope(children, level + 1, collect)
