"""SuperGlue-style data versioning -> dependency edges (paper refs [19, 22]).

The paper's frameworks discover dependencies at runtime from the order of
task submissions and the access modes of their data arguments.  We do the
same, but ahead of execution: the program's sequential submission order is
the *program order*, and the classic last-writer / readers-since-write
algorithm produces the task DAG edges.

Fast path: within one dispatcher scope all accessed regions share a uniform
block grid (hierarchical splitting always produces aligned equal blocks), so
exact-region hashing suffices.  If a program mixes region granularities on
one root datum we fall back to rectangle-overlap scanning, which is exact.

The tracker does not discard its edge DAG after ``waves()``: ``dag()``
exports the leaf-level task DAG (edges, predecessors, reachability) so the
WaveProgram scheduling pass can issue dependency-exactly and answer
fusion-legality queries (two task groups may share one batched launch iff
no path connects them — ``TaskDag.independent``; DESIGN.md §2).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Set, Tuple

import torch

from .data import Region
from .task import GTask


class TaskDag:
    """The leaf-level task DAG a scope's versioning discovered.

    Handed from the dispatcher to the executor alongside the Kahn level
    schedule (``Executor.execute_schedule``).  Provides the ground-truth
    fusion-legality query for the dependency-exact scheduling pass:
    reachability is computed once (bitsets over a topological order) and
    cached, so per-query cost is a few big-int ANDs.
    """

    def __init__(
        self,
        tasks: Dict[int, GTask],
        edges: Dict[int, Set[int]],
        preds: Dict[int, Set[int]],
    ):
        self.tasks = tasks
        self.edges = edges
        self.preds = preds
        self._pos: Optional[Dict[int, int]] = None
        self._reach: Optional[Dict[int, int]] = None
        self._height: Optional[Dict[int, int]] = None

    def _toposort(self) -> List[int]:
        indeg = {tid: len(self.preds.get(tid, ())) for tid in self.tasks}
        frontier = sorted(tid for tid, d in indeg.items() if d == 0)
        order: List[int] = []
        while frontier:
            order.extend(frontier)
            nxt: List[int] = []
            for tid in frontier:
                for succ in self.edges.get(tid, ()):
                    indeg[succ] -= 1
                    if indeg[succ] == 0:
                        nxt.append(succ)
            frontier = sorted(nxt)
        if len(order) != len(self.tasks):  # pragma: no cover - cycle = bug
            raise RuntimeError("cycle in task DAG (versioning bug)")
        return order

    def _closure(self) -> None:
        """Strict-descendant bitsets per task, over one topological order."""
        order = self._toposort()
        pos = {tid: i for i, tid in enumerate(order)}
        reach: Dict[int, int] = {}
        for tid in reversed(order):
            r = 0
            for succ in self.edges.get(tid, ()):
                r |= reach[succ] | (1 << pos[succ])
            reach[tid] = r
        self._pos, self._reach = pos, reach

    def independent(self, ids_a: Iterable[int], ids_b: Iterable[int]) -> bool:
        """Fusion legality: True iff NO path connects the two task sets.

        Two same-signature groups may be fused into one batched launch only
        when this holds in both directions — any connecting path means some
        third task must execute between them, so one launch cannot contain
        both ends (DESIGN.md §2, fusion legality rule).
        """
        if self._reach is None:
            self._closure()
        pos, reach = self._pos, self._reach
        mask_a = reach_a = 0
        for t in ids_a:
            mask_a |= 1 << pos[t]
            reach_a |= reach[t]
        mask_b = reach_b = 0
        for t in ids_b:
            mask_b |= 1 << pos[t]
            reach_b |= reach[t]
        return not (reach_a & mask_b) and not (reach_b & mask_a)

    def path(self, a: int, b: int) -> bool:
        """True iff a directed path ``a -> b`` exists (strict: no trivial
        self-path).  The static verifier's primitive (DESIGN.md §11): the
        hazard analysis asks it for every recomputed dependence pair, and
        ``verify_plan`` for every intra-group member pair — both O(1) once
        the reachability bitsets are built."""
        if self._reach is None:
            self._closure()
        return bool(self._reach[a] & (1 << self._pos[b]))

    def heights(self) -> Dict[int, int]:
        """Longest path (in tasks) from each task to a sink — the critical-
        path priority used for lookahead ordering (panel factorizations sit
        on long chains, trailing updates on short ones)."""
        if self._height is None:
            order = self._toposort()
            h: Dict[int, int] = {}
            for tid in reversed(order):
                succs = self.edges.get(tid, ())
                h[tid] = 1 + max((h[s] for s in succs), default=-1)
            self._height = h
        return self._height


class DepTracker:
    """Builds WAR/RAW/WAW edges from sequential task submission order."""

    def __init__(self):
        # (data_id, region) -> state
        self._last_writer: Dict[Tuple[int, Region], GTask] = {}
        self._readers: Dict[Tuple[int, Region], List[GTask]] = {}
        # data_id -> set of region shapes seen (uniformity check)
        self._shapes: Dict[int, Set[Tuple[int, int]]] = defaultdict(set)
        # data_id -> all access keys (for the overlap fallback)
        self._regions: Dict[int, List[Region]] = defaultdict(list)
        self.edges: Dict[int, Set[int]] = defaultdict(set)  # pred id -> succ ids
        self.preds: Dict[int, Set[int]] = defaultdict(set)  # succ id -> pred ids
        self.tasks: Dict[int, GTask] = {}

    def _add_edge(self, pred: GTask, succ: GTask) -> None:
        if pred.id == succ.id:
            return
        if succ.id not in self.edges[pred.id]:
            self.edges[pred.id].add(succ.id)
            self.preds[succ.id].add(pred.id)

    def add(self, task: GTask) -> None:
        """Register ``task``'s accesses; creates edges from earlier tasks.

        This is the first-drain hot loop (80-155 us/task of pure Python at
        seed), so the uniform-grid fast path avoids every avoidable
        allocation: no ``accesses()`` tuple list, no generator + ``list``
        materialization for the single conflicting key, and the readers
        list is cleared in place instead of replaced on each write.
        """
        self.tasks[task.id] = task
        last_writer = self._last_writer
        readers = self._readers
        for view, mode in zip(task.args, task.modes):
            data_id = view.data.id
            region = view.region
            shapes = self._shapes[data_id]
            shapes.add(region.shape)
            regions = self._regions[data_id]
            writes = mode.writes
            if len(shapes) <= 1:
                keys = ((data_id, region),)
            else:
                keys = [(data_id, o) for o in regions if o.overlaps(region)]
            for key in keys:
                lw = last_writer.get(key)
                if lw is not None:
                    # RAW for reads, WAW for writes: always after last writer
                    self._add_edge(lw, task)
                if writes:
                    # WAR: after all readers since that write
                    rs = readers.get(key)
                    if rs:
                        for r in rs:
                            self._add_edge(r, task)
            if region not in regions:
                regions.append(region)
            key = (data_id, region)
            if writes:
                last_writer[key] = task
                rs = readers.get(key)
                if rs:
                    rs.clear()
            else:
                rs = readers.get(key)
                if rs is None:
                    readers[key] = [task]
                else:
                    rs.append(task)

    # -- scheduling ----------------------------------------------------------
    def waves(self) -> List[List[GTask]]:
        """Kahn level schedule: wave k = tasks whose preds are all in waves <k."""
        indeg = {tid: len(self.preds.get(tid, ())) for tid in self.tasks}
        frontier = sorted(tid for tid, d in indeg.items() if d == 0)
        out: List[List[GTask]] = []
        done = 0
        while frontier:
            out.append([self.tasks[tid] for tid in frontier])
            done += len(frontier)
            nxt: List[int] = []
            for tid in frontier:
                for succ in self.edges.get(tid, ()):
                    indeg[succ] -= 1
                    if indeg[succ] == 0:
                        nxt.append(succ)
            frontier = sorted(nxt)
        if done != len(self.tasks):  # pragma: no cover - cycle = bug
            raise RuntimeError("cycle in task DAG (versioning bug)")
        return out

    def dag(self) -> TaskDag:
        """Export the leaf task DAG for dependency-exact scheduling.

        Shares (not copies) the tracker's edge structures: the tracker is
        per-scope and is dropped right after scheduling, while the DAG lives
        on through ``Executor.execute_schedule``."""
        return TaskDag(self.tasks, self.edges, self.preds)

    def sequential_order(self) -> List[GTask]:
        """Program (submission) order — the reference semantics."""
        return [self.tasks[tid] for tid in sorted(self.tasks)]


class InFlightEpoch:
    """One launched program's not-yet-finished device work (DESIGN.md §12).

    CUDA launches return before the card finishes, so the executor records
    one ``torch.cuda.Event`` on the current stream right after a drain's
    launch list.  Callers that need a fence (benchmarks, result checks)
    block on it once, at a point of their choosing.  On the CPU every
    operation has finished when it returns, so the epoch is born complete
    (``event`` is None).
    """

    __slots__ = ("event", "label")

    def __init__(self, device: torch.device, label: str = ""):
        self.label = label
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def is_ready(self) -> bool:
        """Non-blocking: True iff the recorded work has finished."""
        return self.event is None or self.event.query()

    def wait(self) -> float:
        """Block until the recorded work finishes; returns the seconds the
        host spent blocked.  Device-side faults surface here, not at
        launch."""
        t0 = time.perf_counter()
        if self.event is not None:
            self.event.synchronize()
        return time.perf_counter() - t0
