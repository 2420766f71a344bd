"""Wave-batched executor — the SuperGlue wrapper analog on the card.

SuperGlue runs ready tasks on multicore threads; the GPU-idiomatic
equivalent batches every group of independent same-signature tasks into
ONE kernel launch, so the card sees one grid of CTAs instead of many tiny
launches (DESIGN.md §2).

Primary path (``execute_schedule``): the dispatcher's whole leaf schedule
plus its exact task DAG is planned by ``plan_schedule`` and run as one
cached launch list (``build_program``) over grid-resident roots —
dependency-exact issue slots, same-signature groups fused across former
wave boundaries (also across roots), one list per drain.  Roots stay in
``(nr, nc, br, bc)`` layout for the epoch and are updated in place.  A
"compile" is a launch-list build on a cache miss; a "launch" is one run of
a list.

Fallback path (``execute_wave``/``_run_group``): per-wave-group launches
over root-layout tensors, used when the schedule is not grid-uniform
(mixed block shapes or unaligned regions on one root).  Each group runs at
its exact size; written roots are copied once per drain, then updated in
place.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...analysis.verify import verify_plan
from ..data import GData
from ..task import GTask, TaskState
from ..versioning import InFlightEpoch
from .base import Executor, group_wave
from .wave_program import SchedulePlan, build_program, plan_schedule

# process-global launch-list cache: keys are purely structural (op names,
# backend, shapes, dtypes, schedule structure) so every Dispatcher instance
# reuses the same lists.  Holds both per-group functions ("group", ...) and
# whole-schedule lists ("waveprog", ...).
_GROUP_FN_CACHE: Dict[tuple, callable] = {}


class DrainMemo:
    """Bounded LRU drain memo with hit/miss/eviction counters (DESIGN.md §2).

    Structural root-task-stream key -> the captured sequence of launch-list
    executions for a whole dispatcher drain, so a structurally
    repeated drain skips Python re-splitting/re-versioning and replays the
    programs directly.  A long-running server sees an unbounded stream of
    distinct request signatures, so the memo must not grow without bound:
    entries evict least-recently-used past ``capacity`` (an evicted drain is
    simply re-captured on its next occurrence — correctness is unaffected).
    Counters are read through ``drain_memo_stats``.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple):
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def __setitem__(self, key: tuple, entry: object) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        return key in self._entries

    def clear(self) -> None:
        self._entries.clear()


# owned here (not in dispatcher.py) so one clear call drops every cached
# artifact; counters are process-global like the launch-list cache
_DRAIN_MEMO = DrainMemo()


def drain_memo_stats() -> Dict[str, int]:
    """Entries/capacity/hits/misses/evictions of the global drain memo."""
    return _DRAIN_MEMO.stats()


def clear_compile_cache() -> None:
    """Drop all cached launch lists / group fns / drain memos."""
    _GROUP_FN_CACHE.clear()
    _DRAIN_MEMO.clear()


@dataclass(frozen=True)
class ProgramRecord:
    """One launch-list execution inside a captured drain.

    ``root_slots`` index into the drain's root-argument data order; the
    dispatcher resolves them to fresh ``GData`` objects on replay.
    ``idxs`` is the plan's device-resident flat index tensor — replay
    reuses it as-is, no host concatenation or transfer."""

    fn: object  # the launch list
    root_slots: Tuple[int, ...]
    blocks: Tuple[Tuple[int, int], ...]  # per-root leaf block shape
    idxs: torch.Tensor  # flat (total, 2) int32 block indices (device)
    n_tasks: int
    n_groups: int = 0  # fused launch count inside the list
    n_groups_prefusion: int = 0  # barrier-wave group count before fusion
    n_slots: int = 0  # dependency-exact issue slots


class WaveExecutor(Executor):
    """Counterpart of the JAX package's ``JitWaveExecutor``."""

    name = "wave"

    def __init__(self, backend: str = "torch", **kw):
        super().__init__(**kw)
        self.backend = backend
        self._fn_cache = _GROUP_FN_CACHE
        # drain-capture state (dispatcher memo protocol)
        self._capture: Optional[List[ProgramRecord]] = None
        self._capture_ids: Dict[int, int] = {}
        self._capture_ok = True
        # the last launch's (list or fallback group) in-flight device work
        # (DESIGN.md §12):
        # launches are asynchronous, so a caller that needs a fence waits
        # on it, and the wait splits host dispatch time from the device tail
        self.epoch: Optional[InFlightEpoch] = None

    # -- drain capture/replay protocol (DESIGN.md §2) --------------------------
    def memo_key_extra(self) -> tuple:
        """Executor-identity part of the dispatcher's drain-memo key."""
        return (self.name, self.backend)

    def begin_capture(self, root_slot_of: Dict[int, int]) -> None:
        """Start recording list executions; ``root_slot_of`` maps the
        drain's root-argument data ids to stable slots."""
        self._capture = []
        self._capture_ids = dict(root_slot_of)
        self._capture_ok = True

    def end_capture(self):
        """Stop recording; returns (records, ok).  ``ok`` is False when any
        leaf work bypassed the WaveProgram path (per-group fallback) or
        touched a datum that is not a root argument — such drains are not
        memoized."""
        records, ok = self._capture, self._capture_ok
        self._capture = None
        self._capture_ids = {}
        return records or [], ok and bool(records)

    def replay_program(self, rec: ProgramRecord, datas: List[GData]) -> int:
        """Re-execute a captured list against fresh data handles."""
        grids = [d.enter_grid(*blk) for d, blk in zip(datas, rec.blocks)]
        rec.fn(grids, rec.idxs)
        self.epoch = InFlightEpoch(grids[0].device, "replay")
        self.stats["tasks"] += rec.n_tasks
        self.stats["launches"] += 1
        self.stats["groups"] += rec.n_groups
        self.stats["groups_prefusion"] += rec.n_groups_prefusion
        self.stats["slots"] += rec.n_slots
        return rec.n_tasks

    # -- whole-schedule path (DESIGN.md §2) ------------------------------------
    def execute_schedule(self, waves: List[List[GTask]], dag=None) -> int:
        """Dependency-exact execution of a whole leaf schedule."""
        waves = [w for w in waves if w]
        if not waves:
            return 0
        plan = plan_schedule(waves, dag)
        if plan is None:
            self._capture_ok = False
            self._own_written_roots(t for w in waves for t in w)
            return sum(self.execute_wave(wave) for wave in waves)
        if self.verify and dag is not None:
            # prove the plan before launching it (DESIGN.md §11): V3/V4
            # (distinct write blocks within a slot) are what make the fused
            # kernels' parallel in-place CTAs race-free
            verify_plan(plan, dag)
            self.stats["verified_plans"] += 1
        return self._run_program(plan)

    def execute_waves(self, waves: List[List[GTask]]) -> int:
        return self.execute_schedule(waves)

    def _run_program(self, plan: SchedulePlan) -> int:
        """Build-or-fetch and run one planned launch list."""
        datas = [plan.datas[d] for d in plan.roots_order]
        grids = [d.enter_grid(*blk) for d, blk in zip(datas, plan.blocks)]
        key = ("waveprog", self.memo_key_extra()) + plan.key
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = build_program(plan, self.backend)
            self._fn_cache[key] = fn
            self.stats["compiles"] += 1
        idxs = plan.flat_idxs  # built once at plan time, device-resident
        fn(grids, idxs)
        self.epoch = InFlightEpoch(idxs.device, "program")
        if self._capture is not None:
            slots = tuple(self._capture_ids.get(d, -1) for d in plan.roots_order)
            if -1 in slots:
                self._capture_ok = False  # touches a non-root-arg datum
            else:
                self._capture.append(
                    ProgramRecord(
                        fn,
                        slots,
                        plan.blocks,
                        idxs,
                        len(plan.tasks),
                        plan.n_groups,
                        plan.n_groups_prefusion,
                        plan.n_slots,
                    )
                )
        for t in plan.tasks:
            t.state = TaskState.FINISHED
            self.stats["tasks"] += 1
            self._finished(t)
        self.stats["launches"] += 1
        self.stats["groups"] += plan.n_groups
        self.stats["groups_prefusion"] += plan.n_groups_prefusion
        self.stats["slots"] += plan.n_slots
        return len(plan.tasks)

    # -- per-group fallback path -----------------------------------------------
    def _build_group_fn(
        self,
        op,
        slots: Tuple[int, ...],
        block_shapes: Tuple[Tuple[int, int], ...],
        root_dtypes: Tuple,
        write_pos: Tuple[int, ...],
    ):
        batched = op.batched_leaf_fn(self.backend)

        def fn(roots: List[torch.Tensor], idxs: Sequence[torch.Tensor]) -> None:
            """Gather every block, run the batched leaf, then scatter the
            written blocks into ``roots`` in place (root layout, viewed as
            ``(nr, br, nc, bc)``)."""
            blocks = []
            for a, slot in enumerate(slots):
                br, bc = block_shapes[a]
                r, c = roots[slot].shape
                g = roots[slot].view(r // br, br, c // bc, bc)
                blocks.append(g[idxs[a][:, 0], :, idxs[a][:, 1], :])
            outs = batched(*blocks)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for out, a in zip(outs, write_pos):
                slot = slots[a]
                br, bc = block_shapes[a]
                r, c = roots[slot].shape
                g = roots[slot].view(r // br, br, c // bc, bc)
                g[idxs[a][:, 0], :, idxs[a][:, 1], :] = out.to(root_dtypes[slot])

        return fn

    def _group_fn(self, op, rep: GTask, roots_order: Tuple[int, ...]):
        slot_of = {d: i for i, d in enumerate(roots_order)}
        slots = tuple(slot_of[v.data.id] for v in rep.args)
        block_shapes = tuple(v.region.shape for v in rep.args)
        roots = {v.data.id: v.data for v in rep.args}
        root_shapes = tuple(roots[d].shape for d in roots_order)
        root_dtypes = tuple(roots[d].dtype for d in roots_order)
        write_pos = tuple(i for i, m in enumerate(rep.modes) if m.writes)
        key = (
            "group",
            op.name,
            self.backend,
            slots,
            block_shapes,
            root_shapes,
            root_dtypes,
            write_pos,
        )
        if key not in self._fn_cache:
            self._fn_cache[key] = self._build_group_fn(
                op, slots, block_shapes, root_dtypes, write_pos
            )
            self.stats["compiles"] += 1
        return self._fn_cache[key]

    @staticmethod
    def _own_written_roots(tasks) -> None:
        """Give every root a task writes fresh storage, once per drain: the
        groups update root tensors in place and a caller may hold the
        current ones (see core/data.py)."""
        written = {v.data.id: v.data for t in tasks
                   for v, m in zip(t.args, t.modes) if m.writes}
        for d in written.values():
            degrids = d.in_grid_epoch  # de-gridding returns fresh storage
            value = d.value
            if not degrids:
                d.value = value.clone()

    def execute_wave(self, wave: List[GTask]) -> int:
        """Run one wave group by group, in place on the roots' current
        tensors (``execute_schedule`` first gives written roots storage of
        their own)."""
        for key, tasks in group_wave(wave).items():
            self._run_group(tasks)
        return len(wave)

    def _run_group(self, tasks: List[GTask]) -> None:
        rep = tasks[0]
        op = rep.op
        # stable unique root order
        roots_order: List[int] = []
        for v in rep.args:
            if v.data.id not in roots_order:
                roots_order.append(v.data.id)
        roots_order = tuple(roots_order)
        data_of = {v.data.id: v.data for t in tasks for v in t.args}
        fn = self._group_fn(op, rep, roots_order)
        # the exact batch: the group fn is eager, so unlike the JAX
        # package's jitted one there is no per-shape compile to bound
        device = data_of[roots_order[0]].device
        idxs = tuple(
            torch.from_numpy(
                np.array([t.args[a].block_index() for t in tasks], dtype=np.int32)
            ).to(device)
            for a in range(len(rep.args))
        )
        fn([data_of[d].value for d in roots_order], idxs)
        self.epoch = InFlightEpoch(device, "group")
        for t in tasks:
            t.state = TaskState.FINISHED
            self.stats["tasks"] += 1
            self._finished(t)
        self.stats["launches"] += 1


class CudaExecutor(WaveExecutor):
    """cuBLAS wrapper analog, counterpart of the JAX package's
    ``PallasExecutor``: identical wave batching, hand-written CUDA tile
    kernels as leaves.  Single-segment groups call the fused grid kernels
    (gather, compute and write back in one kernel, in place); on CPU
    tensors the kernels' plain PyTorch versions run instead."""

    name = "cuda"

    def __init__(self, **kw):
        kw.setdefault("backend", "cuda")
        super().__init__(**kw)
