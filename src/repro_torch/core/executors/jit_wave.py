"""Wave-batched executor — the SuperGlue wrapper analog on the card.

SuperGlue runs ready tasks on multicore threads; the GPU-idiomatic
equivalent batches every group of independent same-signature tasks into
ONE kernel launch, so the card sees one grid of CTAs instead of many tiny
launches (DESIGN.md §2).

Primary path (``execute_schedule``): the dispatcher's whole leaf schedule
plus its exact task DAG is planned by ``plan_schedule`` and run as one
launch list (``build_program``) over grid-resident roots —
dependency-exact issue slots, same-signature groups fused across former
wave boundaries (also across roots), one list per drain.  The list is
captured once per structural key into a CUDA graph over static grids
(``captured.CapturedProgram``), the counterpart of the JAX package's
``jax.jit``: a "compile" is a list built and captured on a cache miss, a
"launch" one replay of it.
Roots stay in ``(nr, nc, br, bc)`` layout for the epoch: each run copies
them into the static grids and hands those back to their handles.

Stacked path (``execute_stacked``, DESIGN.md §7): a homogeneous root
stream runs ONE list over ``(B, nr, nc, br, bc)`` stacked grids with B
padded to a pow2 bucket — captured lists and the drain memo key depend on
the bucket, never on the exact request count, and results hand back as
lazily extracted lanes of a shared ``StackedEpoch``.

Fallback path (``execute_wave``/``_run_group``): per-wave-group launches
over root-layout tensors, used when the schedule is not grid-uniform
(mixed block shapes or unaligned regions on one root).  Each group runs at
its exact size; written roots are copied once per drain, then updated in
place.
"""

from __future__ import annotations

import gc
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...analysis.verify import verify_plan
from ...testing import faults
from ..data import host_to_device
from ..task import GTask, TaskState
from ..versioning import InFlightEpoch
from .base import Executor, group_wave
from .captured import CapturedProgram
from .wave_program import SchedulePlan, build_program, plan_schedule

# process-global launch-list cache: keys are purely structural (op names,
# backend, shapes, dtypes, schedule structure) so every Dispatcher instance
# reuses the same lists.  Holds both per-group functions ("group", ...) and
# whole-schedule lists ("waveprog", ...); a list is a small closure, its
# device state lives in the captured programs below.
_GROUP_FN_CACHE: Dict[tuple, callable] = {}


class DrainMemo:
    """Bounded LRU with hit/miss/eviction counters (DESIGN.md §2): the drain
    memo, and the cache of captured programs.

    As the drain memo: structural root-task-stream key -> the captured
    sequence of launch-list executions for a whole dispatcher drain, so a
    structurally repeated drain skips Python re-splitting/re-versioning and
    replays the programs directly.  A long-running server sees an unbounded
    stream of distinct request signatures, so the memo must not grow without
    bound: entries evict least-recently-used past ``capacity`` (an evicted
    drain is simply re-captured on its next occurrence — correctness is
    unaffected).  Counters are read through ``drain_memo_stats``.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.pressure_sheds = 0

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

    def set_capacity(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"drain memo capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def discard(self, key: tuple) -> None:
        """Drop one entry (no-op if absent) — the in-flight failure
        hardening hook (DESIGN.md §12): a drain whose launches FAILED after
        they were issued may have captured/refreshed an entry this drain can
        no longer vouch for, so the dispatcher's ``DrainHandle`` invalidates
        exactly the keys it stored.  Counted as an invalidation (the entry
        is simply re-captured on the next healthy occurrence)."""
        if key in self._entries:
            del self._entries[key]
            self.invalidations += 1

    def shed(self) -> int:
        """Evict the least-recently-used half of the entries; returns the
        count shed.  The memory-pressure hook (DESIGN.md §14): a device
        OOM means resident state must shrink NOW, and memo entries pin
        device-side index tensors plus launch-list references — the LRU
        tail is exactly the state least likely to be replayed soon.
        Correctness is unaffected (a shed drain re-captures on its next
        occurrence); counted under ``pressure_sheds``."""
        n = max(1, len(self._entries) // 2) if self._entries else 0
        for _ in range(n):
            self._entries.popitem(last=False)
        self.pressure_sheds += n
        return n

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "pressure_sheds": self.pressure_sheds,
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
# (launch list, device) -> CapturedProgram.  A list is built once per
# structural key and stays in _GROUP_FN_CACHE until a clear, which drops
# these too, so the list stands for its key here (the key itself lists every
# group, and hashing it on each replay costs host time).  Each program pins
# a root's worth of static storage and a graph memory pool (64 MiB of grid
# for n = 4096), so the cache is bounded: a dropped program is captured
# again on its next drain (``recaptures``).
_PROGRAMS = DrainMemo(capacity=64)


def set_drain_memo_capacity(capacity: int) -> None:
    """Configure the LRU bound of the process-global drain memo."""
    _DRAIN_MEMO.set_capacity(capacity)


def drain_memo_stats() -> Dict[str, int]:
    """Entries/capacity/hits/misses/evictions of the global drain memo."""
    return _DRAIN_MEMO.stats()


def program_cache_stats() -> Dict[str, int]:
    """Entries/capacity/hits/misses/evictions of the captured programs."""
    return _PROGRAMS.stats()


def drain_memo_pressure() -> int:
    """Shed the LRU half of the global drain memo and of the captured
    programs (DESIGN.md §14).

    The memory-pressure callback: called by the serving layer on a device
    OOM so resident launch-list state (static grids, graph pools) shrinks
    alongside the batch-cap degradation.  Returns the number of drain-memo
    entries shed."""
    _PROGRAMS.shed()
    return _DRAIN_MEMO.shed()


def clear_compile_cache() -> None:
    """Drop all cached launch lists / captured programs / drain memos."""
    _GROUP_FN_CACHE.clear()
    _PROGRAMS.clear()
    _DRAIN_MEMO.clear()


def release_captured() -> None:
    """Release every captured program and its pool: the compile caches
    (``clear_compile_cache``; the next drain of each key compiles and
    captures again), every live ``CapturedCall``'s graph and static buffers
    (its next call captures again), the cuBLAS workspaces of the capture
    streams, and then the caching allocator's free segments.  Memory the
    caller's tensors hold stays."""
    from .captured import release_calls

    clear_compile_cache()
    release_calls()
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()


@dataclass(frozen=True)
class ProgramRecord:
    """One launch-list execution inside a captured drain.

    ``root_slots`` index into the drain's root-argument data order; the
    dispatcher resolves them to fresh ``GData`` objects on replay.
    ``idxs`` is the plan's device-resident flat index tensor — replay
    reuses it as-is, no host concatenation or transfer.  ``batch`` is the
    stacked pow2 bucket for batched drains (DESIGN.md §7): replay then
    resolves each slot to the LIST of member data handles to restack.
    ``fn`` names the captured program (and recaptures it after an
    eviction)."""

    fn: object  # the launch list
    root_slots: Tuple[int, ...]
    blocks: Tuple[Tuple[int, int], ...]  # per-root leaf block shape
    idxs: torch.Tensor  # flat (total, 2) int32 block indices (device)
    n_tasks: int
    n_groups: int = 0  # fused launch count inside the list
    n_groups_prefusion: int = 0  # barrier-wave group count before fusion
    n_slots: int = 0  # dependency-exact issue slots
    batch: Optional[int] = None  # stacked bucket size (None = unstacked)


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
        self.last_program: Optional[CapturedProgram] = None  # of the last list run
        # in-flight epoch handles, one per launch list (or fallback group)
        # since the last take (DESIGN.md §12); launches are asynchronous, so
        # nothing here blocks
        self.inflight: List[InFlightEpoch] = []

    # -- async launch tracking (DESIGN.md §12) ---------------------------------
    def _note_launch(self, device: torch.device, label: str) -> None:
        """Record the device work just issued as an in-flight epoch (one
        CUDA event on the current stream).  Already-finished epochs are
        pruned opportunistically so a dispatcher reused across many drains
        without ``take_inflight`` cannot accumulate handles."""
        if len(self.inflight) >= 8:
            self.inflight = [e for e in self.inflight if not e.is_ready()]
        self.inflight.append(InFlightEpoch(device, label))

    def take_inflight(self) -> List[InFlightEpoch]:
        eps, self.inflight = self.inflight, []
        return eps

    def sync(self) -> float:
        """Fence all outstanding launches; accumulates the blocked host
        seconds into ``stats['host_block_us']``."""
        blocked = super().sync()
        self.stats["host_block_us"] += int(blocked * 1e6)
        return blocked

    @staticmethod
    def _corrupt_outputs(grids: Sequence[torch.Tensor], **ctx) -> None:
        """``executor.output`` fault site: the list's grids pass through the
        armed corruption and the result is written back into them IN PLACE
        (the kernels return nothing; the grids are the outputs)."""
        outs = faults.corrupt("executor.output", list(grids), **ctx)
        for g, o in zip(grids, outs):
            if o is not g:
                g.copy_(o)

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

    def replay_program(self, rec: ProgramRecord, datas: List) -> int:
        """Re-execute a captured list against fresh data handles.

        For a stacked record (``rec.batch``) each entry of ``datas`` is the
        LIST of member handles for that root slot; they are loaded into the
        static stacked grids and the per-lane results handed back as lanes
        of a shared ``StackedEpoch`` (DESIGN.md §7)."""
        self._launch(rec.fn, rec.idxs, rec.blocks, datas, rec.batch, rec.n_tasks, replay=True)
        self.stats["tasks"] += rec.n_tasks
        self.stats["launches"] += 1
        self.stats["groups"] += rec.n_groups
        self.stats["groups_prefusion"] += rec.n_groups_prefusion
        self.stats["slots"] += rec.n_slots
        return rec.n_tasks

    def _program(self, fn, idxs: torch.Tensor, blocks, slots: Sequence, batch, built: bool) -> CapturedProgram:
        """The captured program of launch list ``fn`` on ``idxs``'s device,
        captured on a miss.  The capture of a list this run ``built``
        belongs to its compile (counted at the build, where the JAX package
        counts its own); capturing again a list the bounded cache dropped
        counts under ``recaptures``."""
        ckey = (fn, str(idxs.device))
        prog = _PROGRAMS.get(ckey)
        if prog is None:
            specs = []
            for s, (br, bc) in zip(slots, blocks):
                d = s if batch is None else s[0]
                grid = (d.shape[0] // br, d.shape[1] // bc, br, bc)
                specs.append(((batch, *grid) if batch is not None else grid, d.dtype))
            prog = CapturedProgram(fn, specs, idxs)
            _PROGRAMS[ckey] = prog
            if not built:
                self.stats["recaptures"] += 1
        return prog

    def _launch(self, fn, idxs, blocks, slots: Sequence, batch, n_tasks: int, replay: bool,
                built: bool = False) -> None:
        """One run of a captured list: capture on a miss, copy the roots
        (or, stacked, each slot's member list) and the indices into the
        static storage, replay, and hand the static grids back to the
        roots (DESIGN.md §2)."""
        prog = self._program(fn, idxs, blocks, slots, batch, built)
        faults.fire("executor.launch", batch=batch, n_tasks=n_tasks, replay=replay)
        faults.fire("launch.oom", batch=batch, n_tasks=n_tasks, replay=replay)
        if batch is None:
            prog.load(slots, blocks)
        else:
            prog.load_stacked(slots, blocks)
        prog.load_indices(idxs)
        prog.run()
        self.last_program = prog
        if prog.captured:
            self.stats["graph_replays"] += 1
        self._corrupt_outputs(prog.grids, batch=batch, replay=replay)
        if replay:
            label = "replay" if batch is None else f"replay:stacked{batch}"
        else:
            label = "program" if batch is None else f"stacked{batch}"
        self._note_launch(idxs.device, label)
        if batch is None:
            prog.hand_back(slots, blocks)
        else:
            prog.hand_back_stacked(slots, blocks)

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

    # -- stacked (batched) drain path (DESIGN.md §7) ---------------------------
    def execute_stacked(
        self,
        schedules: List[tuple],
        members: Dict[int, List[GData]],
        bucket: int,
    ) -> Optional[int]:
        """Run a homogeneous-root drain as ONE batched list per schedule.

        ``schedules`` is the TEMPLATE root's list of leaf ``(waves, dag)``
        schedules; ``members`` maps each template root-argument data id to
        the per-request member handles (template first).  Every schedule is
        planned up front: if ANY falls off the whole-program path (non-
        grid-uniform), returns None WITHOUT executing anything, so the
        caller can fall back to segment fusion with no partial state.
        """
        plans = []
        for waves, dag in schedules:
            waves = [w for w in waves if w]
            if not waves:
                continue
            plan = plan_schedule(waves, dag)
            if plan is None or any(d not in members for d in plan.roots_order):
                return None
            if self.verify and dag is not None:
                # all template plans are proven up front, before ANY lane
                # executes — a verification failure aborts with no partial
                # state, same contract as the planning fall-off above
                verify_plan(plan, dag)
                self.stats["verified_plans"] += 1
            plans.append(plan)
        n = 0
        for plan in plans:
            n += self._run_program(plan, stack=(members, bucket))
        return n

    def _run_program(self, plan: SchedulePlan, stack=None) -> int:
        """Build-or-fetch and run one planned launch list.  With ``stack =
        (members, bucket)`` the plan runs in stacked form over
        ``(bucket, nr, nc, br, bc)`` grids (DESIGN.md §7): the list and its
        cache key depend on the pow2 bucket, never on the exact request
        count."""
        batch = None
        slots = [plan.datas[d] for d in plan.roots_order]
        if stack is not None:
            members, batch = stack
            slots = [members[d] for d in plan.roots_order]
        fn, built = self._list_for(plan, batch)
        idxs = plan.flat_idxs  # built once at plan time, device-resident
        self._launch(fn, idxs, plan.blocks, slots, batch, len(plan.tasks), replay=False, built=built)
        if self._capture is not None:
            slot_ids = tuple(self._capture_ids.get(d, -1) for d in plan.roots_order)
            if -1 in slot_ids:
                self._capture_ok = False  # touches a non-root-arg datum
            else:
                faults.fire("memo.capture", batch=batch)
                self._capture.append(
                    ProgramRecord(
                        fn,
                        slot_ids,
                        plan.blocks,
                        idxs,
                        len(plan.tasks),
                        plan.n_groups,
                        plan.n_groups_prefusion,
                        plan.n_slots,
                        batch,
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

    def _list_for(self, plan: SchedulePlan, batch: Optional[int]):
        """(launch list of ``plan``, whether this call built it): cached on
        the plan's structural key, a build counted under ``compiles``."""
        key = ("waveprog", batch, self.memo_key_extra()) + plan.key
        fn = self._fn_cache.get(key)
        built = fn is None
        if built:
            fn = build_program(plan, self.backend, batch=batch)
            self._fn_cache[key] = fn
            self.stats["compiles"] += 1
        return fn, built

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
            host_to_device(torch.from_numpy(
                np.array([t.args[a].block_index() for t in tasks], dtype=np.int32)
            ), device)
            for a in range(len(rep.args))
        )
        fn([data_of[d].value for d in roots_order], idxs)
        self._note_launch(device, "group")
        for t in tasks:
            t.state = TaskState.FINISHED
            self.stats["tasks"] += 1
            self._finished(t)
        self.stats["launches"] += 1


class CudaExecutor(WaveExecutor):
    """cuBLAS wrapper analog, counterpart of the JAX package's
    ``PallasExecutor``: identical wave batching, hand-written CUDA tile
    kernels as leaves.  Every group calls the fused grid kernels (gather,
    compute and write back in one kernel, in place), a group fused across
    roots with every segment's grids in one call; on CPU tensors the
    kernels' plain PyTorch versions run instead."""

    name = "cuda"

    def __init__(self, **kw):
        kw.setdefault("backend", "cuda")
        super().__init__(**kw)
