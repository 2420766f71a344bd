"""WaveProgram: dependency-exact whole-schedule execution (DESIGN.md §2).

The dispatcher hands the leaf executor a complete level schedule — an
ordered list of waves of independent tasks — plus the exact task DAG behind
it (``versioning.TaskDag``).  The barrier between waves is replaced by a
**dependency-exact group schedule**:

    plan   = plan_schedule(waves, dag)  # fusion + issue slots + indices
    fn     = build_program(plan, ...)   # one launch list, cached on plan.key
    fn(grids, plan.flat_idxs)           # updates the resident grids in place

Scheduling pass (``dag`` present), identical to the JAX package's:

1. **Exact issue.**  A group's issue slot is its longest-path depth in the
   fused-group DAG, not its Kahn wave index.  Groups sharing a slot are
   mutually independent.
2. **Cross-wave fusion.**  Two groups fuse into one larger batched launch
   iff they have the same signature (operation, write positions, per-arg
   block shapes and dtypes) and NO path connects their tasks.  Fusion works
   across roots: a fused group carries per-segment argument slots.
3. **Lookahead.**  Within a slot, groups are ordered by critical-path
   height, so the next panel factorization is issued before independent
   trailing updates that share its slot.

Roots stay in ``(nr, nc, br, bc)`` grid-major layout for the duration (the
``GData`` grid-resident epoch).  Block indices are built ONCE at plan time
into a single ``(total, 2)`` int32 tensor on the grids' device
(``SchedulePlan.flat_idxs``); drain replay reuses it untouched.  Two drains
whose schedules share a structure hit the same launch list.

Per single-segment group the list calls the operation's fused grid kernel
(``Operation.grid_fused_fn``: gather, compute and write back in one kernel,
in place in the written grid).  Otherwise it gathers the blocks, runs the
batched leaf and scatters back with ``index_put_``.  Group sizes are exact,
never padded: duplicate trailing indices are unsound for read-write fused
kernels.  In-place writes take the place of the JAX package's buffer
donation; launches are asynchronous on CUDA, and the executor records an
``InFlightEpoch`` after each list.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..data import GData
from ..task import GTask
from .base import group_wave


@dataclass(frozen=True, eq=False)
class GroupPlan:
    """One fused task group: static signature + per-segment index data.

    ``segments`` carries one ``(arg_slots, size)`` entry per merged source
    group; a group fused across roots has one segment per distinct slot
    tuple.  ``idxs`` holds per-arg ``(total_size, 2)`` int32 block coords,
    rows ordered segment by segment.
    """

    op: object  # Operation
    write_pos: Tuple[int, ...]  # arg positions with write access
    segments: Tuple[Tuple[Tuple[int, ...], int], ...]  # ((slots...), size)
    idxs: Tuple[np.ndarray, ...]  # per-arg (size, 2) int32 block coords
    height: int  # critical-path priority (lookahead ordering)

    @property
    def arg_slots(self) -> Tuple[int, ...]:
        return self.segments[0][0]

    @property
    def size(self) -> int:
        return sum(s for _, s in self.segments)

    @property
    def sig(self) -> tuple:
        return (self.op.name, self.segments, self.write_pos)


@dataclass
class SchedulePlan:
    """A fully analyzed, dependency-exactly scheduled drain."""

    roots_order: Tuple[int, ...]  # data ids, stable by first appearance
    datas: Dict[int, GData]
    blocks: Tuple[Tuple[int, int], ...]  # per-slot leaf block shape (br, bc)
    slots: List[List[GroupPlan]]  # issue slots; groups in a slot independent
    tasks: List[GTask]  # all tasks in slot order
    key: tuple  # structural cache key (no data identity)
    flat_idxs: torch.Tensor  # ONE (total, 2) int32 tensor, built at plan time
    n_groups_prefusion: int  # barrier-wave group count (pre-fusion)

    @property
    def n_groups(self) -> int:
        return sum(len(s) for s in self.slots)

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def groups(self):
        for slot in self.slots:
            yield from slot


class _Fused:
    """Mutable fusion-pass state for one (eventually fused) group."""

    __slots__ = ("op", "write_pos", "compat", "segments", "preds", "task_ids")

    def __init__(self, op, write_pos, compat, arg_slots, tasks, preds):
        self.op = op
        self.write_pos = write_pos
        self.compat = compat
        self.segments: List[Tuple[Tuple[int, ...], List[GTask]]] = [
            (arg_slots, list(tasks))
        ]
        self.preds: Set[int] = set(preds)
        self.task_ids: Set[int] = {t.id for t in tasks}

    def merge(self, arg_slots, tasks, preds) -> None:
        for slots_, members in self.segments:
            if slots_ == arg_slots:
                members.extend(tasks)
                break
        else:
            self.segments.append((arg_slots, list(tasks)))
        self.preds |= preds
        self.task_ids |= {t.id for t in tasks}


def _fuse(
    waves: Sequence[Sequence[GTask]],
    dag,
    slot_of: Dict[int, int],
) -> Tuple[List[List[_Fused]], int]:
    """Dependency-exact scheduling pass: fusion + issue-slot assignment.

    Returns (slots, prefusion_group_count).  Legality (DESIGN.md §2): a
    group may merge into an earlier one iff their signatures match and no
    path connects them.  The pass maintains the *quotient* DAG over fused
    groups and checks the candidate's transitive quotient ancestors — a
    quotient path implies a task path would be ordered through a third
    launch, so quotient-ancestor-freedom implies ``TaskDag.independent``
    and additionally keeps the fused-group DAG acyclic (schedulable) under
    repeated merging, which pairwise task-level independence alone would
    not guarantee.
    """
    fused: List[_Fused] = []
    owner: Dict[int, int] = {}  # task id -> fused group index
    wave_of: List[int] = []  # fused index -> source wave (dag-less fallback)
    prefusion = 0
    for wi, wave in enumerate(waves):
        for _, tasks in group_wave(wave).items():
            prefusion += 1
            rep = tasks[0]
            arg_slots = tuple(slot_of[v.data.id] for v in rep.args)
            write_pos = tuple(i for i, m in enumerate(rep.modes) if m.writes)
            compat = (
                rep.op.name,
                write_pos,
                tuple(v.region.shape for v in rep.args),
                tuple(str(v.data.dtype) for v in rep.args),
            )
            dpreds: Set[int] = set()
            target = None
            if dag is not None:
                for t in tasks:
                    for p in dag.preds.get(t.id, ()):
                        dpreds.add(owner[p])
                # transitive ancestors in the current quotient DAG
                anc: Set[int] = set()
                stack = list(dpreds)
                while stack:
                    f = stack.pop()
                    if f not in anc:
                        anc.add(f)
                        stack.extend(fused[f].preds - anc)
                for fi, f in enumerate(fused):
                    if f.compat == compat and fi not in anc:
                        target = fi
                        break
            if target is None:
                target = len(fused)
                fused.append(
                    _Fused(rep.op, write_pos, compat, arg_slots, tasks, dpreds)
                )
                wave_of.append(wi)
            else:
                fused[target].merge(arg_slots, tasks, dpreds)
            for t in tasks:
                owner[t.id] = target

    if dag is None:
        # no DAG: keep the barrier-wave structure (slot = Kahn wave)
        depth = {i: w for i, w in enumerate(wave_of)}
    else:
        # issue slot = longest-path depth in the (acyclic) fused-group DAG
        depth = {}
        for i in range(len(fused)):
            stack = [i]
            while stack:
                g = stack[-1]
                if g in depth:
                    stack.pop()
                    continue
                missing = [p for p in fused[g].preds if p not in depth]
                if missing:
                    stack.extend(missing)
                    continue
                depth[g] = (
                    1 + max(depth[p] for p in fused[g].preds)
                    if fused[g].preds
                    else 0
                )
                stack.pop()
    n_slots = 1 + max(depth.values()) if depth else 0
    slots: List[List[_Fused]] = [[] for _ in range(n_slots)]
    for i, f in enumerate(fused):
        slots[depth[i]].append(f)
    return slots, prefusion


def plan_schedule(
    waves: Sequence[Sequence[GTask]], dag=None
) -> Optional[SchedulePlan]:
    """Analyze a level schedule for whole-program execution.

    ``dag`` is the scope's ``versioning.TaskDag``; when given, the
    dependency-exact pass fuses same-signature groups across former wave
    boundaries and re-slots groups by actual predecessors.  Without it the
    barrier-wave structure is kept (one slot per wave).

    Returns None (caller falls back to per-wave launches) when the schedule
    is not grid-uniform: some root lacks a value, or a task's region is not
    one aligned block of that root's uniform leaf grid.
    """
    roots_order: List[int] = []
    datas: Dict[int, GData] = {}
    blocks: Dict[int, Tuple[int, int]] = {}
    for wave in waves:
        for t in wave:
            for v in t.args:
                d = v.data
                if d.id not in datas:
                    if not d.has_value:
                        return None
                    roots_order.append(d.id)
                    datas[d.id] = d
                    blocks[d.id] = v.region.shape
                br, bc = blocks[d.id]
                r = v.region
                if (
                    r.shape != (br, bc)
                    or r.r0 % br
                    or r.c0 % bc
                    or d.shape[0] % br
                    or d.shape[1] % bc
                ):
                    return None
    if not any(waves):
        return None
    devices = {datas[d].device for d in roots_order}
    if len(devices) != 1:
        raise ValueError(f"one drain's roots lie on several devices: {devices}")
    slot_of = {d: i for i, d in enumerate(roots_order)}

    heights = dag.heights() if dag is not None else {}
    fused_slots, prefusion = _fuse(waves, dag, slot_of)

    plan_slots: List[List[GroupPlan]] = []
    tasks: List[GTask] = []
    for slot in fused_slots:
        groups: List[GroupPlan] = []
        for f in slot:
            members = [t for _, ts in f.segments for t in ts]
            n_args = len(f.segments[0][0])
            idxs = tuple(
                np.array(
                    [t.args[a].block_index() for t in members], dtype=np.int32
                )
                for a in range(n_args)
            )
            segments = tuple((slots_, len(ts)) for slots_, ts in f.segments)
            height = max((heights.get(t.id, 0) for t in members), default=0)
            groups.append(
                GroupPlan(f.op, f.write_pos, segments, idxs, height)
            )
        # lookahead: critical-path-first issue order within the slot
        order = sorted(range(len(groups)), key=lambda i: (-groups[i].height, i))
        groups = [groups[i] for i in order]
        slot = [slot[i] for i in order]
        plan_slots.append(groups)
        for f in slot:
            for _, ts in f.segments:
                tasks.extend(ts)

    roots = tuple(roots_order)
    blocks_t = tuple(blocks[d] for d in roots)
    key = (
        tuple(
            (datas[d].shape, str(datas[d].dtype), blocks[d])
            for d in roots
        ),
        tuple(tuple(g.sig for g in slot) for slot in plan_slots),
    )
    parts = [ix for slot in plan_slots for g in slot for ix in g.idxs]
    flat = torch.from_numpy(np.concatenate(parts, axis=0)).to(devices.pop())
    return SchedulePlan(
        roots, datas, blocks_t, plan_slots, tasks, key, flat, prefusion
    )


def build_program(plan: SchedulePlan, backend: str):
    """Build ``plan``'s launch list: a fn ``(grids, idxs) -> None`` that
    updates the resident grids in place.

    Groups run slot by slot in lookahead order.  Per group: the operation's
    fused grid kernel (single-segment groups only) or gather -> batched
    leaf -> scatter, with multi-segment groups concatenating the
    per-segment gathers and splitting the scatters across their roots.

    A group's reads are legal against the current grids even mid-slot: any
    block a group reads and a slot-mate writes would be a RAW/WAR edge,
    and edges force different slots.  The gather copies its blocks before
    the group's scatter, so a group may read and write the same grid.

    Only static fields are copied out of each ``GroupPlan``: the cached list
    must not retain the per-task numpy index arrays, which reach it as the
    ``idxs`` argument.
    """
    dtypes = tuple(plan.datas[d].dtype for d in plan.roots_order)
    steps = []
    base = 0
    for g in plan.groups():
        fused = g.op.grid_fused_fn(backend)
        if (
            fused is not None
            and len(g.segments) == 1
            and g.write_pos == (fused[1],)
        ):
            kind, fn = "fused", fused[0]
        else:
            kind = "gather"
            fn = g.op.batched_leaf_fn(backend)
        steps.append((kind, fn, g.segments, g.write_pos, g.size, base))
        base += len(g.arg_slots) * g.size

    def program(grids: Sequence[torch.Tensor], idxs: torch.Tensor) -> None:
        for kind, fn, segments, write_pos, size, b0 in steps:
            # static-offset slices of the single flat index tensor (launch
            # order matches SchedulePlan.flat_idxs)
            n_args = len(segments[0][0])
            gidx = [
                idxs[b0 + a * size : b0 + (a + 1) * size]
                for a in range(n_args)
            ]
            if kind == "fused":
                fn(gidx, tuple(grids[s] for s in segments[0][0]))
                continue
            blocks = []
            for a in range(n_args):
                chunks = []
                off = 0
                for slots_, ssize in segments:
                    ix = gidx[a][off : off + ssize]
                    chunks.append(grids[slots_[a]][ix[:, 0], ix[:, 1]])
                    off += ssize
                blocks.append(chunks[0] if len(chunks) == 1 else torch.cat(chunks))
            outs = fn(*blocks)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for out, a in zip(outs, write_pos):
                off = 0
                for slots_, ssize in segments:
                    r = slots_[a]
                    ix = gidx[a][off : off + ssize]
                    part = out if len(segments) == 1 else out[off : off + ssize]
                    grids[r].index_put_((ix[:, 0], ix[:, 1]), part.to(dtypes[r]))
                    off += ssize

    return program
