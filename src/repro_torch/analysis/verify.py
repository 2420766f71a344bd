"""Schedule/plan verifier: machine-checked legality of a ``SchedulePlan``.

The WaveProgram scheduling pass (DESIGN.md §2) states its invariants in
prose; this module proves them for every concrete plan (DESIGN.md §11):

    V1  Every fused group's members are mutually independent — no path in
        the scope's ``TaskDag`` connects two tasks sharing one launch.
    V2  Slot order is a valid topological order of the quotient DAG: every
        predecessor of a task sits in a strictly earlier issue slot.
    V3  No two same-slot groups touch overlapping grid blocks with a write
        involved: writes are pairwise block-disjoint across a slot, and no
        group reads a block a slot-mate writes (in-slot trace order is a
        free lookahead choice, so any such overlap would be order-dependent).
    V4  A group's scatter index vector contains no duplicate write slots:
        two rows of one ``.at[idx].set`` landing on the same (root, block)
        would silently last-write-win.
    V5  The lanes of a stacked drain are disjoint (``verify_stacked_members``):
        no data handle appears in two lanes or two root slots.

Verdicts are cached on the plan's structural key *plus* a digest of its
block-index arrays (the structural key deliberately excludes indices —
they are traced arguments — but V3/V4 legality depends on them), so a
structurally repeated drain verifies once; memo replays never reach the
verifier at all (DESIGN.md §11 cost model).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Sequence, Tuple

from ..core.task import GTask
from ..core.versioning import TaskDag
from ..errors import ScheduleVerificationError

# verified-plan verdict cache: structural key + index digest -> True.
# Only successful verdicts are cached (a failing plan must keep failing
# loudly); process-global like the compiled-program cache.
_VERIFIED: Dict[tuple, bool] = {}
_STATS = {"verified": 0, "cache_hits": 0}


def verifier_stats() -> Dict[str, int]:
    """Process-global verify counters (bench/CI observability)."""
    return dict(_STATS, cached=len(_VERIFIED))


def clear_verified_cache() -> None:
    _VERIFIED.clear()


def _plan_groups_with_members(plan) -> Iterator[tuple]:
    """Yield (slot_idx, group, member tasks) — ``plan.tasks`` is flat in
    exactly the order the planner appended groups, so group boundaries are
    recovered from each group's size."""
    pos = 0
    for si, slot in enumerate(plan.slots):
        for g in slot:
            members = plan.tasks[pos : pos + g.size]
            pos += g.size
            yield si, g, members


def _group_blocks(g, arg: int) -> List[Tuple[int, int, int]]:
    """(root slot, block row, block col) rows of one argument's index
    vector, resolved through the group's per-segment root slots."""
    rows: List[Tuple[int, int, int]] = []
    idx = g.idxs[arg]
    off = 0
    for seg_slots, size in g.segments:
        root = seg_slots[arg]
        for k in range(off, off + size):
            rows.append((root, int(idx[k, 0]), int(idx[k, 1])))
        off += size
    return rows


def _idx_digest(plan) -> bytes:
    h = hashlib.sha1()
    for g in plan.groups():
        for ix in g.idxs:
            h.update(ix.tobytes())
    return h.digest()


def verify_plan(plan, dag: TaskDag, cache: bool = True) -> bool:
    """Prove V1–V4 for ``plan`` against its scope's ``dag``.

    Returns True (possibly from the verdict cache); raises
    ``ScheduleVerificationError`` naming the violated invariant and the
    offending task pair / block coordinate otherwise.
    """
    key = None
    if cache:
        key = (plan.key, _idx_digest(plan))
        if key in _VERIFIED:
            _STATS["cache_hits"] += 1
            return True

    owner: Dict[int, Tuple[int, int]] = {}  # task id -> (slot, group index)
    groups = list(_plan_groups_with_members(plan))
    for gi, (si, g, members) in enumerate(groups):
        for t in members:
            owner[t.id] = (si, gi)

    # V1: intra-group independence (both directions; ids are monotone in
    # program order but the check must not assume that)
    for _, g, members in groups:
        for j in range(len(members)):
            for i in range(j):
                a, b = members[i], members[j]
                if dag.path(a.id, b.id) or dag.path(b.id, a.id):
                    raise ScheduleVerificationError(
                        "verify_plan.group_independence",
                        f"fused {g.op.name} group contains dependent tasks "
                        f"— one launch cannot order them",
                        pair=(a.id, b.id),
                    )

    # V2: slot order topologically valid against the task DAG
    for si, g, members in groups:
        for t in members:
            for p in dag.preds.get(t.id, ()):
                if p not in owner:
                    continue  # predecessor outside this plan's waves
                ps, _ = owner[p]
                if ps >= si:
                    raise ScheduleVerificationError(
                        "verify_plan.slot_order",
                        f"task {t.id} ({g.op.name}) issued at slot {si} "
                        f"but its predecessor sits at slot {ps}",
                        pair=(p, t.id),
                    )

    # V3 + V4: block-level read/write sets per slot.  All arguments count
    # as reads (a pure-WRITE overlap is a WAW and is caught by the write
    # sets either way), write_pos arguments as writes.
    for si, slot_groups in enumerate(plan.slots):
        seen_writes: Dict[Tuple[int, int, int], int] = {}  # block -> group
        reads_per_group: List[set] = []
        writes_per_group: List[set] = []
        for g in slot_groups:
            reads = set()
            writes = set()
            for a in range(len(g.idxs)):
                rows = _group_blocks(g, a)
                reads.update(rows)
                if a in g.write_pos:
                    if len(set(rows)) != len(rows):
                        dup = [r for r in rows if rows.count(r) > 1][0]
                        raise ScheduleVerificationError(
                            "verify_plan.duplicate_write",
                            f"{g.op.name} group scatters twice to root "
                            f"{dup[0]} block ({dup[1]},{dup[2]}) in one "
                            f"launch (last-write-wins would be silent)",
                        )
                    writes.update(rows)
            reads_per_group.append(reads)
            writes_per_group.append(writes)
        for gi, g in enumerate(slot_groups):
            for block in writes_per_group[gi]:
                prev = seen_writes.get(block)
                if prev is not None:
                    raise ScheduleVerificationError(
                        "verify_plan.slot_write_overlap",
                        f"slot {si}: {slot_groups[prev].op.name} and "
                        f"{g.op.name} groups both write root {block[0]} "
                        f"block ({block[1]},{block[2]})",
                    )
                seen_writes[block] = gi
        for gi, g in enumerate(slot_groups):
            for gj, other in enumerate(slot_groups):
                if gi == gj:
                    continue
                clash = reads_per_group[gi] & writes_per_group[gj]
                if clash:
                    block = sorted(clash)[0]
                    raise ScheduleVerificationError(
                        "verify_plan.slot_read_write_overlap",
                        f"slot {si}: {g.op.name} group reads root "
                        f"{block[0]} block ({block[1]},{block[2]}) that "
                        f"the {other.op.name} group writes in the same "
                        f"slot (in-slot order is unconstrained)",
                    )

    _STATS["verified"] += 1
    if key is not None:
        _VERIFIED[key] = True
    return True


def verify_stacked_members(member_lists: Sequence[Sequence]) -> bool:
    """V5: lanes of a stacked drain must be block-disjoint, which at the
    whole-root granularity the stacker uses means no ``GData`` handle may
    appear in two lanes or in two root slots — an aliased lane would make
    two lanes scatter into one buffer.
    """
    seen: Dict[int, Tuple[int, int]] = {}
    for slot, members in enumerate(member_lists):
        for lane, d in enumerate(members):
            prev = seen.get(d.id)
            if prev is not None:
                raise ScheduleVerificationError(
                    "verify_stacked.lane_alias",
                    f"datum {d.name} appears as (slot {prev[0]}, lane "
                    f"{prev[1]}) and (slot {slot}, lane {lane}) of one "
                    f"stacked drain — lanes must be disjoint",
                )
            seen[d.id] = (slot, lane)
    return True


__all__ = [
    "clear_verified_cache",
    "verifier_stats",
    "verify_plan",
    "verify_stacked_members",
]
