"""Captured launch lists: the port's counterpart of the JAX package's
jitted WaveProgram (DESIGN.md §2; the port's choices in
``src/repro_torch/DESIGN.md``).

The JAX executor compiles a drain's whole program once per structural key
and replays it as one dispatch.  Here a launch list (``build_program``) is
recorded once into a ``torch.cuda.CUDAGraph`` over static storage, and every
later drain of the same key replays the graph: one host call, however many
groups the list holds.  A capture belongs to the executor's ``compiles``,
a replay is one of its ``launches``.

A ``CapturedProgram`` owns

- static grids, one per root slot: ``(nr, nc, br, bc)``, or
  ``(bucket, nr, nc, br, bc)`` when stacked;
- a static ``(total, 2)`` int32 index tensor.  ``plan.key`` does not fix
  the index values (the same group structure can address other blocks), so
  a run whose plan brought other indices copies them in on the device;
- the graph and its private memory pool;
- the kernel-launch tally of one run of the list.

Static storage and aliasing: each run copies its roots into the static
grids (``GData.write_grid``), and the grids are then handed to the drain's
handles (``GData.adopt_grid``, or lanes of a new ``StackedEpoch``) instead
of being copied out.  A root whose resident grid already is its static grid
is not copied, nor are stacked members that are exactly lanes 0..N-1 of the
static grid's epoch and its only holders.  Before a run overwrites a static
grid that another live handle still reads, that handle gets its own copy
(``_release``), so a replay never changes bytes a caller can still see.

On the card the tile wrappers count launches in Python, and a replay
issues none: so capture records the list's tally and every run adds it
once.  The first drain's warm-up (on scratch copies, to load every kernel
library and create the library handles before capture) and the capture
itself count nothing.  On the CPU, where CUDA graphs do not exist, the
program runs its list eagerly over the same static grids, and its first run
records the tally.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ...kernels.tile_linalg import COUNTERS
from ..data import GData, StackedEpoch

_SIDE: Dict[int, torch.cuda.Stream] = {}  # device index -> warm-up/capture stream


class CaptureError(RuntimeError):
    """Recording a launch list into a CUDA graph failed (for instance, a leaf
    synchronized with the host).  There is no eager retry on the card."""


def _snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in COUNTERS]


def _restore(snap: List[Dict[str, int]]) -> None:
    for c, s in zip(COUNTERS, snap):
        c.clear()
        c.update(s)


def _delta(snap: List[Dict[str, int]]) -> List[Dict[str, int]]:
    return [{k: v - s.get(k, 0) for k, v in c.items() if v != s.get(k, 0)} for c, s in zip(COUNTERS, snap)]


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SIDE:
        _SIDE[index] = torch.cuda.Stream(device=index)
    return _SIDE[index]


class CapturedProgram:
    """One launch list captured over static storage (module docstring).

    ``specs`` gives each root slot's static grid ``(shape, dtype)``;
    ``idxs`` is the capturing plan's flat index tensor."""

    def __init__(self, fn, specs: Sequence[Tuple[tuple, torch.dtype]], idxs: torch.Tensor):
        self.fn = fn
        self.grids = [torch.empty(shape, dtype=dtype, device=idxs.device) for shape, dtype in specs]
        self.idxs = idxs.clone()
        self._idx_src = idxs  # the plan tensor whose values self.idxs holds
        # per slot: weak reference to the handle (GData, or StackedEpoch when
        # stacked) the last run handed the static grid to
        self._holders: List[Optional[weakref.ref]] = [None] * len(specs)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally: Optional[List[Dict[str, int]]] = None
        if idxs.device.type == "cuda":
            self._capture()

    @property
    def captured(self) -> bool:
        """True when runs replay a CUDA graph (on the card)."""
        return self.graph is not None

    def _capture(self) -> None:
        device = self.idxs.device
        stream = _side_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        snap = _snapshot()
        try:
            with torch.cuda.stream(stream):
                # warm-up on scratch copies (the kernels write in place):
                # loads every kernel library and creates the library handles
                # and workspaces on this stream before capture
                scratch = [torch.zeros_like(g) for g in self.grids]
                self.fn(scratch, self.idxs)
                del scratch
                _restore(snap)
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin()
                try:
                    self.fn(self.grids, self.idxs)
                except BaseException as e:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture was invalidated by the failure itself
                    if isinstance(e, torch.cuda.OutOfMemoryError):
                        raise  # pressure, not a capture fault: the server degrades
                    notes = "; ".join(getattr(e, "__notes__", ()))
                    raise CaptureError(f"capturing the launch list failed at {notes or 'an unnamed step'}: "
                                       f"{type(e).__name__}: {e}") from e
                graph.capture_end()
            self.tally = _delta(snap)
        finally:
            _restore(snap)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = graph

    # -- copy-in -----------------------------------------------------------------
    def _release(self, i: int) -> None:
        """Give the live handle that still reads static grid ``i`` its own
        copy, before a run overwrites the grid."""
        ref = self._holders[i]
        holder = ref() if ref is not None else None
        g = self.grids[i]
        if isinstance(holder, StackedEpoch):
            if holder.holders > 0 and holder.grid is g:
                holder.grid = g.clone()
        elif holder is not None and holder.grid is g:
            holder.adopt_grid(g.clone(), holder.grid_block)
        self._holders[i] = None

    def load(self, datas: Sequence[GData], blocks: Sequence[Tuple[int, int]]) -> None:
        """Copy each root into its static grid; a root that already holds its
        static grid is left as it is."""
        for i, (d, (br, bc), g) in enumerate(zip(datas, blocks, self.grids)):
            if d.grid is g:
                continue
            self._release(i)
            d.write_grid(g, br, bc)

    def load_stacked(self, member_lists: Sequence[List[GData]], blocks: Sequence[Tuple[int, int]]) -> None:
        """Copy each slot's members into lanes 0..N-1 of its static stacked
        grid and repeat the last member into the padding lanes (lanes are
        independent: padding lanes compute results nobody reads).

        Repeat-tick fast path: members that are exactly lanes 0..N-1 of the
        epoch holding the static grid, and its only holders, are already in
        place: zero data movement between drains."""
        for i, (members, (br, bc), g) in enumerate(zip(member_lists, blocks, self.grids)):
            first = members[0].lane
            if (
                first is not None
                and first[0].grid is g
                and first[0].holders == len(members)
                and all(m.lane is not None and m.lane[0] is first[0] and m.lane[1] == j
                        for j, m in enumerate(members))
            ):
                continue
            self._release(i)
            for j, m in enumerate(members):
                m.write_grid(g[j], br, bc)
            n = len(members)
            if n < g.shape[0]:
                g[n:].copy_(g[n - 1 : n].expand_as(g[n:]))

    def load_indices(self, idxs: torch.Tensor) -> None:
        """Bring the static index tensor to ``idxs``'s values (a copy on the
        device, skipped when it already holds them)."""
        if idxs is not self._idx_src:
            self.idxs.copy_(idxs)
            self._idx_src = idxs

    # -- run and hand back ---------------------------------------------------------
    def run(self) -> None:
        """One run of the list over the static storage: a graph replay on the
        card, an eager run on the CPU; either adds the recorded tally of
        kernel launches once."""
        if self.graph is not None:
            self.graph.replay()
        elif self.tally is None:
            snap = _snapshot()
            self.fn(self.grids, self.idxs)
            self.tally = _delta(snap)
            return
        else:
            snap = _snapshot()
            self.fn(self.grids, self.idxs)
            _restore(snap)
        for c, t in zip(COUNTERS, self.tally):
            for k, v in t.items():
                c[k] = c.get(k, 0) + v

    def hand_back(self, datas: Sequence[GData], blocks: Sequence[Tuple[int, int]]) -> None:
        """Make each static grid the resident grid of the root it computed."""
        for i, (d, blk, g) in enumerate(zip(datas, blocks, self.grids)):
            d.adopt_grid(g, blk)
            self._holders[i] = weakref.ref(d)

    def hand_back_stacked(self, member_lists: Sequence[List[GData]], blocks: Sequence[Tuple[int, int]]) -> None:
        """Hand each member its lane of the static stacked grids, through one
        new ``StackedEpoch`` a slot."""
        for i, (members, blk, g) in enumerate(zip(member_lists, blocks, self.grids)):
            epoch = StackedEpoch(g, blk)
            for j, m in enumerate(members):
                m.adopt_lane(epoch, j)
            self._holders[i] = weakref.ref(epoch)
