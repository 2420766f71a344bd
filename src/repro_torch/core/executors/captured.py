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

Over a mesh of several ranks a list and a step hold NCCL collectives:
``sharded.OwnedCapture`` (a distributed drain's cut list) and a
``CapturedCall`` given the mesh's ``group`` (the train, prefill and
decode plans) capture them too, each rank its own graph.  Before its
capture every rank checks on the host that all hold the same collective
sequence (``agree``), the capture is thread-local (``_begin_capture``),
and ``release_captured`` must drop such graphs before the process group
is destroyed.
"""

from __future__ import annotations

import gc
import warnings
import weakref
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ...kernels.tile_linalg import COUNTERS
from ...tree import flatten_with_paths, leaves, tree_map
from ..data import GData, StackedEpoch

_SIDE: Dict[int, torch.cuda.Stream] = {}  # device index -> warm-up/capture stream
_CALLS: "weakref.WeakSet[CapturedCall]" = weakref.WeakSet()  # every live CapturedCall (release_calls)


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


@contextmanager
def _collector_off():
    """Python's cycle collector stopped (after one collection) while a
    stream captures: a CUDA graph it frees during a capture (a dropped
    program's, held in a reference cycle) is reset there, which CUDA
    refuses while a stream captures, and the capture is invalidated."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _begin_capture(graph: torch.cuda.CUDAGraph, collective: bool = False):
    """Begin a capture into a private pool of its own; returns the pool's
    id (``_abort_capture`` needs it, and a graph gives it only once its
    capture has succeeded).  A capture that holds NCCL collectives is
    thread-local: the process group's watchdog thread queries the events
    of earlier collectives, which a global capture refuses and which then
    invalidates it (``src/repro_torch/DESIGN.md``)."""
    pool = torch.cuda.graph_pool_handle()
    graph.capture_begin(pool=pool, capture_error_mode="thread_local" if collective else "global")
    return pool


def _abort_capture(graph: torch.cuda.CUDAGraph, pool, device: torch.device) -> None:
    """End a capture that failed.  ``capture_end`` ends the stream's capture
    first and the allocator's after it; when the failure invalidated the
    stream's capture, ``capture_end`` raises between the two, and the
    allocator then counts a capture underway for good: from then on no
    ``empty_cache`` releases a segment (ROADMAP C5: after the capture probe
    of ``chip_smoke.py``, 82 GB of free segments stayed reserved).  So the
    allocator's side is ended here."""
    try:
        graph.capture_end()
    except RuntimeError:  # the capture was invalidated by the failure itself
        index = device.index if device.index is not None else torch.cuda.current_device()
        torch._C._cuda_endAllocateToPool(index, pool)


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SIDE:
        _SIDE[index] = torch.cuda.Stream(device=index)
    return _SIDE[index]


# -- the same collectives on every rank --------------------------------------------
def group_desc(group) -> Tuple[int, Tuple[int, ...]]:
    """A process group as every rank of a mesh dim sees it alike: its size
    and its ranks' offsets from its first."""
    ranks = dist.get_process_group_ranks(group)
    return len(ranks), tuple(r - ranks[0] for r in ranks)


def _group_of(args):
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a)
    return None


def _dtype_of(args):
    for a in args:
        if torch.is_tensor(a):
            return a.dtype
        if isinstance(a, (list, tuple)) and a and torch.is_tensor(a[0]):
            return a[0].dtype
    return None


class _Collectives(TorchDispatchMode):
    """Records the collectives a call issues, in order: (op, dtype, group)
    each (``group_desc``), as the c10d operators reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.sequence: List[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            group = _group_of(args)
            self.sequence.append((func.__name__, str(_dtype_of(args)),
                                  None if group is None else group_desc(group)))
        return func(*args, **(kwargs or {}))


def agree(sequence: Sequence, group, name: str, device: torch.device) -> None:
    """Check, on the host, that every rank of ``group`` holds the collective
    sequence ``sequence`` of the program ``name`` (one ``all_gather_object``
    that every rank issues).  A rank whose graph issued other collectives
    would hang its peers at replay; so every rank raises ``CaptureError``
    naming ``name`` and the first rank whose sequence differs from the
    group's first rank's."""
    seqs: List[Optional[list]] = [None] * dist.get_world_size(group)
    with torch.cuda.device(device) if device.type == "cuda" else nullcontext():
        dist.all_gather_object(seqs, list(sequence), group=group)
    for r, s in enumerate(seqs):
        if s != seqs[0]:
            i = next((i for i, (a, b) in enumerate(zip(s, seqs[0])) if a != b), min(len(s), len(seqs[0])))
            mine = s[i] if i < len(s) else "nothing"
            first = seqs[0][i] if i < len(seqs[0]) else "nothing"
            raise CaptureError(f"{name}: rank {dist.get_global_rank(group, r)} issues another collective sequence "
                               f"than rank {dist.get_global_rank(group, 0)}: at collective {i}, {mine} against "
                               f"{first}")


class CapturedProgram:
    """One launch list captured over static storage (module docstring).

    ``specs`` gives each root slot's static grid ``(shape, dtype)``;
    ``idxs`` is the capturing plan's flat index tensor."""

    collective = False  # the list issues NCCL collectives (sharded.OwnedCapture)
    name = "the launch list"

    def __init__(self, fn, specs: Sequence[Tuple[tuple, torch.dtype]], idxs: torch.Tensor):
        self.idxs = idxs.clone()
        self._idx_src = idxs  # the plan tensor whose values self.idxs holds
        self._setup(fn, specs, idxs.device)

    def _setup(self, fn, specs: Sequence[Tuple[tuple, torch.dtype]], device: torch.device) -> None:
        self.fn = fn
        self.grids = [torch.empty(shape, dtype=dtype, device=device) for shape, dtype in specs]
        # per slot: weak reference to the handle (GData, or StackedEpoch when
        # stacked) the last run handed the static grid to
        self._holders: List[Optional[weakref.ref]] = [None] * len(specs)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally: Optional[List[Dict[str, int]]] = None
        if device.type == "cuda":
            self._capture(device)

    def _call(self, grids: List[torch.Tensor]) -> None:
        self.fn(grids, self.idxs)

    @property
    def captured(self) -> bool:
        """True when runs replay a CUDA graph (on the card)."""
        return self.graph is not None

    def _capture(self, device: torch.device) -> None:
        stream = _side_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        snap = _snapshot()
        try:
            with torch.cuda.stream(stream):
                # warm-up on scratch copies (the kernels write in place):
                # loads every kernel library and creates the library handles
                # and workspaces on this stream before capture (and a list's
                # collectives their communicators)
                scratch = [torch.zeros_like(g) for g in self.grids]
                self._call(scratch)
                del scratch
                _restore(snap)
                if self.collective:  # no collective of the warm-up left running
                    torch.cuda.synchronize(device)
                graph = torch.cuda.CUDAGraph()
                with _collector_off():
                    pool = _begin_capture(graph, self.collective)
                    try:
                        self._call(self.grids)
                    except BaseException as e:
                        _abort_capture(graph, pool, device)
                        if isinstance(e, torch.cuda.OutOfMemoryError):
                            raise  # pressure, not a capture fault: the server degrades
                        notes = "; ".join(getattr(e, "__notes__", ()))
                        raise CaptureError(f"capturing {self.name} failed at {notes or 'an unnamed step'}: "
                                           f"{type(e).__name__}: {e}") from e
                    with warnings.catch_warnings():
                        # a rank whose part of a list is empty records an empty graph
                        warnings.filterwarnings("ignore", "The CUDA Graph is empty")
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
            self._call(self.grids)
            self.tally = _delta(snap)
            return
        else:
            snap = _snapshot()
            self._call(self.grids)
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


def _signature(x):
    """A leaf as the captured call keys it: a tensor by (shape, dtype,
    device), a DTensor also by its placements, anything else as it is."""
    if isinstance(x, DTensor):
        return tuple(x.shape), x.dtype, x.device, tuple(x.placements)
    return (tuple(x.shape), x.dtype, x.device) if torch.is_tensor(x) else x


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def _clone(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x``; a DTensor's is this rank's block copied, in the same
    placements (no collective)."""
    if isinstance(x, DTensor):
        return DTensor.from_local(x.to_local().clone(), x.device_mesh, x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return x.clone()


def _padded(flags: Tuple[bool, ...], n: int) -> Tuple[bool, ...]:
    return flags + (False,) * (n - len(flags))


class CapturedCall:
    """A function of trees of tensors captured once into a CUDA graph over
    static buffers: the counterpart of ``jax.jit`` for the training step
    (``launch/steps.py`` ``StepPlan.jitted``), the fused task-tree
    executor (``train/step_ops.py``) and the serving engine's decode and
    scatter programs (``serving/engine.py``).

    The first call on the card adopts each argument marked in ``donate`` as
    its static buffer (the function updates it in place: the counterpart of
    donation), and each marked in ``resident`` (only read: the serving
    weights), and clones the others.  It runs the function once for real on
    the side stream (the warm-up, which loads the libraries and creates
    their handles; its result is the first call's), returns the memory the
    warm-up freed to the device, and records a second run into the graph,
    which executes nothing.  Every later call copies each argument into its
    static buffer (nothing to copy where the caller passes the buffer
    itself), replays the graph, and returns the recorded outputs: a static
    buffer as it is, any other tensor as a clone, so the next replay never
    changes a result the caller holds.  A capture that fails raises
    ``CaptureError`` naming ``name``; nothing falls back to eager on the
    card.  On the CPU every call runs the function eagerly on the
    arguments, counting one compile.  ``pool_bytes`` is the device memory
    that the capture reserved (its private pool).

    ``generators``: the ``torch.Generator``s the function draws from (the
    engine decode's sampler).  Each is registered with the graph before its
    capture (``register_generator_state``), so that every replay takes the
    generator's current offset and advances it by the draws of one call, as
    an eager call does: two replays on the same inputs draw anew (the
    warm-up draws as an eager call).

    Over a mesh (``group``: the process group over its ranks) the arguments
    are DTensors, or this rank's blocks of them: the static buffers are
    DTensors in the same placements, and copies and clones move this rank's
    blocks only.  The collectives inside the function (c10d calls on the
    mesh's groups) are captured into the graph, each rank's own; the
    warm-up records them (``_Collectives``) and, before the capture, every
    rank checks that all hold the same sequence (``agree``), as they must
    for their graphs to meet at every replay; a rank whose sequence
    differs raises with the donated arguments put back as they were (their
    blocks are copied to the host before the warm-up).  A train step's
    backward issues its collectives from autograd's device thread: the
    recording mode reaches that thread (autograd carries the caller's
    dispatch modes to it), and its work lands in the capture because
    autograd runs each backward node on its forward's stream, the
    capturing one.  On the CPU the first call is checked alike.

    The call is bound to its first arguments' signature (``_signature``):
    where ``jax.jit`` would trace again, a later call whose trees differ in
    structure or key order, or whose tensors differ in shape, dtype,
    device or placements, raises ``CaptureError`` naming ``name`` and the
    first leaf that differs, on either device (a copy into the static
    buffers would broadcast, cast or land in the wrong buffer).
    """

    def __init__(self, fn, name: str, donate: Sequence[bool] = (), group=None, resident: Sequence[bool] = (),
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.name = name
        self.donate = tuple(donate)
        self.resident = tuple(resident)
        self.group = group
        self.generators = tuple(generators)
        self.pool_bytes = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static = None
        self.outputs = None
        self.compiles = 0  # captures (one a call site, as jax.jit's compile)
        self.graph_replays = 0
        self.signature = None
        self.sequence: Optional[List[tuple]] = None  # the collectives of one call, over a mesh
        _CALLS.add(self)

    def release(self) -> None:
        """Drop the graph, its pool and the static buffers: the next call
        on the card captures again (one more compile)."""
        self.graph = self.static = self.outputs = None

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self, *args):
        self._check(args)
        first = next((x for x in leaves(args) if torch.is_tensor(x)), None)
        if first is None or first.device.type != "cuda":
            self.compiles += self.compiles == 0
            if self.group is not None and self.sequence is None and first is not None:
                return self._agreed(args, first.device)
            return self.fn(*args)
        if self.graph is None:
            return self._capture(args, first.device)
        self._load(args)
        self.graph.replay()
        self.graph_replays += 1
        return self._hand_out(self.outputs)

    def _agreed(self, args, device: torch.device):
        """``fn(*args)`` with its collectives recorded, then checked to be
        every rank's (``agree``).  The donated arguments' blocks are copied
        to the host first and put back before the check raises, so a rank
        whose program differs leaves the caller's state as it was."""
        donated = [x for a, d in zip(args, _padded(self.donate, len(args))) if d
                   for x in leaves(a) if torch.is_tensor(x)]
        saved = [_local(x).to("cpu", copy=True) for x in donated]
        with _Collectives() as rec:
            out = self.fn(*args)
        self.sequence = rec.sequence
        try:
            agree(self.sequence, self.group, self.name, device)
        except CaptureError:
            with torch.no_grad():
                for x, h in zip(donated, saved):
                    _local(x).copy_(h)
            raise
        return out

    def _capture(self, args, device: torch.device):
        keep = zip(_padded(self.donate, len(args)), _padded(self.resident, len(args)))
        self.static = tuple(a if d or r else tree_map(lambda x: _clone(x) if torch.is_tensor(x) else x, a)
                            for a, (d, r) in zip(args, keep))
        collective = self.group is not None
        stream = _side_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            # the warm-up: the first call's result
            out = self._agreed(self.static, device) if collective else self.fn(*self.static)
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()  # the graph's private pool takes what the warm-up freed
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            if g.device.type == "cuda":
                graph.register_generator_state(g)
        reserved = torch.cuda.memory_reserved(device)
        with torch.cuda.stream(stream), _collector_off():
            pool = _begin_capture(graph, collective)
            try:
                self.outputs = self.fn(*self.static)
            except BaseException as e:
                _abort_capture(graph, pool, device)
                if isinstance(e, torch.cuda.OutOfMemoryError):
                    raise
                raise CaptureError(f"capturing {self.name} failed: {type(e).__name__}: {e}") from e
            graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.graph = graph
        self.compiles += 1
        return out

    def _check(self, args) -> None:
        sig = {k: _signature(v) for k, v in flatten_with_paths(args).items()}
        if self.signature is None:
            self.signature = sig
        elif list(sig.items()) != list(self.signature.items()):  # dict equality ignores the order
            now, first = list(sig) + [None], list(self.signature) + [None]
            i = next((i for i, (a, b) in enumerate(zip(now, first)) if a != b), None)
            if i is not None:
                raise CaptureError(f"{self.name}: leaf {i} of its arguments is {now[i]}, its first call's was "
                                   f"{first[i]} (another tree structure or key order)")
            path = next(k for k in sig if sig[k] != self.signature[k])
            raise CaptureError(f"{self.name}: argument {path} is {sig[path]}, its first call's was "
                               f"{self.signature[path]}")

    @torch.no_grad()
    def _load(self, args) -> None:
        for s, a in zip(leaves(self.static), leaves(args)):
            if torch.is_tensor(s) and a is not s:
                _local(s).copy_(_local(a))

    def _hand_out(self, outputs):
        own = {id(x) for x in leaves(self.static) if torch.is_tensor(x)}
        return tree_map(lambda x: x if not torch.is_tensor(x) or id(x) in own else _clone(x), outputs)


def release_calls() -> None:
    """``release`` every live ``CapturedCall``."""
    for call in list(_CALLS):
        call.release()
