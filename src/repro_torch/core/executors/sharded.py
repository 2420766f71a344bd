"""Sharded executor — the DuctTeip wrapper analog over a ``torch.distributed``
``DeviceMesh``.

DuctTeip distributes level-1 blocks over MPI ranks (owner computes) and
moves panel blocks with messages.  The JAX package places its roots with a
``NamedSharding`` and leaves both to XLA's SPMD partitioner; here they are
explicit (``src/repro_torch/DESIGN.md``):

- **Placement.**  A root is placed at its first leaf plan, over the grid of
  that plan's blocks: a grid dimension its mesh axis divides is split
  (block row ``i`` belongs to coordinate ``i * W // nr`` of the ``data``
  axis, the contiguous chunks of a row ``NamedSharding``), any other
  replicated, as the reference's fallback.  A split root keeps only this
  rank's part: its value is a ``DTensor`` (``Shard(d)`` on each mesh dim
  that splits dim ``d``, ``Replicate()`` elsewhere).
- **Storage.**  Inside a drain a split root lives in a ``SplitStore`` per
  rank: a ``(1, K, br, bc)`` tensor holding the owned blocks first, in
  row-major order, then one slot for each block of another rank that a
  launch list reads.  The plan's block indices are remapped into it on the
  host once per owned cut; the tile kernels and their plain versions
  address ``(0, k)`` as any grid block, unchanged.  Each captured list
  owns a static store of the blocks it needs and hands it to the root
  after its run; the next list copies the root's owned blocks into its
  own.
- **Owner computes.**  In each issue slot a rank runs only the tasks whose
  written block it owns.  A task writing a replicated root runs on every
  rank.
- **Exchange.**  From the plan's read and write sets (``plan_exchanges``):
  for each issue slot, every block written in it (before the first slot:
  the list's inputs) that a task on another rank reads before the block is
  written again goes from its owner straight into that rank's received
  slot.  One ``all_to_all_single`` over the mesh's ranks a slot (and
  dtype), only in slots where a block moves; every rank derives the same
  list, so no rank waits on a collective another skips.
- **Whole only by a collective.**  A path that needs a split root whole —
  the per-group fallback, a list whose blocks the split does not divide —
  gathers it with one ``all_gather`` that every rank issues (``gather``),
  counted as an exchange.

At world size 1, and for a plan whose roots all fell back to replication,
no collective is issued: the launch list is the local executor's, captured
into one CUDA graph per list on the card.  Otherwise this rank's cut of the
list, its exchanges' collectives inside, is captured into one CUDA graph
over static stores of its own (``OwnedCapture``): the counterpart, rank by
rank, of the reference's one jitted SPMD program; the first drain captures
it and every later run, the drain memo's included, replays it.  Before each
capture every rank checks that all hold the list's collective sequence.
On the CPU the same object runs the list eagerly over the same stores.  The
per-group fallback and a list whose grid does not split gather the root
whole (below) and stay eager.

Counters: ``tasks``, ``launches``, ``groups``, ``groups_prefusion``,
``slots`` and ``compiles`` count the whole plan on every rank, as the JAX
package's single SPMD program does; ``owned_tasks`` counts the tasks this
rank computed, ``exchanges`` the collectives it issued, ``exchanged_bytes``
and ``received_bytes`` the payload it sent and received,
``resident_bytes`` the most its launch lists held at once in stores (a
root's store counted at the most blocks its lists have given it,
``SplitStore.high``) and whole grids, and ``graph_replays`` the lists it
ran as graph replays.
"""

from __future__ import annotations

import hashlib
import math
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ...testing import faults
from ..data import GData, Split, SplitError, SplitStore, from_grid, host_to_device, to_grid
from ..task import GTask
from .captured import CapturedProgram, agree, group_desc
from .jit_wave import WaveExecutor
from .wave_program import GroupPlan, SchedulePlan, build_program


@dataclass(frozen=True)
class Placement:
    """Where a root (or its grid) lies on a mesh: per dimension a mesh axis,
    or None for replication, and that axis's size — the counterpart of a
    JAX ``NamedSharding``.  ``dims`` are the sizes it was made for."""

    dims: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]
    sizes: Tuple[int, ...]

    @property
    def distributed(self) -> bool:
        """True when some dimension is split over more than one rank."""
        return any(s > 1 for s in self.sizes)

    def owned(self, idx: np.ndarray, coord: Dict[str, int]) -> np.ndarray:
        """Which of the ``(k, ndim)`` block coordinates ``idx`` the rank at
        mesh coordinate ``coord`` owns: along each split dimension, block
        ``i`` belongs to coordinate ``i * size // dim``."""
        mine = np.ones(len(idx), dtype=bool)
        for k, (ax, size) in enumerate(zip(self.spec, self.sizes)):
            if ax is not None and size > 1:
                mine &= idx[:, k] * size // self.dims[k] == coord[ax]
        return mine

    def dtensor_placements(self, names: Sequence[str]) -> tuple:
        """The DTensor placements over mesh dims ``names``: ``Shard(d)``
        where the mesh dim splits dim ``d``, else ``Replicate()``."""
        out = []
        for name in names:
            dims = [d for d, (ax, s) in enumerate(zip(self.spec, self.sizes)) if ax == name and s > 1]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def _axis_size(mesh, ax: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(ax))


def _placement(mesh, dims: Sequence[int], axes: Tuple[Optional[str], ...]) -> Placement:
    spec, sizes = [], []
    for dim, ax in zip(dims, axes):
        size = 1 if ax is None else _axis_size(mesh, ax)
        keep = ax is not None and dim % size == 0
        spec.append(ax if keep else None)
        sizes.append(size if keep else 1)
    return Placement(tuple(dims), tuple(spec), tuple(sizes))


def row_sharding(mesh, data: GData, axes: Tuple[Optional[str], ...]) -> Placement:
    """Placement of ``data`` with per-dimension mesh axes, replicated along
    any dimension its axis does not divide."""
    return _placement(mesh, data.shape, axes)


def mesh_device(mesh, device=None):
    """The device a rank of ``mesh`` keeps its data on: ``cuda:<local rank>``
    for a CUDA mesh, the CPU for a CPU mesh.  A ``device`` naming another
    raises; nothing falls back to the CPU.  Without a mesh, ``device`` as
    given (the entry points resolve it)."""
    if mesh is None:
        return device
    if mesh.device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs CUDA, which is not available")
        dev = torch.device("cuda", mesh.get_rank() % torch.cuda.device_count())
    else:
        dev = torch.device(mesh.device_type)
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or (want.index is not None and want.index != dev.index):
            raise ValueError(f"device {str(want)!r} contradicts the mesh's device {str(dev)!r}")
    return dev


def mesh_group(mesh):
    """The process group over every rank of ``mesh``."""
    for i in range(mesh.ndim):
        if mesh.size(i) == mesh.size():
            return mesh.get_group(i)
    if sorted(mesh.mesh.flatten().tolist()) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return mesh._flatten().get_group()


def drained(executor, data: GData) -> torch.Tensor:
    """The value an entry point returns for a drained root: under a
    ``ShardExecutor`` a DTensor of this rank's part when the root is split
    (``ShardExecutor.result``), else the whole tensor (a resident grid is
    de-gridded)."""
    if isinstance(executor, ShardExecutor):
        return executor.result(data)
    return from_grid(data.grid) if data.in_grid_epoch else data.value


# -- the cut of a plan over the mesh: pure host functions of the plan -------------
def _coords(shape: Tuple[int, ...]) -> np.ndarray:
    """(P, ndim) mesh coordinates of each mesh position, row-major."""
    return np.stack(np.unravel_index(np.arange(math.prod(shape)), shape), axis=1)


def _owners(pl: Placement, ix: np.ndarray, coords: np.ndarray, names: Sequence[str]) -> np.ndarray:
    """(k, P): which mesh positions own each of the ``(k, 2)`` blocks."""
    return np.stack([pl.owned(ix, dict(zip(names, c))) for c in coords], axis=1)


def plan_exchanges(plan: SchedulePlan, placements: Sequence[Placement], shape: Tuple[int, ...],
                   names: Sequence[str]):
    """Who runs each task, and which blocks move, for ``plan`` over a mesh of
    ``shape`` with dims ``names`` (``placements`` per root slot, over its
    grid).  Returns (per group in plan order a ``(size, P)`` bool array of
    the positions that run each task; and per exchange point — -1 before
    the first slot, ``s`` after slot ``s`` — the sorted messages ``(src,
    dst, root slot, i, j)``, mesh positions row-major).

    A task runs on the owners of its written block (every position for a
    replicated root).  A block a task reads on a position that does not own
    it moves there from the owner with the reader's coordinates on the axes
    its root is not split over, after the slot that wrote the version read
    (or before the first slot), once per version and reader."""
    coords = _coords(tuple(shape))
    axis = {n: i for i, n in enumerate(names)}

    def source(r: int, i: int, j: int, q: int) -> int:
        pl = placements[r]
        c = coords[q].copy()
        for d, (ax, size) in enumerate(zip(pl.spec, pl.sizes)):
            if ax is not None and size > 1:
                c[axis[ax]] = (i, j)[d] * size // pl.dims[d]
        return int(np.ravel_multi_index(tuple(c), tuple(shape)))

    last: Dict[tuple, int] = {}  # (root, i, j) -> slot of its latest write
    moves = set()
    runners = []
    for s, slot in enumerate(plan.slots):
        written = []
        for g in slot:
            run = np.ones((g.size, len(coords)), dtype=bool)
            off = 0
            for slots_, size in g.segments:
                rows = slice(off, off + size)
                split_w = [a for a in g.write_pos if placements[slots_[a]].distributed]
                if split_w:
                    run[rows] = _owners(placements[slots_[split_w[0]]], g.idxs[split_w[0]][rows], coords, names)
                    for a in split_w[1:]:
                        if not np.array_equal(_owners(placements[slots_[a]], g.idxs[a][rows], coords, names),
                                              run[rows]):
                            raise ValueError(f"{g.op.name} writes blocks of split roots that other ranks own")
                for a, r in enumerate(slots_):
                    if placements[r].distributed:
                        ix = g.idxs[a][rows]
                        miss = run[rows] & ~_owners(placements[r], ix, coords, names)
                        for m, q in zip(*np.nonzero(miss)):
                            i, j = int(ix[m, 0]), int(ix[m, 1])
                            moves.add((last.get((r, i, j), -1), source(r, i, j, int(q)), int(q), r, i, j))
                for a in g.write_pos:
                    written += [(slots_[a], int(i), int(j)) for i, j in g.idxs[a][rows]]
                off += size
            runners.append(run)
        for key in written:
            last[key] = s
    messages: Dict[int, list] = {}
    for point, *msg in sorted(moves):
        messages.setdefault(point, []).append(tuple(msg))
    return runners, messages


def _local_grid(pl: Placement, coord: np.ndarray, axis: Dict[str, int]) -> Tuple[int, int, int, int]:
    """(first block row, first block column, rows, columns) a position owns."""
    first, count = [], []
    for d, (ax, size) in enumerate(zip(pl.spec, pl.sizes)):
        n = pl.dims[d]
        split = ax is not None and size > 1
        first.append(int(coord[axis[ax]]) * n // size if split else 0)
        count.append(n // size if split else n)
    return first[0], first[1], count[0], count[1]


class _Send:
    """One exchange point's collective for roots of one dtype: gather this
    rank's outgoing blocks from its stores, ``all_to_all_single`` over the
    mesh's ranks, scatter the incoming ones into the received slots."""

    def __init__(self, send, in_splits, recv, out_splits, blocks, group, dtype, device):
        # send / recv: runs of (root slot, store positions) in buffer order
        self.send, self.recv = send, recv
        self.in_splits, self.out_splits = in_splits, out_splits
        self.blocks, self.group = blocks, group
        self.dtype, self.device = dtype, device

    def __call__(self, grids: Sequence[torch.Tensor]) -> None:
        if self.send:
            inp = torch.cat([grids[r][0, ix].reshape(-1) for r, ix in self.send])
        else:
            inp = torch.empty(0, dtype=self.dtype, device=self.device)
        out = torch.empty(sum(self.out_splits), dtype=self.dtype, device=self.device)
        dist.all_to_all_single(out, inp, self.out_splits, self.in_splits, group=self.group)
        off = 0
        for r, ix in self.recv:
            br, bc = self.blocks[r]
            n = ix.numel() * br * bc
            grids[r][0, ix] = out[off : off + n].view(-1, br, bc)
            off += n


def _runs(entries, device):
    """Consecutive (root, position) entries of one root as one index tensor."""
    runs: List[Tuple[int, list]] = []
    for r, pos in entries:
        if runs and runs[-1][0] == r:
            runs[-1][1].append(pos)
        else:
            runs.append((r, [pos]))
    return [(r, host_to_device(torch.tensor(p, dtype=torch.int64), device)) for r, p in runs]


class OwnedProgram:
    """A planned launch list cut by issue slot into this rank's owned
    groups over its stores, each slot followed by the sends of the blocks
    another rank reads (module docstring).  Holds no data handle: only the
    lists, the index tensors and the exchange plans.  ``store_blocks`` is
    the store each split root needs (owned plus received blocks)."""

    def __init__(self, plan: SchedulePlan, placements: List[Placement], backend: str, shape, names,
                 me: int, group, group_rank: Sequence[int]):
        device = plan.flat_idxs.device
        dtypes = [plan.datas[d].dtype for d in plan.roots_order]
        self.placements = placements
        coords = _coords(tuple(shape))
        axis = {n: i for i, n in enumerate(names)}
        runners, messages = plan_exchanges(plan, placements, shape, names)

        self.messages = messages
        local = self._local = {r: _local_grid(pl, coords[me], axis)
                               for r, pl in enumerate(placements) if pl.distributed}
        slot_of = self._slot_of = {r: {} for r in local}
        for point in sorted(messages):
            for src, dst, r, i, j in messages[point]:
                if dst == me and (i, j) not in slot_of[r]:
                    slot_of[r][(i, j)] = local[r][2] * local[r][3] + len(slot_of[r])
        self.store_blocks = [local[r][2] * local[r][3] + len(slot_of[r]) if r in local else 0
                             for r in range(len(placements))]
        pos = self.position

        def remap(r: int, ix: np.ndarray) -> np.ndarray:
            if r not in local:
                return ix
            out = np.zeros_like(ix)
            out[:, 1] = [pos(r, int(i), int(j)) for i, j in ix]
            return out

        # this rank's groups, slot by slot, over the stores
        self.n_owned = 0
        steps = []
        gi = 0
        for slot in plan.slots:
            own: List[GroupPlan] = []
            for g in slot:
                keep = runners[gi][:, me]
                gi += 1
                segments, parts, off = [], [[] for _ in g.idxs], 0
                for slots_, size in g.segments:
                    k = keep[off : off + size]
                    if k.any():
                        segments.append((slots_, int(k.sum())))
                        for a, r in enumerate(slots_):
                            parts[a].append(remap(r, g.idxs[a][off : off + size][k]))
                    off += size
                if segments:
                    own.append(GroupPlan(g.op, g.write_pos, tuple(segments),
                                         tuple(np.concatenate(p, axis=0) for p in parts), g.height))
                    self.n_owned += sum(n for _, n in segments)
            fn = idxs = None
            if own:
                flat = np.concatenate([ix for g in own for ix in g.idxs], axis=0).astype(np.int32)
                idxs = host_to_device(torch.from_numpy(flat), device)
                sub = SchedulePlan(plan.roots_order, plan.datas, plan.blocks, [own], [], (), idxs, 0)
                fn = build_program(sub, backend)
            steps.append((fn, idxs))

        # the sends: one collective a point and dtype, on every rank alike
        self.n_exchanges = self.sent_bytes = self.received_bytes = 0
        sends: Dict[int, list] = {}
        for point in sorted(messages):
            for dt in dict.fromkeys(dtypes):
                msgs = [m for m in messages[point] if dtypes[m[2]] == dt]
                if not msgs:
                    continue
                # this rank's blocks to each rank, and from each, in group-rank
                # order and then (root, i, j) on both sides
                out_ = sorted((group_rank[d], r, i, j) for s, d, r, i, j in msgs if s == me)
                in_ = sorted((group_rank[s], r, i, j) for s, d, r, i, j in msgs if d == me)
                in_splits, out_splits = [0] * len(group_rank), [0] * len(group_rank)
                for splits, entries in ((in_splits, out_), (out_splits, in_)):
                    for g, r, _, _ in entries:
                        splits[g] += plan.blocks[r][0] * plan.blocks[r][1]
                ex = _Send(_runs([(r, pos(r, i, j)) for _, r, i, j in out_], device), in_splits,
                           _runs([(r, pos(r, i, j)) for _, r, i, j in in_], device), out_splits,
                           plan.blocks, group, dt, device)
                sends.setdefault(point, []).append(ex)
                self.n_exchanges += 1
                self.sent_bytes += sum(in_splits) * dt.itemsize
                self.received_bytes += sum(out_splits) * dt.itemsize
        self.first = sends.get(-1, [])
        self.steps = [(fn, idxs, sends.get(s, [])) for s, (fn, idxs) in enumerate(steps)]
        # what every rank must issue alike: per exchange point, its collectives
        self.sequence = [(point, "all_to_all_single", str(ex.dtype)) for point in sorted(sends) for ex in sends[point]]

    def position(self, r: int, i: int, j: int) -> int:
        """Where block ``(i, j)`` of split root slot ``r`` lies in this rank's
        store: an owned block's row-major place, else its received slot."""
        r0, c0, nr, nc = self._local[r]
        if r0 <= i < r0 + nr and c0 <= j < c0 + nc:
            return (i - r0) * nc + (j - c0)
        return self._slot_of[r][(i, j)]

    def __call__(self, grids: Sequence[torch.Tensor]) -> None:
        for ex in self.first:
            ex(grids)
        for fn, idxs, exchanges in self.steps:
            if fn is not None:
                fn(grids, idxs)
            for ex in exchanges:
                ex(grids)


class OwnedCapture(CapturedProgram):
    """An ``OwnedProgram`` captured into one CUDA graph over static storage,
    the exchanges' ``all_to_all_single`` calls inside: this rank's part of
    the reference's one jitted SPMD program (``src/repro_torch/DESIGN.md``).

    It owns a static ``(1, K, br, bc)`` store for each split root, sized
    ``store_blocks`` (owned blocks first, then the received slots), and a
    static ``(nr, nc, br, bc)`` grid for each replicated root; the index
    tensors and the sends' index runs are the program's own, fixed for its
    plan.  A run copies each root's owned blocks in (not when its store
    already is the static store), runs, and hands the static stores back
    (``GData.adopt_split``, ``adopt_grid``); a handle that still reads a
    static store gets its own copy before a run overwrites it
    (``_release``).  A static store never grows: a list that needs more
    blocks is another program.

    Before the warm-up, every rank checks that all hold the list's
    collective sequence (``agree``).  The warm-up, on scratch stores, runs
    the collectives once eagerly (creating the communicators outside the
    capture); the capture is thread-local (``captured._begin_capture``).
    On the CPU the list runs eagerly over the same static stores."""

    collective = True

    def __init__(self, prog: OwnedProgram, plan: SchedulePlan, group):
        device = plan.flat_idxs.device
        key = hashlib.sha1(repr(plan.key).encode()).hexdigest()[:10]
        self.name = f"launch list {key} ({plan.n_groups} groups, {plan.n_slots} slots)"
        specs = []
        for d, (br, bc), pl, k in zip((plan.datas[i] for i in plan.roots_order), plan.blocks, prog.placements,
                                      prog.store_blocks):
            shape = (1, k, br, bc) if pl.distributed else (d.shape[0] // br, d.shape[1] // bc, br, bc)
            specs.append((shape, d.dtype))
        agree([(*c, group_desc(group)) for c in prog.sequence], group, self.name, device)
        self._setup(prog, specs, device)

    @property
    def prog(self) -> OwnedProgram:
        return self.fn

    def _call(self, grids: List[torch.Tensor]) -> None:
        self.fn(grids)

    def _release(self, i: int) -> None:
        ref = self._holders[i]
        holder = ref() if ref is not None else None
        g = self.grids[i]
        if holder is not None and holder.split is not None and holder.split.store is g:
            holder.adopt_split(holder.split.copy())
            self._holders[i] = None
        else:
            super()._release(i)

    def load(self, datas: Sequence[GData], blocks, splits: Sequence[Optional[Split]], ex: "ShardExecutor") -> None:
        """Copy each root's blocks into its static store or grid (``splits``:
        each split root's layout, None for a replicated one)."""
        for i, (d, (br, bc), split, g) in enumerate(zip(datas, blocks, splits, self.grids)):
            if split is None:
                ex.gather(d)
                if d.grid is not g:
                    self._release(i)
                    d.write_grid(g, br, bc)
                continue
            sp = d.split
            if sp is not None and sp.store is g:
                continue
            self._release(i)
            nr, nc = split.local_shape[0] // br, split.local_shape[1] // bc
            owned = g[0, : nr * nc].view(nr, nc, br, bc)
            if sp is not None and sp.split == split and sp.block == (br, bc):
                owned.copy_(sp.owned())
            else:
                to_grid(ex._part(d, split), br, bc, out=owned)

    def hand_back(self, datas: Sequence[GData], blocks, splits: Sequence[Optional[Split]]) -> int:
        """Make each static store or grid its root's; returns the bytes the
        roots' stores and grids hold, a store counted at the most blocks
        its root's stores have held (``SplitStore.high``)."""
        resident = 0
        for i, (d, blk, split, g) in enumerate(zip(datas, blocks, splits, self.grids)):
            if split is None:
                d.adopt_grid(g, blk)
                resident += g.numel() * g.element_size()
            else:
                sp, high = d.split, g.shape[1]
                if sp is not None and sp.split == split and sp.block == tuple(blk):
                    high = max(high, sp.high)
                d.adopt_split(SplitStore.over(split, blk, g, high))
                resident += high * g[0, 0].numel() * g.element_size()
            self._holders[i] = weakref.ref(d)
        return resident


class ShardExecutor(WaveExecutor):
    """Counterpart of the JAX package's ``ShardExecutor``: the wave
    executor's plans and launch lists (``backend="torch"`` for g3/g3flat,
    ``"cuda"`` for g4's hand-written tile kernels), run owner-computes over
    ``mesh`` on each rank's own blocks (module docstring)."""

    name = "shard"

    def __init__(self, mesh, backend: str = "torch",
                 shard_axes: Tuple[Optional[str], ...] = ("data", None), **kw):
        super().__init__(backend=backend, **kw)
        names = mesh.mesh_dim_names
        if names is None or any(ax is not None and ax not in names for ax in shard_axes):
            raise ValueError(f"shard_axes {shard_axes} name axes the mesh {names} does not have")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self.mesh = mesh
        self.shard_axes = tuple(shard_axes)
        self._me = int(np.ravel_multi_index(tuple(coord), tuple(mesh.mesh.shape)))
        self._group = None
        self._placements: Dict[int, Placement] = {}

    @property
    def group(self):
        """The process group over the mesh's ranks (made on first use)."""
        if self._group is None:
            self._group = mesh_group(self.mesh)
        return self._group

    def _group_ranks(self) -> List[int]:
        return [dist.get_group_rank(self.group, g) for g in self.mesh.mesh.flatten().tolist()]

    def place(self, data: GData, block: Optional[Tuple[int, int]] = None) -> None:
        """Distribute a root over the mesh (owner-computes layout), over the
        grid of ``block`` (by default its finest partition's block): a root
        split there keeps only this rank's part, a ``DTensor`` (module
        docstring).  Cutting a whole value issues no collective."""
        if data.device.type != self.mesh.device_type:
            raise ValueError(f"{data.name} lies on {data.device}, the mesh on {self.mesh.device_type}")
        br, bc = data._level_block_shape(data.n_levels - 1) if block is None else block
        grid = _placement(self.mesh, (data.shape[0] // br, data.shape[1] // bc), self.shard_axes)
        pl = self._placements[data.id] = Placement(tuple(data.shape), grid.spec, grid.sizes)
        if pl.distributed and data.has_value and not data.is_split:
            split = self._split(data, pl)
            data.value = split.wrap(self._part(data, split).clone())

    def _split(self, data: GData, pl: Placement) -> Split:
        return Split.of(self.mesh, pl.dtensor_placements(self.mesh.mesh_dim_names), tuple(data.shape))

    def _part(self, data: GData, split: Split) -> torch.Tensor:
        """This rank's part of ``data`` in root layout, without a collective:
        from its store, a DTensor split as ``split``, or a whole value."""
        if data.split is not None and data.split.split == split:
            return from_grid(data.split.owned())
        v = data.value
        if isinstance(v, DTensor):
            if v.device_mesh != self.mesh or tuple(v.placements) != split.placements:
                raise SplitError(f"{data.name} is split as {tuple(v.placements)} over another mesh or placement "
                                 f"than {split.placements}")
            return v.to_local()
        (r0, c0), (m, k) = split.offset, split.local_shape
        return v[r0 : r0 + m, c0 : c0 + k]

    def gather(self, data: GData) -> None:
        """Make a split root whole on this rank: one ``all_gather`` over the
        mesh's ranks, which every rank issues; counted under ``exchanges``.
        A root that is not split is left as it is."""
        if not data.is_split:
            return
        v = data.value
        split = Split.of_dtensor(v)
        local = v.to_local().contiguous()
        ranks = self._group_ranks()
        parts = [torch.empty_like(local) for _ in ranks]
        dist.all_gather(parts, local, group=self.group)
        whole = torch.empty(tuple(data.shape), dtype=local.dtype, device=local.device)
        sizes = tuple(self.mesh.mesh.shape)
        for p, coord in enumerate(_coords(sizes)):
            r0, c0 = split.offset_at(sizes, coord)
            whole[r0 : r0 + local.shape[0], c0 : c0 + local.shape[1]] = parts[ranks[p]]
        data.value = whole
        nbytes = local.numel() * local.element_size() * (len(ranks) - 1)
        self.stats["exchanges"] += 1
        self.stats["exchanged_bytes"] += nbytes
        self.stats["received_bytes"] += nbytes

    def result(self, data: GData) -> torch.Tensor:
        """``data``'s value after a drain: a DTensor of this rank's part when
        its placement splits it (a whole value is cut without a collective),
        else the whole tensor."""
        pl = self._placements.get(data.id)
        if pl is not None and pl.distributed and not data.is_split:
            split = self._split(data, pl)
            data.value = split.wrap(self._part(data, split).clone())
        return data.value

    def memo_key_extra(self) -> tuple:
        # axis sizes alone do not identify a mesh: two meshes of one shape
        # over other ranks own other blocks, so the ranks are in every key
        m = self.mesh
        mesh_desc = (tuple(m.mesh_dim_names), tuple(m.mesh.shape), m.device_type,
                     tuple(m.mesh.flatten().tolist()))
        return super().memo_key_extra() + (mesh_desc, self.shard_axes)

    def _grid_sharding(self, data: GData, br: int, bc: int) -> Placement:
        """Place the resident ``(nr, nc, br, bc)`` grid of a placed root over
        its grid dimensions, on the axes the root is placed on (block rows
        owned by mesh rows); block dimensions are never split."""
        axes = self._placements[data.id].spec
        return _placement(self.mesh, (data.shape[0] // br, data.shape[1] // bc), axes)

    def _prepare_roots(self, waves: Sequence[Sequence[GTask]]) -> None:
        # place any root not placed yet, before planning, over the grid of
        # its first leaf block
        for wave in waves:
            for t in wave:
                for v in t.args:
                    d = v.data
                    if d.id not in self._placements and d.has_value:
                        self.place(d, v.region.shape)

    def execute_schedule(self, waves: List[List[GTask]], dag=None) -> int:
        self._prepare_roots(waves)
        return super().execute_schedule(waves, dag)

    def _own_written_roots(self, tasks) -> None:
        # the fallback runs on whole roots
        tasks = list(tasks)
        for d in {v.data.id: v.data for t in tasks for v in t.args}.values():
            self.gather(d)
        WaveExecutor._own_written_roots(tasks)

    def _run_group(self, tasks: List[GTask]) -> None:
        # the per-group fallback runs on every rank, on whole roots:
        # identical inputs give identical results
        self._prepare_roots([tasks])
        for d in {v.data.id: v.data for t in tasks for v in t.args}.values():
            self.gather(d)
        super()._run_group(tasks)
        self.stats["owned_tasks"] += len(tasks)

    def _list_for(self, plan: SchedulePlan, batch: Optional[int]):
        placements = [self._grid_sharding(plan.datas[d], *blk) for d, blk in zip(plan.roots_order, plan.blocks)]
        if batch is not None or not any(p.distributed for p in placements):
            return super()._list_for(plan, batch)
        key = ("owned", self.memo_key_extra()) + plan.key
        progs = self._fn_cache.get(key)
        built = progs is None
        if built:
            progs = self._fn_cache[key] = {}
            self.stats["compiles"] += 1
        # plan.key does not fix the block indices, and ownership follows them
        ikey = np.concatenate([ix for g in plan.groups() for ix in g.idxs], axis=0).tobytes()
        fn = progs.get(ikey)
        if fn is None:
            prog = OwnedProgram(plan, placements, self.backend, tuple(self.mesh.mesh.shape),
                                self.mesh.mesh_dim_names, self._me, self.group, self._group_ranks())
            fn = progs[ikey] = OwnedCapture(prog, plan, self.group)
        return fn, built

    def _launch(self, fn, idxs, blocks, slots: Sequence, batch, n_tasks: int, replay: bool,
                built: bool = False) -> None:
        if not isinstance(fn, OwnedCapture):
            for d in slots:  # distributed graphs never stack: one datum a slot
                self.gather(d)
            super()._launch(fn, idxs, blocks, slots, batch, n_tasks, replay, built)
            self.stats["owned_tasks"] += n_tasks
            return
        faults.fire("executor.launch", batch=batch, n_tasks=n_tasks, replay=replay)
        faults.fire("launch.oom", batch=batch, n_tasks=n_tasks, replay=replay)
        splits = []
        for d, pl in zip(slots, fn.prog.placements):
            root = self._placements.setdefault(d.id, Placement(tuple(d.shape), pl.spec, pl.sizes)) \
                if pl.distributed else None
            splits.append(None if root is None else self._split(d, root))
        fn.load(slots, blocks, splits, self)
        fn.run()
        self.last_program = None
        if fn.captured:
            self.stats["graph_replays"] += 1
        self._corrupt_outputs(fn.grids, batch=batch, replay=replay)
        self._note_launch(idxs.device, "replay" if replay else "program")
        resident = fn.hand_back(slots, blocks, splits)
        self.stats["resident_bytes"] = max(self.stats["resident_bytes"], resident)
        prog = fn.prog
        self.stats["owned_tasks"] += prog.n_owned
        self.stats["exchanges"] += prog.n_exchanges
        self.stats["exchanged_bytes"] += prog.sent_bytes
        self.stats["received_bytes"] += prog.received_bytes
