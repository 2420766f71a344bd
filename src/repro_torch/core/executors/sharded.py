"""Sharded executor — the DuctTeip wrapper analog over a ``torch.distributed``
``DeviceMesh``.

DuctTeip distributes level-1 blocks over MPI ranks (owner computes) and
moves panel blocks with messages.  The JAX package places its roots with a
``NamedSharding`` and leaves both to XLA's SPMD partitioner; here they are
explicit (``src/repro_torch/DESIGN.md``):

- **Placement.**  ``row_sharding`` maps each root dimension to a mesh axis
  or to None, falling back to replication where the dimension does not
  divide by the axis size (it never fails to place).  The resident
  ``(nr, nc, br, bc)`` grid is placed over its grid dimensions
  (``_grid_sharding``): block row ``i`` belongs to coordinate
  ``i * W // nr`` of the ``data`` axis, contiguous chunks as a row
  ``NamedSharding`` gives.
- **Owner computes.**  In each issue slot of a planned launch list a rank
  runs only the tasks whose written block it owns.  A task writing a
  replicated root, or several blocks, runs on every rank.
- **Exchange.**  After each slot the blocks written in it are made current
  on every rank: each rank gathers the slot's written blocks into one
  buffer, puts -0.0 where it is not the owner (``x + -0.0 == x`` for every
  x, signed zeros included) and all-reduces it over each mesh axis the
  roots are split on — one collective a slot and axis, not one a block.
- **Storage** stays a full grid on every rank.

At world size 1, and for a plan whose roots all fell back to replication,
no collective is issued: the launch list is the local executor's, captured
into one CUDA graph per list on the card.  Otherwise the list runs slot by
slot, eagerly, with the exchanges between slots, and the drain memo replays
it so.

Counters: ``tasks``, ``launches``, ``groups``, ``groups_prefusion``,
``slots`` and ``compiles`` count the whole plan on every rank, as the JAX
package's single SPMD program does; ``owned_tasks`` counts the tasks this
rank computed, ``exchanges`` the collectives it issued and
``exchanged_bytes`` their payload.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ...testing import faults
from ..data import GData, host_to_device
from ..task import GTask
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


class _Exchange:
    """One slot's exchange for roots of one dtype sharded on the same axes:
    gather the written blocks, put -0.0 where this rank is not the owner,
    all-reduce over each axis's group, scatter back."""

    def __init__(self, entries, groups, block_of):
        # entries: (root slot, rows, cols, not-mine mask) tensors on the device
        self.entries = entries
        self.groups = groups
        self.block_of = block_of
        self.numel = sum(rows.numel() * block_of[r][0] * block_of[r][1] for r, rows, _, _ in entries)

    def __call__(self, grids: Sequence[torch.Tensor]) -> None:
        parts = []
        for r, rows, cols, other in self.entries:
            parts.append(grids[r][rows, cols].masked_fill_(other[:, None, None], -0.0).reshape(-1))
        buf = parts[0] if len(parts) == 1 else torch.cat(parts)
        for group in self.groups:
            dist.all_reduce(buf, group=group)
        off = 0
        for r, rows, cols, _ in self.entries:
            br, bc = self.block_of[r]
            n = rows.numel() * br * bc
            grids[r].index_put_((rows, cols), buf[off : off + n].view(-1, br, bc))
            off += n


class OwnedProgram:
    """A planned launch list cut by issue slot into this rank's owned
    groups, each slot followed by the exchange of the blocks written in it
    (module docstring).  Holds no data handle: only the lists, the index
    tensors and the exchange plans."""

    def __init__(self, plan: SchedulePlan, placements: List[Placement], backend: str, mesh,
                 coord: Dict[str, int]):
        device = plan.flat_idxs.device
        dtypes = [plan.datas[d].dtype for d in plan.roots_order]
        self.steps = []
        self.n_owned = 0
        self.n_exchanges = 0
        self.exchanged_bytes = 0
        for slot in plan.slots:
            own: List[GroupPlan] = []
            shared: Dict[tuple, list] = {}  # (dtype, axes) -> exchange entries
            for g in slot:
                keep = np.ones(g.size, dtype=bool)
                if len(g.write_pos) == 1:
                    a = g.write_pos[0]
                    off = 0
                    for slots_, size in g.segments:
                        r = slots_[a]
                        pl = placements[r]
                        if pl.distributed:
                            ix = g.idxs[a][off : off + size]
                            mine = pl.owned(ix, coord)
                            keep[off : off + size] = mine
                            axes = tuple(ax for ax, s in zip(pl.spec, pl.sizes) if s > 1)
                            shared.setdefault((dtypes[r], axes), []).append((r, ix, ~mine))
                        off += size
                segments, off = [], 0
                for slots_, size in g.segments:
                    n = int(keep[off : off + size].sum())
                    if n:
                        segments.append((slots_, n))
                    off += size
                if segments:
                    own.append(GroupPlan(g.op, g.write_pos, tuple(segments),
                                         tuple(ix[keep] for ix in g.idxs), g.height))
                    self.n_owned += int(keep.sum())
            fn = idxs = None
            if own:
                flat = np.concatenate([ix for g in own for ix in g.idxs], axis=0)
                idxs = host_to_device(torch.from_numpy(flat), device)
                sub = SchedulePlan(plan.roots_order, plan.datas, plan.blocks, [own], [], (), idxs, 0)
                fn = build_program(sub, backend)
            exchanges = []
            for (_, axes), entries in shared.items():
                ex = _Exchange(
                    [(r, host_to_device(torch.from_numpy(ix[:, 0].astype(np.int64)), device),
                      host_to_device(torch.from_numpy(ix[:, 1].astype(np.int64)), device),
                      host_to_device(torch.from_numpy(other), device))
                     for r, ix, other in entries],
                    [mesh.get_group(ax) for ax in axes],
                    plan.blocks,
                )
                exchanges.append(ex)
                self.n_exchanges += len(ex.groups)
                self.exchanged_bytes += len(ex.groups) * ex.numel * dtypes[entries[0][0]].itemsize
            self.steps.append((fn, idxs, exchanges))

    def __call__(self, grids: Sequence[torch.Tensor]) -> None:
        for fn, idxs, exchanges in self.steps:
            if fn is not None:
                fn(grids, idxs)
            for ex in exchanges:
                ex(grids)


class ShardExecutor(WaveExecutor):
    """Counterpart of the JAX package's ``ShardExecutor``: the wave
    executor's plans and launch lists (``backend="torch"`` for g3/g3flat,
    ``"cuda"`` for g4's hand-written tile kernels), run owner-computes over
    ``mesh`` (module docstring)."""

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
        self._coord = dict(zip(names, coord))
        self._placements: Dict[int, Placement] = {}

    def place(self, data: GData) -> None:
        """Distribute a root over the mesh (owner-computes layout).  Its
        bytes stay whole on every rank; the placement decides who computes."""
        if data.device.type != self.mesh.device_type:
            raise ValueError(f"{data.name} lies on {data.device}, the mesh on {self.mesh.device_type}")
        self._placements[data.id] = row_sharding(self.mesh, data, self.shard_axes)

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
        # place any root not placed yet, before planning
        for wave in waves:
            for t in wave:
                for v in t.args:
                    d = v.data
                    if d.id not in self._placements and d.has_value:
                        self.place(d)

    def execute_schedule(self, waves: List[List[GTask]], dag=None) -> int:
        self._prepare_roots(waves)
        return super().execute_schedule(waves, dag)

    def _run_group(self, tasks: List[GTask]) -> None:
        # the per-group fallback runs on every rank: identical inputs give
        # identical results, and nothing is exchanged
        self._prepare_roots([tasks])
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
            fn = progs[ikey] = OwnedProgram(plan, placements, self.backend, self.mesh, self._coord)
        return fn, built

    def _launch(self, fn, idxs, blocks, slots: Sequence, batch, n_tasks: int, replay: bool,
                built: bool = False) -> None:
        if not isinstance(fn, OwnedProgram):
            super()._launch(fn, idxs, blocks, slots, batch, n_tasks, replay, built)
            self.stats["owned_tasks"] += n_tasks
            return
        faults.fire("executor.launch", batch=batch, n_tasks=n_tasks, replay=replay)
        faults.fire("launch.oom", batch=batch, n_tasks=n_tasks, replay=replay)
        grids = []
        for d, (br, bc) in zip(slots, blocks):
            g = torch.empty((d.shape[0] // br, d.shape[1] // bc, br, bc), dtype=d.dtype, device=d.device)
            d.write_grid(g, br, bc)
            grids.append(g)
        fn(grids)
        self.last_program = None
        self._corrupt_outputs(grids, batch=batch, replay=replay)
        self._note_launch(idxs.device, "replay" if replay else "program")
        for d, blk, g in zip(slots, blocks, grids):
            d.adopt_grid(g, blk)
        self.stats["owned_tasks"] += fn.n_owned
        self.stats["exchanges"] += fn.n_exchanges
        self.stats["exchanged_bytes"] += fn.exchanged_bytes
