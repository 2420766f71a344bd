"""Generic data handles with hierarchical partitioning (paper §2.2).

``GData`` is the UTP analog of the paper's generic data type: a handle that
the application layer manipulates *by reference* while the dispatcher and
executors decide where the bytes live.

A ``GData`` owns a root 2-D tensor and a list of partition levels.  Level
``l`` divides the matrix into a ``p_l x p_l`` grid of equal blocks *inside
each level ``l-1`` block* (the paper's nested ``b1``/``b2`` partitioning).
``GView`` addresses a rectangular region in absolute root coordinates;
``view(r, c)`` returns the child block at the next level, mirroring the
paper's ``A(r, c)`` indexing interface (Fig. 2b).

Storage ownership: the wave executors update resident grids IN PLACE (the
counterpart of buffer donation), so a ``GData`` never aliases a tensor the
caller holds.  It copies on ingest, ``to_grid`` and ``from_grid`` always
return fresh storage, ``GView.set`` replaces the root tensor instead of
writing into it, and re-entering a grid epoch from a stacked-epoch lane
clones the lane (a view would let an in-place drain of this datum write
into storage its bystander lanes share).

Split roots (the distributed graphs, ``core/executors/sharded.py``): a root
the shard stage splits over a ``DeviceMesh`` holds only this rank's part.
Its value is then a ``DTensor`` (``Shard(d)`` on each mesh dim that splits
dim ``d``, ``Replicate()`` elsewhere) whose local tensor is the rank's
rows, and inside a drain a ``SplitStore`` of the rank's blocks.  Nothing
here issues a collective: a ``GView`` reads and writes only blocks of this
rank, and raises ``SplitError`` naming the root for any other.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

_uid = itertools.count()


class SplitError(ValueError):
    """A read or write of a split root's block that lies on another rank, or
    a whole-root access to a split root: it needs a collective that every
    rank issues (``ShardExecutor.gather``), which no single rank can."""


def resolve_device(device=None) -> torch.device:
    """The device a public entry point puts its data on: CUDA unless the
    caller names another.  Never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def host_to_device(t: torch.Tensor, device: torch.device, dtype=None) -> torch.Tensor:
    """A fresh copy of ``t`` on ``device`` (converted to ``dtype``).

    A copy from pageable host memory to the card synchronizes the stream,
    which would fence the serving loop on every request ingest and every
    first drain's index upload; the host tensor is staged through pinned
    memory and copied without blocking instead (PyTorch's pinned-memory
    allocator keeps the staging buffer until the copy has finished)."""
    dtype = t.dtype if dtype is None else dtype
    if device.type == "cuda" and t.device.type == "cpu":
        # convert on the host first: a copy that converts as it crosses to
        # the card goes through a pageable temporary
        return t.to(dtype).pin_memory().to(device=device, non_blocking=True)
    return t.to(device=device, dtype=dtype, copy=True)


def to_grid(a: torch.Tensor, br: int, bc: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, C) root layout -> (R//br, C//bc, br, bc) grid-major tensor: fresh,
    or written into ``out``."""
    r, c = a.shape
    g = torch.empty((r // br, c // bc, br, bc), dtype=a.dtype, device=a.device) if out is None else out
    g.copy_(a.reshape(r // br, br, c // bc, bc).permute(0, 2, 1, 3))
    return g


def from_grid(a4: torch.Tensor) -> torch.Tensor:
    """(nr, nc, br, bc) grid-major layout -> fresh (nr*br, nc*bc) tensor."""
    nr, nc, br, bc = a4.shape
    out = torch.empty((nr * br, nc * bc), dtype=a4.dtype, device=a4.device)
    out.view(nr, br, nc, bc).copy_(a4.permute(0, 2, 1, 3))
    return out


@dataclass(frozen=True)
class Split:
    """Where this rank's part of a split root lies: the DTensor layout
    (``mesh``, ``placements``, the global ``shape``) and the part's element
    ``offset`` and ``local_shape``.  Parts are the even contiguous chunks a
    ``Shard`` placement gives (``torch.chunk`` of a dimension the mesh dim
    divides)."""

    mesh: Any
    placements: tuple
    shape: Tuple[int, int]
    offset: Tuple[int, int]
    local_shape: Tuple[int, int]

    @staticmethod
    def _part(sizes, placements, shape, coord) -> Tuple[tuple, tuple]:
        """(offset, shape) of the part at mesh coordinate ``coord``."""
        chunk, off = list(shape), [0] * len(shape)
        for i, p in enumerate(placements):
            if p.is_shard():
                if chunk[p.dim] % sizes[i]:
                    raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split evenly over mesh dim {i}")
                chunk[p.dim] //= sizes[i]
                off[p.dim] += int(coord[i]) * chunk[p.dim]
        return tuple(off), tuple(chunk)

    @classmethod
    def of(cls, mesh, placements, shape) -> "Split":
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        off, chunk = cls._part(tuple(mesh.mesh.shape), placements, shape, coord)
        return cls(mesh, tuple(placements), tuple(shape), off, chunk)

    def offset_at(self, sizes, coord) -> Tuple[int, int]:
        """The element offset of the part at mesh coordinate ``coord`` (mesh
        dims of ``sizes``)."""
        return self._part(sizes, self.placements, self.shape, coord)[0]

    @classmethod
    def of_dtensor(cls, v: DTensor) -> "Split":
        return cls.of(v.device_mesh, v.placements, tuple(v.shape))

    def wrap(self, local: torch.Tensor, shape=None) -> DTensor:
        """``local`` as this layout's DTensor (no collective); ``shape`` gives
        another global shape of the same split (a column of a matrix)."""
        shape = torch.Size(self.shape if shape is None else shape)
        stride, acc = [], 1
        for e in reversed(shape):
            stride.append(acc)
            acc *= e
        return DTensor.from_local(local, self.mesh, self.placements, run_check=False, shape=shape,
                                  stride=tuple(reversed(stride)))


def local_part(v: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(the rank's part, its element offset): a DTensor's local tensor, or a
    plain tensor whole at (0, 0)."""
    if isinstance(v, DTensor):
        return v.to_local(), Split.of_dtensor(v).offset
    return v, (0, 0)


def like(v: torch.Tensor, local: torch.Tensor, shape=None) -> torch.Tensor:
    """``local``, computed from ``local_part(v)``, in ``v``'s form: a DTensor
    of ``v``'s split (of global ``shape`` if given), or plain."""
    return Split.of_dtensor(v).wrap(local, shape) if isinstance(v, DTensor) else local


class SplitStore:
    """A split root's resident blocks on this rank, as the shard stage's
    launch lists address them: ``store`` is ``(1, K, br, bc)``; its first
    ``nr * nc`` blocks are the rank's own ``(nr, nc)`` block grid in
    row-major order (``owned()``, de-gridding to the DTensor's local part),
    the rest slots for blocks of other ranks that a list reads, filled by
    its exchanges before they are read.  ``high`` is the most blocks the
    root's stores have held over its lists (``resident_bytes``)."""

    __slots__ = ("split", "block", "grid", "store", "high")

    def __init__(self, split: Split, local: torch.Tensor, block: Tuple[int, int], k: int = 0):
        br, bc = block
        r, c = local.shape
        if r % br or c % bc:
            raise ValueError(f"block {tuple(block)} does not divide the rank's part {tuple(local.shape)}")
        self.split = split
        self.block = tuple(block)
        self.grid = (r // br, c // bc)
        self.store = torch.empty((1, max(k, self.n_owned), br, bc), dtype=local.dtype, device=local.device)
        self.high = self.store.shape[1]
        to_grid(local, br, bc, out=self.owned())

    @classmethod
    def over(cls, split: Split, block: Tuple[int, int], store: torch.Tensor, high: int) -> "SplitStore":
        """A store around ``store`` as it is (a captured list's static
        store, its owned blocks first), without a copy."""
        self = cls.__new__(cls)
        self.split, self.block, self.store, self.high = split, tuple(block), store, high
        (r, c), (br, bc) = split.local_shape, block
        self.grid = (r // br, c // bc)
        return self

    def copy(self) -> "SplitStore":
        """A store of its own holding this one's owned blocks."""
        return SplitStore.over(self.split, self.block, self.store[:, : self.n_owned].clone(), self.high)

    @property
    def n_owned(self) -> int:
        return self.grid[0] * self.grid[1]

    def owned(self) -> torch.Tensor:
        """The rank's own blocks, an ``(nr, nc, br, bc)`` view of the store."""
        return self.store[0, : self.n_owned].view(*self.grid, *self.block)

    def reserve(self, k: int) -> torch.Tensor:
        """The store with room for ``k`` blocks: grown (its own blocks copied,
        the received slots not: a list fills them before it reads them)."""
        if self.store.shape[1] < k:
            old = self.owned()
            self.store = torch.empty((1, k, *self.block), dtype=old.dtype, device=old.device)
            self.owned().copy_(old)
            self.high = max(self.high, k)
        return self.store

    def value(self) -> DTensor:
        return self.split.wrap(from_grid(self.owned()))


class StackedEpoch:
    """Shared result holder for one stacked (batched) drain — DESIGN.md §7.

    When the dispatcher stacks N structurally identical roots into one
    batched launch list, the list's result per root slot is a single
    ``(B, nr, nc, br, bc)`` stacked grid.  Splitting it eagerly back into N
    per-root grids would reintroduce the per-root data movement the stacking
    removed, so instead every member ``GData`` adopts a *lane* of this shared
    epoch: reading a member's ``.value`` (or re-entering its grid epoch)
    extracts its lane lazily, as a copy.  The epoch dies when the last
    member resolves or re-adopts elsewhere.
    """

    __slots__ = ("grid", "block", "holders", "__weakref__")

    def __init__(self, grid: torch.Tensor, block: Tuple[int, int]):
        self.grid = grid  # (B, nr, nc, br, bc), on the drain's device
        self.block = tuple(block)
        # live lane holders: an executor may run the next stacked list IN
        # PLACE on this grid only when every holder is re-adopted in that
        # same drain (otherwise it would overwrite a bystander's lane) —
        # see CapturedProgram.load_stacked
        self.holders = 0

    @property
    def batch(self) -> int:
        return self.grid.shape[0]


@dataclass(frozen=True)
class Region:
    """A rectangular region of a root array, in absolute element coords."""

    r0: int
    c0: int
    rows: int
    cols: int

    def overlaps(self, other: "Region") -> bool:
        return not (
            self.r0 + self.rows <= other.r0
            or other.r0 + other.rows <= self.r0
            or self.c0 + self.cols <= other.c0
            or other.c0 + other.cols <= self.c0
        )

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)


class GData:
    """Root data handle.  ``partitions[l]`` = (rows, cols) grid at level l.

    The concrete tensor lives in ``.value`` and is only touched by
    executors; the application program works with handles and block
    indices, as in the paper's Fig. 2(a) (``GData A(N, N, b1, b2)``).
    ``value`` (a numpy array or a tensor) is copied onto ``device``, which
    is CUDA unless the caller names another.
    """

    def __init__(
        self,
        shape: Tuple[int, int],
        partitions: Tuple[Tuple[int, int], ...] = (),
        dtype: Any = torch.float32,
        value: Any = None,
        name: str = "",
        device=None,
    ):
        self.id = next(_uid)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.partitions: List[Tuple[int, int]] = [tuple(p) for p in partitions]
        # Grid-resident epoch state (DESIGN.md §2): while ``_grid`` is set the
        # authoritative bytes live in (nr, nc, br, bc) grid-major layout and
        # ``_value`` is stale; reading ``.value`` de-grids lazily.
        self._grid: Optional[torch.Tensor] = None
        self._grid_block: Optional[Tuple[int, int]] = None
        # Stacked-epoch lane (DESIGN.md §7): while set, the authoritative
        # bytes are one lane of a shared StackedEpoch grid; resolved lazily.
        self._lane: Optional[Tuple[StackedEpoch, int]] = None
        # Split-root store (module docstring): while set, the authority is
        # this rank's blocks in it; reading ``.value`` gives the DTensor.
        self._split: Optional[SplitStore] = None
        self.name = name or f"gdata{self.id}"
        self.value = None if value is None else self._ingest(value)
        for lvl, (pr, pc) in enumerate(self.partitions):
            rows, cols = self._level_block_shape(lvl)
            if rows * pr != self._level_block_shape(lvl - 1)[0] or (
                cols * pc != self._level_block_shape(lvl - 1)[1]
            ):
                raise ValueError(
                    f"partition level {lvl} ({pr}x{pc}) does not evenly divide "
                    f"{self.name} of shape {self.shape}"
                )

    def _ingest(self, v: Any) -> torch.Tensor:
        """Copy ``v`` into storage this handle owns (see module docstring).
        A ``DTensor`` keeps its split: its local part is copied."""
        if isinstance(v, DTensor):
            if tuple(v.shape) != self.shape:
                raise ValueError(f"value shape {tuple(v.shape)} != {self.shape}")
            local = host_to_device(v.to_local(), self.device, self.dtype)
            return Split.of_dtensor(v).wrap(local) if v.device_mesh.size() > 1 else local
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if tuple(t.shape) != self.shape:
            raise ValueError(f"value shape {tuple(t.shape)} != {self.shape}")
        return host_to_device(t, self.device, self.dtype)

    # -- grid-resident epoch (DESIGN.md §2) ---------------------------------
    @property
    def value(self) -> Optional[torch.Tensor]:
        """Root-layout tensor.  Reading from inside a grid epoch de-grids
        lazily and ends the epoch (the next drain re-enters it); reading
        from a stacked-epoch lane extracts + de-grids that lane.  A split
        root's value is a ``DTensor`` of this rank's part (de-gridded from
        its store, which this read ends)."""
        if self._split is not None:
            self._value = self._split.value()
            self._split = None
        if self._lane is not None:
            ep, i = self._lane
            self._drop_lane()
            self._value = from_grid(ep.grid[i])
            return self._value
        if self._grid is not None:
            self._value = from_grid(self._grid)
            self._grid = None
            self._grid_block = None
        return self._value

    @value.setter
    def value(self, v: Optional[torch.Tensor]) -> None:
        self._grid = None
        self._grid_block = None
        self._split = None
        self._drop_lane()
        self._value = v

    def _whole(self) -> Optional[torch.Tensor]:
        """The root-layout value of a root that is not split; a split one
        raises ``SplitError`` (it needs a collective to be whole)."""
        v = self.value
        if isinstance(v, DTensor):
            raise SplitError(f"{self.name} is split over the mesh: gather it (a collective every rank issues) "
                             "to use it whole")
        return v

    def _drop_lane(self) -> None:
        if self._lane is not None:
            self._lane[0].holders -= 1
            self._lane = None

    @property
    def in_grid_epoch(self) -> bool:
        return self._grid is not None

    @property
    def has_value(self) -> bool:
        """True when authoritative bytes exist in ANY epoch (root-layout
        value, resident grid, or stacked-epoch lane)."""
        return (
            self._value is not None
            or self._grid is not None
            or self._lane is not None
            or self._split is not None
        )

    @property
    def split(self) -> Optional[SplitStore]:
        """This rank's store of a split root, or None."""
        return self._split

    @property
    def is_split(self) -> bool:
        """True when this rank holds only its part (a store or a DTensor)."""
        return self._split is not None or isinstance(self._value, DTensor)

    def adopt_split(self, store: SplitStore) -> None:
        """Make ``store`` (already holding this rank's blocks) the authority."""
        self._grid = None
        self._grid_block = None
        self._drop_lane()
        self._value = None
        self._split = store

    @property
    def lane(self) -> Optional[Tuple[StackedEpoch, int]]:
        """(epoch, lane index) while lane-resident, else None."""
        return self._lane

    def adopt_lane(self, epoch: StackedEpoch, lane: int) -> None:
        """Adopt lane ``lane`` of a stacked drain's result grid (DESIGN.md
        §7).  The shared epoch becomes the single authority for this datum;
        nothing is sliced or de-gridded until someone reads ``.value`` or
        re-enters a per-datum grid epoch."""
        nr, nc, br, bc = epoch.grid.shape[1:]
        want = (nr * br, nc * bc)
        if want != tuple(self.shape):
            raise ValueError(
                f"{self.name}: stacked lane shape {want} != {self.shape}"
            )
        self._grid = None
        self._grid_block = None
        self._value = None
        self._split = None
        self._drop_lane()
        self._lane = (epoch, lane)
        epoch.holders += 1

    @property
    def grid_block(self) -> Optional[Tuple[int, int]]:
        return self._grid_block

    def enter_grid(self, br: int, bc: int) -> torch.Tensor:
        """Enter (or stay in) the grid-resident epoch with block ``(br, bc)``.

        Repeated calls with the same block shape find the grid already
        resident and pay zero layout traffic.  A different block shape
        flushes through ``.value`` first (root layout is the common
        interchange format).  The wave executors instead copy a datum into
        their captured programs' static grids (``write_grid``) and hand the
        result back (``adopt_grid``).
        """
        if self.shape[0] % br or self.shape[1] % bc:
            raise ValueError(
                f"{self.name}: block ({br},{bc}) does not divide {self.shape}"
            )
        if self._grid is not None and self._grid_block == (br, bc):
            return self._grid
        if self._lane is not None and self._lane[0].block == (br, bc):
            # lane-resident with the right block shape: copy the lane out of
            # the stacked epoch directly, no root-layout round trip.  A copy,
            # not a view: the next drain updates this grid in place
            ep, i = self._lane
            self._drop_lane()
            self._grid = ep.grid[i].clone()
            self._grid_block = (br, bc)
            return self._grid
        v = self._whole()  # flushes any differently-blocked resident grid/lane
        if v is None:
            raise ValueError(f"{self.name}: cannot enter grid epoch, no value")
        self._grid = to_grid(v, br, bc)
        self._grid_block = (br, bc)
        self._value = None  # grid is now the single authority
        return self._grid

    def write_grid(self, dst: torch.Tensor, br: int, bc: int) -> None:
        """Copy this datum's bytes into ``dst``, an ``(nr, nc, br, bc)``
        grid: a lane or resident grid of that block is copied as it is,
        anything else through root layout (``to_grid``'s permute, straight
        into ``dst``).  The datum keeps its own storage."""
        if self._lane is not None and self._lane[0].block == (br, bc):
            ep, i = self._lane
            dst.copy_(ep.grid[i])
        elif self._grid is not None and self._grid_block == (br, bc):
            dst.copy_(self._grid)
        else:
            v = self._whole()  # flushes any differently-blocked resident grid/lane
            if v is None:
                raise ValueError(f"{self.name}: cannot enter grid epoch, no value")
            to_grid(v, br, bc, out=dst)

    def adopt_grid(self, g4: torch.Tensor, block: Tuple[int, int]) -> None:
        """Make ``g4`` (already holding this datum's bytes) the resident grid
        of block ``block``: a captured launch list's static grid, handed to
        the datum its drain wrote (``src/repro_torch/DESIGN.md``)."""
        self._drop_lane()
        self._value = None
        self._split = None
        self._grid = g4
        self._grid_block = tuple(block)

    @property
    def grid(self) -> Optional[torch.Tensor]:
        """The resident (nr, nc, br, bc) tensor, or None outside an epoch."""
        return self._grid

    def set_grid(self, g4: torch.Tensor) -> None:
        """Replace the resident grid (executor scatter-back inside an epoch)."""
        if self._grid_block is None:
            raise ValueError(f"{self.name}: set_grid outside a grid epoch")
        br, bc = self._grid_block
        want = (self.shape[0] // br, self.shape[1] // bc, br, bc)
        if tuple(g4.shape) != want:
            raise ValueError(
                f"{self.name}: set_grid shape {tuple(g4.shape)} != resident {want}"
            )
        self._grid = g4

    # -- partition geometry -------------------------------------------------
    def _level_block_shape(self, level: int) -> Tuple[int, int]:
        """Block shape at ``level`` (level -1 or 0-indexed root = whole)."""
        rows, cols = self.shape
        for pr, pc in self.partitions[: level + 1]:
            rows //= pr
            cols //= pc
        return rows, cols

    def partition(self, pr: int, pc: int) -> "GData":
        """Append one more partitioning level (chainable)."""
        self.partitions.append((pr, pc))
        self._level_block_shape(len(self.partitions) - 1)  # validate
        return self

    @property
    def n_levels(self) -> int:
        return len(self.partitions)

    def root_view(self) -> "GView":
        return GView(self, Region(0, 0, *self.shape), level=-1)

    # convenience: A(r, c) on the root == level-0 block indexing
    def __call__(self, r: int, c: int) -> "GView":
        return self.root_view()(r, c)

    def row_part_num(self, level: int = 0) -> int:
        return self.partitions[level][0]

    def col_part_num(self, level: int = 0) -> int:
        return self.partitions[level][1]

    def materialize(self, fill: Any = None) -> None:
        if fill is not None:
            self.value = self._ingest(fill)
        elif self.value is None:
            self.value = torch.zeros(self.shape, dtype=self.dtype, device=self.device)

    def __repr__(self) -> str:  # pragma: no cover
        return f"GData({self.name}, {self.shape}, parts={self.partitions})"


@dataclass(frozen=True)
class GView:
    """A block view into a ``GData`` (the paper's ``A(r, c)``)."""

    data: GData
    region: Region
    level: int  # partition level this view sits at (-1 = root)

    def __call__(self, r: int, c: int) -> "GView":
        lvl = self.level + 1
        if lvl >= self.data.n_levels:
            raise IndexError(
                f"{self.data.name}: no partition level {lvl} "
                f"(has {self.data.n_levels})"
            )
        pr, pc = self.data.partitions[lvl]
        if not (0 <= r < pr and 0 <= c < pc):
            raise IndexError(f"block ({r},{c}) outside {pr}x{pc} grid")
        br = self.region.rows // pr
        bc = self.region.cols // pc
        return GView(
            self.data,
            Region(self.region.r0 + r * br, self.region.c0 + c * bc, br, bc),
            level=lvl,
        )

    def row_part_num(self) -> int:
        lvl = self.level + 1
        return self.data.partitions[lvl][0]

    def col_part_num(self) -> int:
        lvl = self.level + 1
        return self.data.partitions[lvl][1]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.region.shape

    # -- executor-side array access (host path) -----------------------------
    def _local(self, v: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """(the rank's part of ``v``, this region's origin in it); a region
        that is not wholly this rank's raises ``SplitError``."""
        local, (o0, o1) = local_part(v)
        r = self.region
        r0, c0 = r.r0 - o0, r.c0 - o1
        if not (0 <= r0 and r0 + r.rows <= local.shape[0] and 0 <= c0 and c0 + r.cols <= local.shape[1]):
            raise SplitError(f"{self.data.name}{list(r.shape)} at ({r.r0}, {r.c0}) lies on another rank of the "
                             "mesh; this rank holds only its own blocks")
        return local, r0, c0

    def get(self) -> torch.Tensor:
        local, r0, c0 = self._local(self.data.value)
        r = self.region
        return local[r0 : r0 + r.rows, c0 : c0 + r.cols]

    def set(self, block: torch.Tensor) -> None:
        # functional update: a caller may hold the previous root tensor
        v = self.data.value
        local, r0, c0 = self._local(v)
        r = self.region
        local = local.clone()
        local[r0 : r0 + r.rows, c0 : c0 + r.cols] = block.to(self.data.dtype)
        self.data.value = like(v, local)

    def block_index(self) -> Tuple[int, int]:
        """(row, col) index of this block within the uniform grid of its level."""
        br, bc = self.region.rows, self.region.cols
        return self.region.r0 // br, self.region.c0 // bc

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.data.name}[{self.region.r0}:{self.region.r0+self.region.rows},{self.region.c0}:{self.region.c0+self.region.cols}]"


def spd_matrix(n: int, dtype=torch.float32, seed: int = 0, device=None) -> torch.Tensor:
    """Random symmetric positive definite matrix (test/benchmark input).

    The numpy calls are those of the JAX package's ``spd_matrix``, so both
    packages see bit-identical inputs for the same ``n`` and ``seed``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    a = a @ a.T + np.eye(n, dtype=np.float32) * 2.0
    return host_to_device(torch.from_numpy(a), dev, dtype)


def dd_matrix(n: int, dtype=torch.float32, seed: int = 0, device=None) -> torch.Tensor:
    """Random strictly column-diagonally-dominant matrix (admits LU without
    pivoting); same numpy calls as the JAX package's ``dd_matrix``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    a /= np.abs(a).sum(axis=0, keepdims=True) * 1.5  # col |off-diag| sum < 2/3
    diag = 1.0 + rng.uniform(0.0, 1.0, n).astype(np.float32)
    np.fill_diagonal(a, diag)
    return host_to_device(torch.from_numpy(a), dev, dtype)
