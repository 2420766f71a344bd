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
return fresh storage, and ``GView.set`` replaces the root tensor instead of
writing into it.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_uid = itertools.count()


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


def to_grid(a: torch.Tensor, br: int, bc: int) -> torch.Tensor:
    """(R, C) root layout -> fresh (R//br, C//bc, br, bc) grid-major tensor."""
    r, c = a.shape
    g = torch.empty((r // br, c // bc, br, bc), dtype=a.dtype, device=a.device)
    g.copy_(a.reshape(r // br, br, c // bc, bc).permute(0, 2, 1, 3))
    return g


def from_grid(a4: torch.Tensor) -> torch.Tensor:
    """(nr, nc, br, bc) grid-major layout -> fresh (nr*br, nc*bc) tensor."""
    nr, nc, br, bc = a4.shape
    out = torch.empty((nr * br, nc * bc), dtype=a4.dtype, device=a4.device)
    out.view(nr, br, nc, bc).copy_(a4.permute(0, 2, 1, 3))
    return out


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
        self.value = None if value is None else self._ingest(value)
        self.name = name or f"gdata{self.id}"
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
        """Copy ``v`` into storage this handle owns (see module docstring)."""
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if tuple(t.shape) != self.shape:
            raise ValueError(f"value shape {tuple(t.shape)} != {self.shape}")
        return t.to(device=self.device, dtype=self.dtype, copy=True)

    # -- grid-resident epoch (DESIGN.md §2) ---------------------------------
    @property
    def value(self) -> Optional[torch.Tensor]:
        """Root-layout tensor.  Reading from inside a grid epoch de-grids
        lazily and ends the epoch (the next drain re-enters it)."""
        if self._grid is not None:
            self._value = from_grid(self._grid)
            self._grid = None
            self._grid_block = None
        return self._value

    @value.setter
    def value(self, v: Optional[torch.Tensor]) -> None:
        self._grid = None
        self._grid_block = None
        self._value = v

    @property
    def in_grid_epoch(self) -> bool:
        return self._grid is not None

    @property
    def has_value(self) -> bool:
        """True when authoritative bytes exist (root value or grid)."""
        return self._value is not None or self._grid is not None

    @property
    def grid_block(self) -> Optional[Tuple[int, int]]:
        return self._grid_block

    def enter_grid(self, br: int, bc: int) -> torch.Tensor:
        """Enter (or stay in) the grid-resident epoch with block ``(br, bc)``.

        Executors call this once per dispatcher drain; repeated drains with
        the same block shape find the grid already resident and pay zero
        layout traffic.  A different block shape flushes through ``.value``
        first (root layout is the common interchange format).
        """
        if self.shape[0] % br or self.shape[1] % bc:
            raise ValueError(
                f"{self.name}: block ({br},{bc}) does not divide {self.shape}"
            )
        if self._grid is not None and self._grid_block == (br, bc):
            return self._grid
        v = self.value  # flushes any differently-blocked resident grid
        if v is None:
            raise ValueError(f"{self.name}: cannot enter grid epoch, no value")
        self._grid = to_grid(v, br, bc)
        self._grid_block = (br, bc)
        self._value = None  # grid is now the single authority
        return self._grid

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
    def get(self) -> torch.Tensor:
        v = self.data.value
        r = self.region
        return v[r.r0 : r.r0 + r.rows, r.c0 : r.c0 + r.cols]

    def set(self, block: torch.Tensor) -> None:
        # functional update: a caller may hold the previous root tensor
        r = self.region
        v = self.data.value.clone()
        v[r.r0 : r.r0 + r.rows, r.c0 : r.c0 + r.cols] = block.to(self.data.dtype)
        self.data.value = v

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
    return torch.from_numpy(a).to(device=dev, dtype=dtype)


def dd_matrix(n: int, dtype=torch.float32, seed: int = 0, device=None) -> torch.Tensor:
    """Random strictly column-diagonally-dominant matrix (admits LU without
    pivoting); same numpy calls as the JAX package's ``dd_matrix``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    a /= np.abs(a).sum(axis=0, keepdims=True) * 1.5  # col |off-diag| sum < 2/3
    diag = 1.0 + rng.uniform(0.0, 1.0, n).astype(np.float32)
    np.fill_diagonal(a, diag)
    return torch.from_numpy(a).to(device=dev, dtype=dtype)
