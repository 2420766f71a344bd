"""Operation objects (paper §2.3): ``split`` into child tasks or ``run`` a leaf.

An ``Operation`` is stateless and shared by all tasks of its kind (the
paper's ``upotrfo``/``ugemmo``/... singletons).  Executors obtain the pure
leaf computation through ``leaf_fn(backend)`` so the *same* operation can be
executed by torch library calls (the cpuBLAS wrapper analog) or by a
hand-written CUDA tile kernel (the cuBLAS wrapper analog) — the
unified-interface point of the paper.

Leaf function convention (vmap-able):
    ``fn(*arrays) -> tuple(updated arrays, one per WRITE/READWRITE arg)``
where ``arrays`` are the task's argument blocks in order.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from .task import Access, GTask


class Operation:
    """One registered operation kind — the unit the whole system speaks.

    Hook contract (everything the dispatcher/executors ever call):

    ``name``                 process-unique registry key; also the wave-
                             batching signature component.
    ``default_modes(n)``     per-argument access intents (READ/WRITE/
                             READWRITE) used by data versioning.
    ``can_split``/``split``  hierarchical expansion into child tasks on the
                             next partition level (pure in geometry when
                             ``memoizable``); a *composed* operation may
                             expand a whole pipeline of family members
                             into one scope (DESIGN.md §4).
    ``leaf_fn(backend)``     pure block computation, one updated array per
                             write-mode argument (tuple if several).
    ``batched_leaf_fn``      stacked-blocks form; defaults to
                             ``torch.func.vmap`` of ``leaf_fn`` so new ops
                             ride the wave executors with no extra code.
    ``grid_fused_fn``        optional fused gather/compute/scatter kernel
                             over resident grids (cuda backend).

    Executors never special-case an op name — implementing these hooks is
    the entire integration surface (DESIGN.md §6).
    """

    name: str = "op"

    # Drain-memo contract (DESIGN.md §2): True asserts that ``split`` is a
    # pure function of the task's operation + argument *geometry* (regions,
    # levels, partitions) — never of data values or external state — so a
    # structurally repeated drain may replay the captured schedule.  Ops
    # with value-dependent expansion (e.g. adaptive factorizations) must
    # set this False to keep every drain through them unmemoized.
    memoizable: bool = True

    def default_modes(self, n_args: int) -> Sequence[Access]:
        """Override for op-specific access intents."""
        return [Access.READWRITE] * n_args

    # -- hierarchy ------------------------------------------------------------
    def can_split(self, task: GTask) -> bool:
        """True if the task's args have another partition level to split into."""
        return all(v.level + 1 < v.data.n_levels for v in task.args)

    def split(self, task: GTask, submit: Callable[[GTask], None]) -> None:
        """Create child tasks on partitions of ``task``'s args (paper Fig 2b).

        Must be a pure function of the args' geometry when ``memoizable``
        is left True — see the class attribute above."""
        raise NotImplementedError(f"{self.name} cannot split")

    # -- leaf execution ---------------------------------------------------------
    def leaf_fn(self, backend: str) -> Callable:
        """Pure function implementing this op on raw blocks for ``backend``.

        ``backend`` is one of {'torch', 'cuda'}.
        """
        raise NotImplementedError(self.name)

    def batched_leaf_fn(self, backend: str) -> Callable:
        """Batched leaf over stacked blocks ``(n, *block_shape)`` per arg.

        Default: ``torch.func.vmap`` of ``leaf_fn`` — every Operation rides
        the wave executors with no extra code.  Override to launch a natively
        batched kernel instead (one CUDA grid over the whole stack).
        """
        return torch.func.vmap(self.leaf_fn(backend))

    def grid_fused_fn(self, backend: str):
        """Optional fused gather/compute/scatter kernel over resident grids.

        Returns ``(call, write_arg)`` where ``call(idxs, grids)`` consumes
        ``(n, 2)`` int32 block-index tensors plus one grid per argument,
        updates the grid of ``write_arg`` in place and returns it — or
        ``None`` when the backend has no fused path (the launch list then
        gathers, runs the batched leaf and scatters back; DESIGN.md §2).
        """
        return None

    def __repr__(self) -> str:  # pragma: no cover
        return f"Operation({self.name})"


class OpRegistry:
    """Name -> Operation singleton registry (used by config/serialization)."""

    _ops = {}

    @classmethod
    def register(cls, op: Operation) -> Operation:
        """Register a singleton; names are unique across the process.

        A silent overwrite would split the algebra in two — tasks created
        with the old singleton and configs resolving the new one would no
        longer group/batch together — so a colliding name is an error.
        """
        prev = cls._ops.get(op.name)
        if prev is not None and prev is not op:
            raise ValueError(
                f"operation name {op.name!r} already registered by {prev!r}"
            )
        cls._ops[op.name] = op
        return op

    @classmethod
    def get(cls, name: str) -> Operation:
        return cls._ops[name]

    @classmethod
    def names(cls) -> List[str]:
        return sorted(cls._ops)
