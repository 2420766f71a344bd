"""Explicit SPMD over a ``DeviceMesh``: the differentiable collectives the
sharded plans run (the port's counterpart of the reference's GSPMD
partitioning and its ``shard_map`` collectives).

The batch is split over the data axes and replicated over ``model``.
Parameters are stored as blocks (``launch/sharding.py``).  A leaf's blocks
over the data axes (FSDP) are gathered whole where they are used
(``ParamGather``); the gather's gradient is the reduce-scatter of the full
gradient over those axes (ZeRO-3).  The step divides the result by the
number of ranks on the batch axes (``launch/steps.py``).

Over ``model`` (Megatron-style tensor parallelism, ``TP``) a leaf the
resolver splits is used as its block: attention by heads, the MLPs by
``mlp`` columns and rows, the experts by expert (EP) or by ``mlp``, the
embedding and the head by vocab (``models/attention.py``, ``layers.py``,
``moe.py``, ``model.py``), the Mamba2 and RWKV6 mixers by heads and
``mlp`` (``ssm.py``, ``rwkv.py``).  No leaf is gathered over ``model``.
A dim the resolver leaves whole is computed whole on every ``model`` rank.
The operators: ``copy_to`` (identity; the gradient summed over the group:
Megatron's f), ``reduce_from`` (the sum over the group; the gradient as it
is: g) and ``gather_seq`` (all-gather on seq; the gradient
reduce-scattered).

A column-parallel block enters through ``TP.enter`` and a row-parallel
one leaves through ``TP.leave``: without sequence parallelism f and g,
with it (``TP.sp``: ``cfg.seq_parallel`` and S divisible by the group) an
all-gather and a reduce-scatter on seq (``gather_seq``,
``scatter_seq``), whose gradients are a reduce-scatter and an
all-gather.  All of them run in the activations' dtype, as the
reference's GSPMD partitions its einsums.  Under sequence parallelism the
residual stream between blocks is this rank's chunk of the sequence,
(B, S / n, D), and the norms run on the chunk.  A block computed whole
takes the whole sequence and keeps its own chunk (``TP.whole``,
``TP.own``).

The gradient rule (``launch/steps.py``): a leaf whole on ``model`` has the
same gradient on every ``model`` rank without sequence parallelism (a
whole leaf one rank uses for its own part of a split block enters through
``copy_to``, ``TP.whole_leaf``) and a part of it on each rank with it, so
the step sums it over ``model`` then, and only then.  A leaf split on
``model`` is never summed there.

At world size 1 nothing here runs: every gather is the tensor itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple

import torch
import torch.nn as nn


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    import torch.distributed as dist

    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((n * x0.shape[0],) + x0.shape[1:])
    dist.all_gather_into_tensor(out, x0, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    import torch.distributed as dist

    g0 = g.movedim(dim, 0).contiguous()
    out = g0.new_empty((g0.shape[0] // n,) + g0.shape[1:])
    dist.reduce_scatter_tensor(out, g0, group=group)
    return out.movedim(0, dim)


# one split of a leaf over a mesh dim of the batch axes: (tensor dim,
# process group, group size)
Split = Tuple[int, Any, int]


class _Gather(torch.autograd.Function):
    """The whole tensor from the blocks: all-gathers over the mesh dims from
    the last (the innermost split) to the first; the backward undoes them in
    the other order, reduce-scattering (the ranks of a batch axis hold
    different rows, so each holds a part of the gradient)."""

    @staticmethod
    def forward(ctx, x, splits):
        ctx.splits = splits
        for d, group, n in reversed(splits):
            x = _all_gather(x, d, group, n)
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        for d, group, n in ctx.splits:
            g = _reduce_scatter(g, d, group, n)
        return g.contiguous(), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _all_gather(x, 1, group, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, 1, ctx.group, ctx.n).contiguous(), None, None


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _reduce_scatter(x, 1, group, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.group, ctx.n).contiguous(), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; its gradient is summed over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passes as it is."""
    return _ReduceFrom.apply(x, group)


def gather_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(B, S / n, ...) chunks -> (B, S, ...) over ``group``; the gradient is
    reduce-scattered back to the chunks."""
    return _GatherSeq.apply(x, group, n)


def scatter_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(B, S, ...) parts -> this rank's (B, S / n, ...) chunk of their sum
    over ``group``; the gradient is all-gathered back to (B, S, ...)."""
    return _ScatterSeq.apply(x, group, n)


def all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The blocks of ``x`` over ``group`` concatenated on ``dim``, outside
    autograd (serving: decode's query heads, the logits' vocab)."""
    return _all_gather(x, dim, group, n)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` in place (``op``: sum, max or min),
    outside autograd."""
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    dist.all_reduce(x, op=ops[op], group=group)
    return x


@dataclass(frozen=True)
class TP:
    """Tensor parallelism over the ``model`` axis (module docstring): its
    process group, size ``n`` (> 1) and this rank's index; ``seq_parallel``
    (``cfg.seq_parallel``) and ``sp``, whether this call's residual stream
    is split on seq (``for_seq``)."""

    group: Any
    n: int
    rank: int
    seq_parallel: bool = True
    sp: bool = False

    def for_seq(self, S: int) -> "TP":
        """This context for a call of sequence length ``S``: sequence
        parallel when the configuration asks for it and ``n`` divides S
        (the reference's ``constrain_batch``; decode, S = 1, runs without)."""
        return replace(self, sp=self.seq_parallel and S % self.n == 0 and S >= self.n)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Into a column-parallel block: the whole sequence under SP
        (``gather_seq``), else ``x`` whose gradient is summed over the group
        (``copy_to``)."""
        return gather_seq(x, self.group, self.n) if self.sp else copy_to(x, self.group)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """Out of a row-parallel block: the sum of the ranks' parts, this
        rank's chunk of it under SP (``scatter_seq``; else ``reduce_from``)."""
        return scatter_seq(y, self.group, self.n) if self.sp else reduce_from(y, self.group)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """Into a block every rank computes whole: the whole sequence (its
        gradient, a part on each rank, reduce-scattered back)."""
        return gather_seq(x, self.group, self.n) if self.sp else x

    def own(self, y: torch.Tensor) -> torch.Tensor:
        """Out of a block every rank computed whole (or any (B, S, ...)
        tensor): this rank's chunk of the sequence under SP."""
        if not self.sp:
            return y
        c = y.shape[1] // self.n
        return y.narrow(1, self.rank * c, c)

    def whole_leaf(self, w: torch.Tensor) -> torch.Tensor:
        """A leaf whole on ``model`` that this rank uses only for its own
        part of a split block (``wk``/``wv`` sliced to the KV heads its
        query heads read, ``q_norm``; Mamba2's B/C projections, RWKV6's
        token-shift mixes): without SP its gradient is summed
        here, so that every rank holds the same one (the gradient rule)."""
        return w if self.sp else copy_to(w, self.group)

    def shared(self, x: torch.Tensor) -> torch.Tensor:
        """A value every rank computes alike from the whole sequence under
        SP (a MoE layer's aux loss): each rank passes back 1/n of its
        gradient, so the ranks' parts sum to it once."""
        return _Share.apply(x, self.n) if self.sp else x


@dataclass(frozen=True)
class SeqSplit:
    """The KV caches' seq dim split over mesh dims (serving): each dim's
    group, size and this rank's coordinate, major to minor, as
    ``launch/sharding.py`` ``shard`` cuts it."""

    groups: Tuple[Any, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]

    @property
    def n(self) -> int:
        return math.prod(self.sizes)

    @property
    def index(self) -> int:
        """This rank's chunk of the seq dim."""
        i = 0
        for s, c in zip(self.sizes, self.coords):
            i = i * s + c
        return i


def tp_of(ctx) -> "TP | None":
    """The tensor-parallel context of a parallel context (``MoeCtx``), None
    when ``model`` is 1 or absent."""
    return getattr(ctx, "tp", None) if ctx is not None else None


def mean_value(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of ``x`` over ``group`` as the value, this rank's ``x`` for
    the gradient (the step averages the ranks' gradients)."""
    import torch.distributed as dist

    m = x.detach().clone()
    dist.all_reduce(m, group=group)
    return x + (m / n - x.detach())


@dataclass
class ParamGather:
    """Gather at use: each parameter's splits, by its name in the training
    form's flat dict ("stack.groups.0.layers.0.attn.wq")."""

    splits: Dict[str, Tuple[Split, ...]]

    @classmethod
    def build(cls, shardings: Dict[str, Any], reduce_axes: Tuple[str, ...], skip=None) -> "ParamGather":
        """``reduce_axes``: the mesh axes whose ranks hold different rows
        (the batch axes): the gradient is summed over them.  ``skip``:
        {name: mesh dims} a leaf keeps split (its ``model`` block, used as
        it is).  Every other split of a leaf must be over ``reduce_axes``."""
        from ..launch.sharding import dim_splits, mesh_names

        skip = skip or {}
        out = {}
        for name, s in shardings.items():
            mesh = s.mesh
            names, sizes = mesh_names(mesh), tuple(mesh.shape)
            splits = [(d, i) for d, i in dim_splits(mesh, s.spec) if sizes[i] > 1 and i not in skip.get(name, ())]
            for _, i in splits:
                if names[i] not in reduce_axes:
                    raise ValueError(f"{name}: gathered over {names[i]!r}, not one of the batch axes {reduce_axes}")
            out[name] = tuple((d, mesh.get_group(i), sizes[i]) for d, i in splits)
        return cls(out)

    def leaf(self, name: str, x: torch.Tensor) -> torch.Tensor:
        splits = self.splits.get(name)
        return _Gather.apply(x, splits) if splits else x

    def tree(self, module: nn.Module, prefix: str):
        """A ``ParamTree``'s tensors (those a ``functional_call`` put in
        place included) as nested dicts and lists, each leaf gathered."""
        if isinstance(module, nn.ModuleList):
            return [self.tree(m, f"{prefix}.{i}") for i, m in enumerate(module)]
        out: Dict[str, Any] = {k: self.leaf(f"{prefix}.{k}", getattr(module, k)) for k in module._parameters}
        out.update({k: self.tree(m, f"{prefix}.{k}") for k, m in module._modules.items()})
        return out
