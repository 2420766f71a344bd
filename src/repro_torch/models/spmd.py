"""Explicit SPMD over a ``DeviceMesh``: the differentiable collectives the
sharded plans run (the port's counterpart of the reference's GSPMD
partitioning and its ``shard_map`` collectives).

Every rank runs the whole model on its own rows of the batch (the batch is
split over the data axes and replicated over ``model``).  Parameters are
stored as blocks (``launch/sharding.py``) and gathered whole where they are
used (``ParamGather``); the gather's gradient is the reduce-scatter of the
full gradient over the mesh dims that carry different rows (the data axes:
ZeRO-3) and this rank's slice over the others, whose ranks compute the same
gradient.  The step divides the result by the number of ranks on the batch
axes (``launch/steps.py``).

Expert parallelism (``models/moe.py``) splits work over ``model``:
``copy_to`` (identity forward, sum of the gradients over the group
backward) marks where a replicated tensor enters the split part, and
``reduce_from`` (sum forward, identity backward) where the parts combine,
as Megatron's f and g operators do.  ``torch.distributed.nn``'s all-reduce
would sum the gradient again and multiply it by the group's size.

At world size 1 nothing here runs: every gather is the tensor itself.
"""

from __future__ import annotations

from dataclasses import dataclass
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


# one split of a leaf: (tensor dim, process group, group size, this rank's
# index in the group, whether ranks of the group hold different rows)
Split = Tuple[int, Any, int, int, bool]


class _Gather(torch.autograd.Function):
    """The whole tensor from the blocks: all-gathers over the mesh dims from
    the last (the innermost split) to the first; the backward undoes them in
    the other order, reduce-scattering over dims whose ranks hold different
    rows and slicing this rank's block over the others."""

    @staticmethod
    def forward(ctx, x, splits):
        ctx.splits = splits
        for d, group, n, _, _ in reversed(splits):
            x = _all_gather(x, d, group, n)
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        for d, group, n, coord, rows in ctx.splits:
            if rows:
                g = _reduce_scatter(g, d, group, n)
            else:
                c = g.shape[d] // n
                g = g.narrow(d, coord * c, c)
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


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; its gradient is summed over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passes as it is."""
    return _ReduceFrom.apply(x, group)


def mean_value(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of a scalar over ``group`` as the value, this rank's ``x``
    for the gradient (the step averages the ranks' gradients)."""
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
        {name: mesh dims} a leaf keeps split (the expert dim under EP)."""
        from ..launch.sharding import dim_splits, mesh_names

        skip = skip or {}
        out = {}
        for name, s in shardings.items():
            mesh = s.mesh
            names, sizes, coord = mesh_names(mesh), tuple(mesh.shape), mesh.get_coordinate()
            out[name] = tuple((d, mesh.get_group(i), sizes[i], coord[i], names[i] in reduce_axes)
                              for d, i in dim_splits(mesh, s.spec)
                              if sizes[i] > 1 and i not in skip.get(name, ()))
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
