"""Logical-axis -> mesh-axis sharding resolver (the JAX package's
``launch/sharding.py``), and the placement of tensors on a ``DeviceMesh``.

Every parameter/cache leaf carries *logical* axis names (``PSpec.logical``,
``cache_logical``).  A ``Rules`` table maps each logical name to an ordered
tuple of candidate mesh axes; the resolver walks a leaf's dims in order and
assigns each candidate axis iff (a) it exists in the mesh, (b) it is not
already used by an earlier dim of the same leaf, and (c) the dim is
divisible by the axis size.  Anything else falls back to replication:
placement never fails, it only degrades (e.g. kv_heads=8 on a 16-way model
axis stays replicated while q heads shard).

Standard parallelism expressed through the tables:
  TP    heads/mlp/experts/vocab -> "model"
  FSDP  embed (d_model) dim of matrices -> "data" (+"pod" for >=100B)
  DP    batch -> ("pod", "data")
  SP    cache seq -> leftover axes (long-context: ("pod","data","model"))
  EP    experts -> "model" (the MoE EP path reads the same table)

The resolver takes any object with ``axis_names`` and a ``shape`` mapping
(the reference's tests pass a mock), or a ``torch.distributed``
``DeviceMesh`` (``mesh_dim_names``).  Its result is the port's own
``PartitionSpec``, a tuple with one entry a dim: None, an axis name, or a
tuple of axis names (major to minor).

The port's parameter templates hold one group a leaf where the reference
stacks the groups on a leading ``"layers"`` dim (``"layers"`` maps to
``()``): ``group_pspec`` resolves a group leaf as its stacked leaf and drops
that leading None, so the two packages give every leaf the same spec (a
group's 1-D norm scale is 2-D once stacked, and so not under ``min_ndim``).

On a ``DeviceMesh`` a spec becomes DTensor placements (``placements``):
``Shard(d)`` on each mesh dim whose axis dim ``d`` takes, ``Replicate()``
elsewhere.  A dim taking several axes splits over them in mesh-dim order,
which is the reference's major-to-minor order when the axes are listed in
the mesh's order (as every rule table lists them).  ``shard`` cuts this
rank's block of a whole tensor and ``place`` wraps a local block as a
``DTensor`` (a plain tensor where no mesh dim is larger than one: the
world-size-1 plans capture CUDA graphs over plain tensors).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig

Axes = Tuple[str, ...]


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), an axis name, or a tuple
    of axis names; ``PartitionSpec()`` is replicated whatever the rank."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class Rules:
    table: Dict[Optional[str], Axes]
    # leaves with fewer dims than this stay replicated (norm vectors etc.)
    min_ndim: int = 2

    def lookup(self, name: Optional[str]) -> Axes:
        return self.table.get(name, ())


def train_rules(cfg: ArchConfig, big_model_fsdp_pod: bool = True) -> Rules:
    fsdp: Axes = ()
    if cfg.fsdp:
        # >=100B params need the pod axis in the FSDP group to fit HBM
        big = param_bytes_estimate(cfg) > 100e9 * 4
        fsdp = ("pod", "data") if (big and big_model_fsdp_pod) else ("data",)
    return Rules(
        table={
            "vocab": ("model",),
            "heads": ("model",),
            "kv_heads": ("model",),
            "mlp": ("model",),
            "experts": ("model",),
            "embed": fsdp,
            "batch": ("pod", "data"),
            "seq": (),
            "head_dim": (),
            "layers": (),
            "state": (),
            None: (),
        }
    )


def serve_rules(cfg: ArchConfig) -> Rules:
    """Decode/prefill: same weight layout; cache seq takes leftover axes."""
    t = dict(train_rules(cfg).table)
    t["batch"] = ("pod", "data")
    t["seq"] = ("pod", "data", "model")  # long-context cache sharding
    return Rules(table=t)


def param_bytes_estimate(cfg: ArchConfig) -> int:
    from ..models.model import param_counts

    return param_counts(cfg)["total"] * torch.empty((), dtype=cfg.param_dtype).element_size()


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------
def mesh_names(mesh) -> Axes:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a mock mesh (``shape`` a mapping) or a
    ``DeviceMesh`` (``shape`` a tuple in mesh-dim order)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh_names(mesh), tuple(shape)))


def _prod(mesh, axes: Axes) -> int:
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


# --------------------------------------------------------------------------
# resolution
# --------------------------------------------------------------------------
def resolve_pspec(logical: Tuple[Optional[str], ...], shape: Tuple[int, ...], mesh, rules: Rules) -> P:
    if len(shape) < rules.min_ndim:
        return P()
    names, sizes = mesh_names(mesh), mesh_sizes(mesh)
    used = set()
    spec = []
    for dim, name in zip(shape, logical):
        chosen = []
        rem = dim
        for ax in rules.lookup(name):
            if ax in names and ax not in used:
                sz = sizes[ax]
                if rem % sz == 0 and rem >= sz:
                    chosen.append(ax)
                    used.add(ax)
                    rem //= sz
        spec.append(tuple(chosen) if len(chosen) > 1 else (chosen[0] if chosen else None))
    return P(*spec)


def group_pspec(logical: Tuple[Optional[str], ...], shape: Tuple[int, ...], mesh, rules: Rules,
                n_groups: int) -> P:
    """The spec of one group's leaf: the reference's spec of the leaf
    stacked on a leading ``"layers"`` dim of ``n_groups``, without that
    dim."""
    spec = resolve_pspec(("layers",) + tuple(logical), (n_groups,) + tuple(shape), mesh, rules)
    return P(*spec[1:])


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_pspecs(logical_tree: Any, shaped_tree: Any, mesh, rules: Rules):
    """Map (logical, shaped) trees -> PartitionSpec tree."""
    if _is_logical(logical_tree):
        return resolve_pspec(tuple(logical_tree), tuple(shaped_tree.shape), mesh, rules)
    if isinstance(logical_tree, dict):
        return {k: tree_pspecs(v, shaped_tree[k], mesh, rules) for k, v in logical_tree.items()}
    return [tree_pspecs(v, s, mesh, rules) for v, s in zip(logical_tree, shaped_tree)]


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: P

    @property
    def placements(self):
        return placements(self.mesh, self.spec)


def _map_specs(fn, tree):
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return [_map_specs(fn, v) for v in tree]


def tree_shardings(logical_tree: Any, shaped_tree: Any, mesh, rules: Rules):
    return _map_specs(lambda s: NamedSharding(mesh, s), tree_pspecs(logical_tree, shaped_tree, mesh, rules))


def _lead(axes: Axes):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_pspec(mesh, rules: Rules, ndim: int) -> P:
    """(B, S, ...) activations: batch dim over the DP axes."""
    axes = tuple(a for a in rules.lookup("batch") if a in mesh_names(mesh))
    return P(_lead(axes), *([None] * (ndim - 1)))


def batch_axes(mesh, rules: Rules, batch_size: int) -> Axes:
    """The batch's axes: the DP axes present, dropped from the right until
    the batch divides (e.g. batch=1 long-context)."""
    axes = tuple(a for a in rules.lookup("batch") if a in mesh_names(mesh))
    while axes and batch_size % _prod(mesh, axes) != 0:
        axes = axes[:-1]
    return axes


def batch_sharding(mesh, rules: Rules, batch_size: int, ndim: int) -> NamedSharding:
    return NamedSharding(mesh, P(_lead(batch_axes(mesh, rules, batch_size)), *([None] * (ndim - 1))))


def data_parallel_degree(mesh, rules: Rules, batch_size: int) -> int:
    return _prod(mesh, batch_axes(mesh, rules, batch_size))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# --------------------------------------------------------------------------
# placement on a DeviceMesh
# --------------------------------------------------------------------------
def spec_axes(entry) -> Axes:
    """The axes one spec entry names, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dim_splits(mesh, spec: P) -> Tuple[Tuple[int, int], ...]:
    """((tensor dim, mesh dim), ...) for every mesh dim the spec shards
    over, in mesh-dim order.  A dim over several axes must name them in the
    mesh's order (the order in which DTensor splits a dim)."""
    names = mesh_names(mesh)
    out = []
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} takes {axes}, not in the mesh's order {names}")
        out += [(d, i) for i in idx]
    return tuple(sorted(out, key=lambda t: t[1]))


def placements(mesh, spec: P):
    """DTensor placements of ``spec``: ``Shard(d)`` on each mesh dim that
    dim ``d`` takes, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh_names(mesh))
    for d, i in dim_splits(mesh, spec):
        out[i] = Shard(d)
    return tuple(out)


def is_split(sharding: NamedSharding) -> bool:
    """True when some dim is split over a mesh dim larger than one."""
    sizes = tuple(sharding.mesh.shape)
    return any(sizes[i] > 1 for _, i in dim_splits(sharding.mesh, sharding.spec))


def shard(full: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of ``full`` (a view; mesh dims in order, each
    splitting what the earlier ones left)."""
    mesh = sharding.mesh
    coord, sizes = mesh.get_coordinate(), tuple(mesh.shape)
    out = full
    for d, i in dim_splits(mesh, sharding.spec):
        n = out.shape[d] // sizes[i]
        out = out.narrow(d, coord[i] * n, n)
    return out


def local(x) -> torch.Tensor:
    """A DTensor's local block (its storage); any other tensor itself."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def place(block: torch.Tensor, sharding: NamedSharding, shape: Tuple[int, ...]):
    """``block`` (this rank's) as a ``DTensor`` of global ``shape`` with the
    sharding's placements; the block itself on a one-device mesh."""
    from torch.distributed.tensor import DTensor

    if sharding.mesh.size() == 1:
        return block
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(block, sharding.mesh, sharding.placements, run_check=False, shape=torch.Size(shape),
                              stride=stride)
