"""Step builders: the train, prefill and decode steps as ``StepPlan``s over a
mesh (the JAX package's ``launch/steps.py``).

A ``StepPlan`` holds the step function, its argument trees as tensors on
the ``meta`` device (global shapes and dtypes, no storage: the counterpart
of the reference's ``ShapeDtypeStruct`` trees) and the matching placement
trees (``in_shardings``/``out_shardings``: ``launch/sharding.py``
``NamedSharding``s, whose ``placements`` are DTensor placements on the
``DeviceMesh``).  ``StepPlan.jitted()`` is the counterpart of ``jax.jit``:
on the card it captures the whole step into one CUDA graph over static
buffers and replays it (``core/executors/captured.py`` ``CapturedCall``).
Over a mesh of more than one card each rank captures its own program, the
NCCL collectives of the step inside, as the reference jits one SPMD
program; every rank first checks that all issue the same collectives.
For the train step these include the backward's (the gathers'
reduce-scatters, the remat recompute's second gathers, the gradient
all-reduces over ``model``), which autograd issues from its device thread
into the same capture.  On the CPU every step runs eagerly.  Donated
arguments (``donate_argnums``) are updated in place and returned;
``resident_argnums`` are arguments the capture adopts as they are and
only reads (the serving weights: the caller passes the same tensors every
call, so nothing is copied).

Over a mesh of more than one device (explicit SPMD, ``models/spmd.py``):
every argument is a ``DTensor`` (or this rank's block of it): parameters,
optimizer state and KV caches split as the resolver places them, the
batch's rows over the data axes, the recurrent states by rows and heads.
Each rank runs the model on its rows, gathering each parameter's data-axis
blocks at use and computing on its ``model`` blocks (``models/spmd.py``); gradients
come back as this rank's blocks, summed over the ranks of the batch axes
(and, under sequence parallelism, over ``model`` for leaves whole there)
and divided by the number of batch ranks; AdamW runs on the blocks with
the global gradient norm; the metrics are the global batch's.  The step
returns the caller's trees, updated in place.  On a one-device mesh, or
with ``mesh=None``, every argument is a plain tensor and nothing is
gathered.

The UTP connection (paper §2.1): a step IS the root task of a task tree —
``TrainStepOp.split() -> [microbatch fwd/bwd]* -> grad-reduce -> optimizer
update`` (``train/step_ops.py``); the plan here is the tree fused into one
program.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import optim
from ..configs.base import ArchConfig, ShapeConfig
from ..core.data import resolve_device
from ..core.executors.captured import CapturedCall
from ..core.executors.sharded import mesh_group
from ..models.layers import PSpec, map_template
from ..models.model import _casts, build_model, model_template
from ..models.moe import MoeCtx
from ..models.spmd import TP, ParamGather, SeqSplit
from ..models.transformer import cache_logical, init_cache, n_groups
from ..tree import tree_map
from . import sharding as sh


@dataclass
class StepPlan:
    name: str
    fn: Callable
    args: Tuple[Any, ...]  # meta-device tensor trees (positional), global shapes
    in_shardings: Optional[Tuple[Any, ...]] = None  # NamedSharding trees (None: mesh is None)
    out_shardings: Any = None
    donate_argnums: Tuple[int, ...] = ()
    static_meta: Optional[Dict[str, Any]] = None
    resident_argnums: Tuple[int, ...] = ()

    @property
    def mesh(self):
        return (self.static_meta or {}).get("mesh")

    def jitted(self):
        """The step captured on its first call on the card and replayed
        after, over a mesh of more than one device each rank's own program
        with its collectives (the backward's too); eager on the CPU."""
        n = range(len(self.args))
        return CapturedCall(self.fn, self.name, donate=[i in self.donate_argnums for i in n],
                            resident=[i in self.resident_argnums for i in n],
                            group=mesh_group(self.mesh) if _split(self.mesh) else None)


# --------------------------------------------------------------------------
# placement helpers
# --------------------------------------------------------------------------
_AXES = ("pod", "data", "model")


def check_mesh(mesh) -> None:
    """None, or a mesh whose axes the rule tables know."""
    if mesh is None:
        return
    names = sh.mesh_names(mesh)
    if not names or any(a not in _AXES for a in names):
        raise ValueError(f"mesh axes {names}: the plans place over {_AXES}")


def _split(mesh) -> bool:
    return mesh is not None and mesh.size() > 1


def flat_template(cfg: ArchConfig) -> Dict[str, PSpec]:
    """The template's leaves by the training form's names."""
    out: Dict[str, PSpec] = {}
    map_template(model_template(cfg), lambda s, path: out.__setitem__(path.lstrip("/").replace("/", "."), s))
    return out


def param_shardings(cfg: ArchConfig, mesh, rules: sh.Rules) -> Dict[str, sh.NamedSharding]:
    """{name: NamedSharding} of every parameter; group leaves resolved as
    the reference's stacked leaves (``sharding.group_pspec``)."""
    G = n_groups(cfg)
    out = {}
    for name, s in flat_template(cfg).items():
        if name.startswith("stack.groups."):
            spec = sh.group_pspec(s.logical, s.shape, mesh, rules, G)
        else:
            spec = sh.resolve_pspec(s.logical, s.shape, mesh, rules)
        out[name] = sh.NamedSharding(mesh, spec)
    return out


def _model_blocks(mesh, p_shard) -> Dict[str, Tuple[int, ...]]:
    """The leaves computed on their ``model`` block (every leaf the resolver
    splits on ``model``): the mesh dims they keep split, by leaf."""
    if "model" not in sh.mesh_names(mesh):
        return {}
    m = sh.mesh_names(mesh).index("model")
    return {name: (m,) for name, s in p_shard.items() if m in {i for _, i in sh.dim_splits(mesh, s.spec)}}


def moe_ctx_for(cfg: ArchConfig, mesh, rules: sh.Rules, p_shard=None, batch: Optional[int] = None) -> Optional[MoeCtx]:
    """The parallel context of a plan over ``mesh``: the reference's axes,
    and over more than one device the rows' axes (``batch``: the global
    batch), gather at use of the parameters ``p_shard`` places and, where
    ``model`` is larger than one, the split of compute over it
    (``spmd.TP``)."""
    if mesh is None:
        return None
    names = sh.mesh_names(mesh)
    ctx = MoeCtx(
        mesh=mesh,
        batch_axes=tuple(a for a in rules.lookup("batch") if a in names),
        model_axis="model" if "model" in names else None,
        rows_axes=sh.batch_axes(mesh, rules, batch) if batch else (),
    )
    if p_shard is not None and _split(mesh):
        tp = None
        if "model" in names and mesh.shape[names.index("model")] > 1:
            m = names.index("model")
            tp = TP(mesh.get_group(m), mesh.shape[m], mesh.get_coordinate()[m], cfg.seq_parallel)
        gather = ParamGather.build(p_shard, reduce_axes=ctx.batch_axes, skip=_model_blocks(mesh, p_shard))
        ctx = dataclasses.replace(ctx, params=gather, tp=tp)
    return ctx


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, batch: int, seq: int, mesh=None, rules: Optional[sh.Rules] = None,
                with_labels: bool = False):
    """The batch's tensors on the meta device: embeds (B, S, D) in the
    compute dtype for stub-frontend archs, else int32 tokens (B, S); int32
    labels (B, S) for training.  With a mesh, also their shardings:
    (specs, shardings)."""
    specs: Dict[str, torch.Tensor] = {}
    if cfg.frontend:
        specs["embeds"] = _meta((batch, seq, cfg.d_model), cfg.compute_dtype)
    else:
        specs["tokens"] = _meta((batch, seq), torch.int32)
    if with_labels:
        specs["labels"] = _meta((batch, seq), torch.int32)
    if mesh is None:
        return specs
    return specs, {k: sh.batch_sharding(mesh, rules, batch, v.dim()) for k, v in specs.items()}


def _local(tree):
    return tree_map(lambda x: sh.local(x) if torch.is_tensor(x) else x, tree)


def _batch_ranks(mesh, axes) -> Tuple[Tuple[int, ...], int]:
    """The mesh dims of ``axes`` larger than one, and the ranks they span."""
    names, sizes = sh.mesh_names(mesh), tuple(mesh.shape)
    dims = tuple(i for i, a in enumerate(names) if a in axes and sizes[i] > 1)
    return dims, math.prod(sizes[i] for i in dims)


def _all_reduce(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    import torch.distributed as dist

    for i in dims:
        dist.all_reduce(x, group=mesh.get_group(i))
    return x


def place_params(params: Dict[str, torch.Tensor], shardings: Dict[str, sh.NamedSharding]):
    """Whole tensors (a flat dict, or any tree) as this rank's blocks,
    placed as ``shardings`` says."""
    return tree_map(lambda v, s: sh.place(sh.shard(v.detach(), s).clone(), s, tuple(v.shape)), params, shardings)


def train_state(plan: StepPlan, blocks: Dict[str, torch.Tensor], opt_cfg: optim.AdamWConfig):
    """(params, AdamW state) of a train plan from this rank's parameter
    blocks: the moments zeros of the blocks' shapes, every leaf placed as
    the plan's ``in_shardings`` say (plain tensors without a mesh of more
    than one device)."""
    blocks = {k: v.detach() for k, v in blocks.items()}
    opt = optim.init(blocks, opt_cfg)
    if not _split(plan.mesh):
        return blocks, opt
    p_shard, o_shard, _ = plan.in_shardings
    p_specs, o_specs, _ = plan.args
    return (tree_map(lambda b, s, p: sh.place(b, p, tuple(s.shape)), blocks, p_specs, p_shard),
            tree_map(lambda b, s, p: sh.place(b, p, tuple(s.shape)), opt, o_specs, o_shard))


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------
def make_train_step(
    cfg: ArchConfig,
    mesh,
    shape: ShapeConfig,
    opt_cfg: Optional[optim.AdamWConfig] = None,
    rules: Optional[sh.Rules] = None,
    device=None,
) -> StepPlan:
    """The train step on ``device`` (CUDA unless the caller names another;
    raises without it): ``value_and_grad`` of the loss over
    ``cfg.microbatches`` microbatches (gradients accumulated in fp32, their
    mean taken, the metrics averaged), then ``optim.update``.  Over a mesh
    of more than one device, each rank's arguments are its blocks (module
    docstring)."""
    check_mesh(mesh)
    dev = resolve_device(device)
    model = build_model(cfg, device="meta", train=True)
    opt_cfg = opt_cfg or optim.AdamWConfig(state_dtype=cfg.optim_state_dtype)
    m = cfg.microbatches
    B = shape.global_batch

    p_specs = model.train_params()
    p_specs = {k: _meta(p.shape, p.dtype) for k, p in p_specs.items()}
    o_specs = {
        "m": {k: _meta(p.shape, opt_cfg.state_dtype) for k, p in p_specs.items()},
        "v": {k: _meta(p.shape, opt_cfg.state_dtype) for k, p in p_specs.items()},
        "count": _meta((), torch.int32),
    }
    in_sh = out_sh = None
    mctx = None
    if mesh is None:
        b_specs = batch_specs(cfg, B, shape.seq_len, with_labels=True)
    else:
        rules = rules or sh.train_rules(cfg)
        p_shard = param_shardings(cfg, mesh, rules)
        o_shard = {"m": p_shard, "v": p_shard, "count": sh.replicated(mesh)}
        b_specs, b_shard = batch_specs(cfg, B, shape.seq_len, mesh, rules, with_labels=True)
        in_sh = (p_shard, o_shard, b_shard)
        out_sh = (p_shard, o_shard, None)
        mctx = moe_ctx_for(cfg, mesh, rules, p_shard, B)
    split = _split(mesh)
    if split:
        red_dims, n_red = _batch_ranks(mesh, mctx.batch_axes)
        names = sh.mesh_names(mesh)
        # per leaf: the mesh dims its gradient is all-reduced over, those it
        # is not split over among the batch axes (the gather's backward
        # summed the others) and, under sequence parallelism, ``model``,
        # where every rank holds a part of a whole leaf's gradient
        # (``models/spmd.py``); and the ranks holding each of its elements
        sizes = tuple(mesh.shape)
        sum_dims = red_dims
        if mctx.tp is not None and mctx.tp.for_seq(shape.seq_len).sp:
            sum_dims = red_dims + (names.index("model"),)
        allred = {k: tuple(i for i in sum_dims if i not in {j for _, j in sh.dim_splits(mesh, s.spec)})
                  for k, s in p_shard.items()}
        copies = {k: mesh.size() // math.prod(sizes[j] for _, j in sh.dim_splits(mesh, s.spec))
                  for k, s in p_shard.items()}
        all_dims = tuple(i for i in range(len(names)) if sizes[i] > 1)

    def grads_and_metrics(params, batch):
        if m > 1:
            mb = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:]) for k, v in batch.items()}
            grads, seq = None, []
            for i in range(m):
                (_, metrics), g = model.value_and_grad(params, {k: v[i] for k, v in mb.items()}, moe_ctx=mctx)
                if grads is None:
                    grads = {k: x.float() for k, x in g.items()}
                else:
                    for k, x in g.items():
                        grads[k].add_(x.float())
                seq.append(metrics)
            for x in grads.values():
                x.div_(m)
            metrics = {k: torch.stack([s[k] for s in seq]).mean() for k in seq[0]}
        else:
            (_, metrics), grads = model.value_and_grad(params, batch, moe_ctx=mctx)
        return grads, metrics

    def train_step(params, opt_state, batch):
        P, O, b = _local(params), _local(opt_state), _local(batch)
        for k, v in b.items():
            if v.device.type != dev.type:
                raise ValueError(f"batch {k!r} on {v.device}, the plan's device is {dev}")
        grads, metrics = grads_and_metrics(P, b)
        gnorm = None
        if split:
            with torch.no_grad():
                for k, g in grads.items():
                    # a gradient may come strided (under the warm-up's dispatch mode on the card)
                    grads[k] = g = g.contiguous()
                    _all_reduce(g, mesh, allred[k]).div_(n_red)
                keys = sorted(metrics)
                vals = _all_reduce(torch.stack([metrics[k].float() for k in keys]), mesh, red_dims) / n_red
                metrics = dict(zip(keys, vals.unbind()))
                sq = sum(g.float().square().sum() / copies[k] for k, g in grads.items())
                gnorm = torch.sqrt(_all_reduce(sq, mesh, all_dims))
        _, _, om = optim.update(grads, O, P, opt_cfg, gnorm=gnorm)
        return params, opt_state, {**metrics, **om}

    return StepPlan(
        name="train_step",
        fn=train_step,
        args=(p_specs, o_specs, b_specs),
        in_shardings=in_sh,
        out_shardings=out_sh,
        donate_argnums=(0, 1),
        static_meta={"kind": "train", "device": dev, "mesh": mesh},
    )


# --------------------------------------------------------------------------
# serve steps
# --------------------------------------------------------------------------
def cache_specs(cfg: ArchConfig, batch: int, max_seq: int):
    """The cache's tensors on the meta device (global shapes)."""
    return init_cache(cfg, batch, max_seq, device="meta")


def _cache_shardings(cfg: ArchConfig, c_specs, mesh, rules: sh.Rules, rows: Tuple[str, ...]):
    """The cache's placements: the resolver's (``cache_logical`` under
    ``rules``) with the batch dim on the rows' axes ``rows`` (those the
    activations' rows are split over, ``sh.batch_axes``), where the
    resolver could place it elsewhere (``src/repro_torch/DESIGN.md``).
    Attention attends over its K/V as they are placed (on a seq dim split
    by ``serve_rules``, each rank holds its block of the positions:
    ``models/attention.py``); a recurrent state keeps only its ``heads``
    split (``ssm``, ``conv_x``, ``wkv``: this rank's heads, as the mixers
    compute them) and is whole on every other dim (the shift states and the
    B/C convolution tails)."""
    kv_rules = sh.Rules({**rules.table, "batch": tuple(rows)}, rules.min_ndim)
    state_rules = sh.Rules({"batch": tuple(rows), "heads": rules.lookup("heads")}, rules.min_ndim)

    def walk(logical, specs, kv=False):
        if isinstance(logical, dict):
            return {k: walk(v, specs[k], k in ("k", "v")) for k, v in logical.items()}
        if isinstance(logical, list):
            return [walk(v, sp) for v, sp in zip(logical, specs)]
        return sh.NamedSharding(mesh, sh.resolve_pspec(logical, tuple(specs.shape), mesh,
                                                       kv_rules if kv else state_rules))

    return walk(cache_logical(cfg), c_specs)


def _kv_seq(mesh, c_shard) -> Optional[SeqSplit]:
    """The KV caches' seq split (dim 2 of a (G, B, Smax, Hkv, hd) leaf), or
    None when it is whole."""
    kv = [c for c in c_shard["layers"] + [c_shard.get("shared", {})] if "k" in c]
    if not kv:
        return None
    names, sizes, coord = sh.mesh_names(mesh), tuple(mesh.shape), mesh.get_coordinate()
    dims = [i for d, i in sh.dim_splits(mesh, kv[0]["k"].spec) if d == 2 and sizes[i] > 1]
    if not dims:
        return None
    return SeqSplit(tuple(mesh.get_group(i) for i in dims), tuple(sizes[i] for i in dims),
                    tuple(coord[i] for i in dims))


def _serve_param_specs(model, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Serving stores weights in the compute dtype, no fp32 masters: the
    serving form's rule (``models/model.py``), which keeps the router and
    1-D leaves in ``cfg.param_dtype``."""
    return {k: _meta(p.shape, cfg.compute_dtype if _casts(p, k.split(".")) else p.dtype)
            for k, p in model.train_params().items()}


def _serve_call(model, ctx, method: str):
    """``model.call(params, method, ...)`` on this rank's blocks (its rows
    of the cache, written in place)."""

    def run(params, batch, cache, *rest):
        P, b, c = _local(params), _local(batch), _local(cache)
        args = (b, c) if method == "prefill" else (c, b) + rest
        logits, _ = model.call(P, method, *args, moe_ctx=ctx)
        return logits

    return run


@dataclass
class _Serve:
    device: torch.device
    p_specs: Any
    b_specs: Any
    c_specs: Any
    p_shard: Any
    b_shard: Any
    c_shard: Any
    l_shard: Any
    run: Callable
    out: Callable


def _serve_plan(kind: str, cfg: ArchConfig, mesh, shape: ShapeConfig, rules, device, seq_in: int) -> _Serve:
    check_mesh(mesh)
    dev = resolve_device(device)
    model = build_model(cfg, device="meta")
    B = shape.global_batch
    p_specs = _serve_param_specs(model, cfg)
    c_specs = cache_specs(cfg, B, shape.seq_len)
    p_shard = b_shard = c_shard = l_shard = mctx = None
    if mesh is None:
        b_specs = batch_specs(cfg, B, seq_in)
    else:
        rules = rules or sh.serve_rules(cfg)
        p_shard = param_shardings(cfg, mesh, rules)
        b_specs, b_shard = batch_specs(cfg, B, seq_in, mesh, rules)
        l_shard = sh.batch_sharding(mesh, rules, B, 2)
        mctx = moe_ctx_for(cfg, mesh, rules, p_shard, B)
        c_shard = _cache_shardings(cfg, c_specs, mesh, rules, mctx.rows_axes)
        if _split(mesh):
            mctx = dataclasses.replace(mctx, kv_seq=_kv_seq(mesh, c_shard))
    run = _serve_call(model, mctx, kind)
    split = _split(mesh)
    out = lambda logits: sh.place(logits, l_shard, (B, cfg.vocab)) if split else logits
    return _Serve(dev, p_specs, b_specs, c_specs, p_shard, b_shard, c_shard, l_shard, run, out)


def make_prefill_step(cfg: ArchConfig, mesh, shape: ShapeConfig, rules: Optional[sh.Rules] = None,
                      device=None) -> StepPlan:
    """``prefill(params, batch, cache) -> (last-token logits, cache)`` over
    the serving weights (a flat dict, the training form's names); the cache
    is filled in place."""
    sv = _serve_plan("prefill", cfg, mesh, shape, rules, device, shape.seq_len)

    def prefill_step(params, batch, cache):
        return sv.out(sv.run(params, batch, cache)), cache

    return StepPlan(
        name="prefill_step",
        fn=prefill_step,
        args=(sv.p_specs, sv.b_specs, sv.c_specs),
        in_shardings=None if mesh is None else (sv.p_shard, sv.b_shard, sv.c_shard),
        out_shardings=None if mesh is None else (sv.l_shard, sv.c_shard),
        donate_argnums=(2,),
        resident_argnums=(0,),
        static_meta={"kind": "prefill", "device": sv.device, "mesh": mesh},
    )


def make_decode_step(cfg: ArchConfig, mesh, shape: ShapeConfig, rules: Optional[sh.Rules] = None,
                     device=None) -> StepPlan:
    """One new token against a cache of ``shape.seq_len``:
    ``decode(params, cache, batch, pos) -> (logits, cache)``, the cache
    written in place.  ``pos`` is a scalar or a (B,) tensor of per-row
    positions; a scalar is broadcast to the rows on the device, so the step
    reads nothing back to the host and captures into one graph."""
    sv = _serve_plan("decode_step", cfg, mesh, shape, rules, device, 1)

    def decode_step(params, cache, batch, pos):
        rows = next(iter(_local(batch).values())).shape[0]
        pos = sh.local(pos)
        if pos.dim() == 0:
            pos = pos.reshape(1).expand(rows)
        elif pos.shape[0] != rows:  # (B,) global positions: this rank's rows
            pos = sh.shard(pos, sh.NamedSharding(mesh, sh.P(sv.l_shard.spec[0])))
        return sv.out(sv.run(params, batch, cache, pos)), cache

    return StepPlan(
        name="decode_step",
        fn=decode_step,
        args=(sv.p_specs, sv.c_specs, sv.b_specs, _meta((), torch.int32)),
        in_shardings=None if mesh is None else (sv.p_shard, sv.c_shard, sv.b_shard, sh.replicated(mesh)),
        out_shardings=None if mesh is None else (sv.l_shard, sv.c_shard),
        donate_argnums=(1,),
        resident_argnums=(0,),
        static_meta={"kind": "decode", "device": sv.device, "mesh": mesh},
    )


def make_step(cfg: ArchConfig, mesh, shape: ShapeConfig, **kw) -> StepPlan:
    if shape.kind == "train":
        return make_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape, **kw)
    return make_decode_step(cfg, mesh, shape, **kw)
