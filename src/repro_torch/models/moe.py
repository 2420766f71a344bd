"""Mixture-of-Experts layer: top-k router and three dispatch strategies
(the JAX package's ``models/moe.py``).

``ep``     (over a mesh): expert parallelism.  Tokens stay on their data
           shard, experts are split over the ``model`` mesh axis; every
           model rank routes its shard's tokens, builds the capacity buffer
           of *its* experts only (capacity sized on the shard's tokens;
           where the global batch does not divide the batch axes the
           reference replicates it, and the port, whose rows stay split,
           counts slots and capacity in the global batch's order) and the
           combine is one sum over the ``model`` group (the GShard
           dataflow).  The experts' FSDP'd ``embed`` dim arrives gathered
           over the data axes (gather at use, ``models/spmd.py``).
``gather`` (the default): capacity-bounded scatter/gather permutation,
           O(T·k·D) data movement, linear in tokens.
``dense``  : Mesh-TF style one-hot dispatch products, O(T·E·C) FLOPs, kept
           as the naive baseline.

The router computes fp32 logits from fp32 operands (its weights stay in
``cfg.param_dtype`` at load: ``models/model.py``), applies softmax after
top-k (the Switch convention) and returns the Switch load-balancing loss,
which the caller weights.

Top-k ties: ``jax.lax.top_k`` puts the lower expert index first.  The port
takes the first k of a stable descending sort, which orders ties the same
way.  The order matters: a token's slot in its expert's buffer is a
cumulative count over the flattened (T·k) assignments, so another order
would move tokens across the capacity cut.

``MoeCtx`` is the parallel context the plans over a mesh pass down the
model (``launch/steps.py`` ``moe_ctx_for``), with the split of compute
over ``model`` (``tp``: the reference's layout anchors as explicit
collectives, ``src/repro_torch/DESIGN.md``).  The expert products are
batched matrix products, as the reference's XLA einsums are; no
hand-written kernel is involved.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import PSpec, _gelu
from .spmd import all_gather, copy_to, mean_value, tp_of


@dataclass(frozen=True)
class MoeCtx:
    """Parallel context: the EP dispatch's axes, and gather at use.

    ``batch_axes``: mesh axes the token batch dim is sharded over (the
    rules' candidates; ``rows_axes`` those the rows of this call are split
    over).  ``model_axis``: the axis experts are sharded over.  ``params``
    gathers each parameter's data-axis blocks at use (``models/spmd.py``
    ``ParamGather``); ``tp`` splits compute over ``model`` (``spmd.TP``,
    None when that axis is 1); ``kv_seq`` the KV caches' seq dim
    (``spmd.SeqSplit``, serving).
    """

    mesh: Any
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"
    rows_axes: Tuple[str, ...] = ()
    params: Optional[Any] = None
    tp: Optional[Any] = None
    kv_seq: Optional[Any] = None

    def for_seq(self, S: int) -> "MoeCtx":
        """This context for a call of sequence length ``S`` (``TP.for_seq``)."""
        return self if self.tp is None else replace(self, tp=self.tp.for_seq(S))

    def _size(self, axes) -> int:
        from ..launch.sharding import mesh_sizes

        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes[a] for a in axes)

    def group(self, axis: str):
        from ..launch.sharding import mesh_names

        return self.mesh.get_group(mesh_names(self.mesh).index(axis))

    def index(self, axis: str) -> int:
        from ..launch.sharding import mesh_names

        return self.mesh.get_coordinate()[mesh_names(self.mesh).index(axis)]


def moe_template(cfg: ArchConfig) -> Dict[str, PSpec]:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    t = {
        "router": PSpec((D, E), (None, None), scale=0.1),
        "wi": PSpec((E, D, F_), ("experts", "embed", "mlp")),
        "wo": PSpec((E, F_, D), ("experts", "mlp", "embed")),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        t["wg"] = PSpec((E, D, F_), ("experts", "embed", "mlp"))
    if cfg.shared_expert:
        t["shared_wi"] = PSpec((D, F_), ("embed", "mlp"))
        t["shared_wg"] = PSpec((D, F_), ("embed", "mlp"))
        t["shared_wo"] = PSpec((F_, D), ("mlp", "embed"))
    return t


def _act(cfg: ArchConfig, up: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    if cfg.mlp_type in ("swiglu", "geglu"):
        fn = F.silu if cfg.mlp_type == "swiglu" else _gelu
        return fn(gate.float()).to(up.dtype) * up
    if cfg.mlp_type == "relu2":
        return F.relu(up.float()).square().to(up.dtype)
    return _gelu(up.float()).to(up.dtype)


def _expert_ffn(cfg: ArchConfig, wi, wg, wo, h: torch.Tensor) -> torch.Tensor:
    """h: (E, C, D) -> (E, C, D), one batched product over the experts."""
    up = torch.bmm(h, wi.to(h.dtype))
    g = torch.bmm(h, wg.to(h.dtype)) if wg is not None else None
    return torch.bmm(_act(cfg, up, g), wo.to(h.dtype))


def _rows(ctx: Optional[MoeCtx]) -> Tuple[Tuple[Any, int, int], ...]:
    """The mesh dims this call's rows are split over (``ctx.rows_axes``
    larger than one), major to minor: (group, size, this rank's
    coordinate) each."""
    if ctx is None or ctx.mesh is None:
        return ()
    return tuple((ctx.group(a), ctx._size((a,)), ctx.index(a)) for a in ctx.rows_axes if ctx._size((a,)) > 1)


def _before(rows, counts: torch.Tensor) -> torch.Tensor:
    """``counts`` (one an expert) summed over the ranks of ``rows`` before
    this one: each rank's rows are a contiguous block of the global batch,
    in rank order along the rows' dims, so these are the assignments of
    the global batch's earlier tokens."""
    every = counts[None]
    for group, n, _ in reversed(rows):  # (ranks, E) in rank order, the minor dim gathered first
        every = all_gather(every, 0, group, n)
    i = 0
    for _, n, c in rows:
        i = i * n + c
    return every[:i].sum(0)


def _router(cfg: ArchConfig, router_w: torch.Tensor, xf: torch.Tensor, rows=()):
    """xf: (T, D).  Returns (gates (T, k) fp32, idx (T, k), aux loss).
    ``rows`` (``_rows``): the aux loss's means are the global batch's."""
    logits = xf.float() @ router_w.float()
    gates_all = torch.softmax(logits, dim=-1)
    top_vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_vals, idx = top_vals[:, : cfg.top_k], idx[:, : cfg.top_k]
    gates = torch.softmax(top_vals, dim=-1)  # renormalised over the selected
    # load-balance aux (Switch): E * sum_e f_e * P_e, f by top-1 assignment
    E = cfg.n_experts
    f, pm = F.one_hot(idx[:, 0], E).float().mean(0), gates_all.mean(0)
    for group, n, _ in rows:  # equal rows a rank: the mean of the ranks' means
        f, pm = mean_value(torch.stack([f, pm]), group, n).unbind()
    aux = E * (f * pm).sum()
    return gates, idx, aux


def _capacity(cfg: ArchConfig, n_tokens: int) -> int:
    return max(1, int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def _slots(cfg: ArchConfig, idx: torch.Tensor, C: int, rows=()) -> torch.Tensor:
    """The buffer row of every (token, k) assignment, in the flattened
    (T·k) order: expert e's n-th assignment goes to row e·C + n while
    n < C; the rest go to the overflow row E·C (dropped).  The running
    count is the reference's cumulative sum of one-hots, taken along the
    inner dimension of the (E, T·k) transpose: on the card a scan along
    the outer dimension of (T·k, E) is two orders of magnitude slower.
    ``rows`` (``_rows``): n counts in the global batch's order."""
    E = cfg.n_experts
    flat_e = idx.reshape(-1)
    pos_in_e = torch.cumsum(F.one_hot(flat_e, E).T.contiguous(), dim=1) - 1  # (E, T*k): 0-based slot
    pos = pos_in_e.gather(0, flat_e[None])[0]
    if rows:
        pos = pos + _before(rows, pos_in_e[:, -1] + 1)[flat_e]
    return torch.where(pos < C, flat_e * C + pos, E * C)


def _gather_dispatch(cfg: ArchConfig, p, xf, gates, idx, C, rows=()):
    """Permutation dispatch: scatter tokens to (E, C) slots, gather back.
    The buffer has one real overflow row, sliced off before the experts
    run, so duplicate writes to it are harmless.  ``rows``: the slots are
    the global batch's, and this rank's buffer holds its tokens' only."""
    T, D = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    gated = cfg.mlp_type in ("swiglu", "geglu")
    dest = _slots(cfg, idx, C, rows)
    src = xf.repeat_interleave(k, dim=0) if k > 1 else xf
    buf = torch.zeros(E * C + 1, D, dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, dest, src)
    h = _expert_ffn(cfg, p["wi"], p["wg"] if gated else None, p["wo"], buf[: E * C].reshape(E, C, D))
    hflat = torch.cat([h.reshape(E * C, D), h.new_zeros(1, D)])
    back = hflat[dest] * gates.reshape(-1)[:, None].to(h.dtype)  # (T*k, D)
    return back.reshape(T, k, D).sum(1)


def _dense_dispatch(cfg: ArchConfig, p, xf, gates, idx, C, rows=()):
    """One-hot dispatch products (the naive baseline); the one-hots and
    their cumulative sum in ``xf``'s dtype, as the reference builds them.
    ``rows``: the slots are the global batch's."""
    T, D = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    gated = cfg.mlp_type in ("swiglu", "geglu")
    onehot = F.one_hot(idx, E).to(xf.dtype)  # (T, k, E)
    cum = torch.cumsum(onehot.reshape(T * k, E), dim=0)
    slot = ((cum.reshape(T, k, E) - onehot) * onehot).sum(-1)  # (T, k): 0-based slot id
    if rows:
        slot = slot + _before(rows, cum[-1].long())[idx].to(slot.dtype)
    slot_oh = (slot[..., None] == torch.arange(C, device=xf.device, dtype=slot.dtype)).to(xf.dtype)
    slot_oh = slot_oh * (slot < C)[..., None].to(xf.dtype) * onehot.sum(-1, keepdim=True)
    disp = torch.einsum("tke,tkc->ect", onehot, slot_oh)
    h_in = torch.einsum("ect,td->ecd", disp, xf)
    h = _expert_ffn(cfg, p["wi"], p["wg"] if gated else None, p["wo"], h_in)
    comb = torch.einsum("tke,tkc,tk->ect", onehot, slot_oh, gates.to(xf.dtype))
    return torch.einsum("ect,ecd->td", comb, h)


def _shared_expert(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["shared_wi"].to(x.dtype)
    g = x @ p["shared_wg"].to(x.dtype)
    up = F.silu(g.float()).to(x.dtype) * up
    return up @ p["shared_wo"].to(x.dtype)


def use_ep(cfg: ArchConfig, ctx: Optional[MoeCtx]) -> bool:
    """The reference's rule: EP whenever a mesh has the model axis and it
    divides the experts."""
    from ..launch.sharding import mesh_names, mesh_sizes

    return (
        ctx is not None
        and ctx.mesh is not None
        and ctx.model_axis is not None
        and ctx.model_axis in mesh_names(ctx.mesh)
        and cfg.n_experts % mesh_sizes(ctx.mesh)[ctx.model_axis] == 0
    )


def moe_apply(cfg: ArchConfig, p, x: torch.Tensor, ctx: Optional[MoeCtx] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) (this rank's rows over a mesh; its chunk of the
    sequence under SP) -> (out, aux loss).

    Without EP the reference routes the whole batch: where the rows are
    split, each rank routes its own and counts slots and sizes capacity in
    the global batch's order (``_rows``, ``_slots``), and the aux loss
    takes the global means; no rank holds another's tokens.

    Over ``model`` (``ctx.tp``, ``models/spmd.py``) the layer routes the
    whole sequence of its rows (gathered first under SP) on every model
    rank, runs its experts (EP) or its ``mlp`` block of every expert, and
    the shared expert's ``mlp`` block, and sums the parts over ``model``
    (reduce-scattered on seq under SP).  Without SP the experts' input
    enters through ``copy_to`` after the router, so the router's gradient
    is every rank's; with it the gates do not, and every rank passes back
    1/n of the aux loss's gradient (``TP.shared``)."""
    ep = use_ep(cfg, ctx)
    rows = () if ep else _rows(ctx)
    tp = tp_of(ctx)
    if tp is None:
        out, aux = _moe_ep(cfg, p, x, ctx) if ep else _routed(cfg, p, x, x, rows)
        if cfg.shared_expert:
            out = out + _shared_expert(cfg, p, x)
        return out, aux
    split = ep or p["wi"].shape[-1] != cfg.d_ff  # each rank computes a part of every token's output
    shared_split = cfg.shared_expert and p["shared_wi"].shape[-1] != cfg.d_ff
    if not split:  # the whole layer on every model rank
        xw = tp.whole(x)
        out, aux = _routed(cfg, p, xw, xw, rows)
        if cfg.shared_expert:
            out = out + _shared_expert(cfg, p, xw)
        return tp.own(out), tp.shared(aux)
    xe = tp.enter(x)  # under SP the whole sequence; its gradient summed over model
    xr = xe if tp.sp else x  # the router's input: without SP its gradient is every rank's (module docstring)
    out, aux = _moe_ep(cfg, p, xe, ctx, tp, xr) if ep else _routed(cfg, p, xe, xr, rows, tp)
    if shared_split:
        out = out + _shared_expert(cfg, p, xe)
    out = tp.leave(out)
    if cfg.shared_expert and not shared_split:
        out = out + _shared_expert(cfg, p, x)
    return out, tp.shared(aux)


def _routed(cfg: ArchConfig, p, x: torch.Tensor, xr: torch.Tensor, rows=(), tp=None):
    """The local dispatch of ``x``'s tokens, routed on ``xr``'s: (out,
    aux).  ``rows`` (``_rows``): slots and capacity of the global batch.
    With ``tp`` and without SP the gates enter the split part through
    ``copy_to``."""
    B, S, D = x.shape
    gates, idx, aux = _router(cfg, p["router"], xr.reshape(B * S, D), rows)
    if tp is not None and not tp.sp:
        gates = copy_to(gates, tp.group)
    C = _capacity(cfg, B * S * math.prod(n for _, n, _ in rows))
    return _dispatch(cfg, p, x.reshape(B * S, D), gates, idx, C, rows).reshape(B, S, D), aux


def _dispatch(cfg: ArchConfig, p, xf, gates, idx, C, rows=()):
    dispatch = _dense_dispatch if cfg.moe_dispatch == "dense" else _gather_dispatch
    return dispatch(cfg, p, xf, gates, idx, C, rows)


def _moe_ep(cfg: ArchConfig, p, x: torch.Tensor, ctx: MoeCtx, tp=None, xr=None):
    """Expert parallelism (module docstring) on this rank's rows: the
    reference's ``shard_map`` body.  ``p``'s expert leaves hold this model
    rank's ``E // tp`` experts.  With ``tp`` (``models/spmd.py``) the
    result is this rank's part, which the caller sums over ``model``, and
    ``x`` has entered the split part (``TP.enter``); ``xr``: the router's
    input (default ``x``).  Without ``tp`` the model axis is 1."""
    from ..launch.sharding import mesh_names

    maxis = ctx.model_axis
    E, k = cfg.n_experts, cfg.top_k
    if tp is None and ctx._size((maxis,)) > 1:
        raise ValueError(f"EP over a model axis of {ctx._size((maxis,))} needs the context's tp (launch/steps.py "
                         "moe_ctx_for)")
    E_loc = E // (tp.n if tp is not None else 1)
    B, S, D = x.shape
    n_rows = ctx._size(ctx.rows_axes)
    # the reference's axes of the global batch: all of them, or none (the
    # batch replicated, routed whole: the global batch's slots and
    # capacity where the rows are split, as the local dispatch's)
    baxes = tuple(a for a in ctx.batch_axes if a in mesh_names(ctx.mesh))
    if (B * n_rows) % ctx._size(baxes) != 0:
        baxes = ()
    rows = _rows(ctx) if ctx._size(baxes) != n_rows else ()
    T = B * S
    C = _capacity(cfg, T * math.prod(n for _, n, _ in rows))
    xf = x.reshape(T, D)
    gates, idx, aux = _router(cfg, p["router"], xf if xr is None else xr.reshape(T, D), rows)
    e0 = ctx.index(maxis) * E_loc
    flat_e = idx.reshape(-1)  # (T*k,)
    local = (flat_e >= e0) & (flat_e < e0 + E_loc)
    le = torch.where(local, flat_e - e0, E_loc)  # E_loc: the "overflow expert"
    cum = torch.cumsum(F.one_hot(le, E_loc + 1).T.contiguous(), dim=1) - 1  # (E_loc + 1, T*k)
    pos = cum.gather(0, le[None])[0]
    if rows:
        pos = pos + _before(rows, cum[:, -1] + 1)[le]
    keep = local & (pos < C)
    dest = torch.where(keep, le * C + pos, E_loc * C)
    if tp is not None and not tp.sp:
        gates = copy_to(gates, tp.group)
    src = xf.repeat_interleave(k, dim=0) if k > 1 else xf
    buf = torch.zeros(E_loc * C + 1, D, dtype=xf.dtype, device=xf.device)
    buf = buf.index_copy(0, dest, src)
    gated = cfg.mlp_type in ("swiglu", "geglu")
    h = _expert_ffn(cfg, p["wi"], p["wg"] if gated else None, p["wo"], buf[: E_loc * C].reshape(E_loc, C, D))
    hflat = torch.cat([h.reshape(E_loc * C, D), h.new_zeros(1, D)])
    back = hflat[dest] * gates.reshape(-1)[:, None].to(h.dtype)
    out = back.reshape(T, k, D).sum(1)
    for a in baxes:
        if ctx._size((a,)) > 1:
            aux = mean_value(aux, ctx.group(a), ctx._size((a,)))
    return out.reshape(B, S, D), aux
