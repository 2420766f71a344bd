"""Decoder-stack assembly: heterogeneous layer groups (the JAX package's
``models/transformer.py``).

Every architecture is a repeating **group** of layers:

    dense / audio / vlm     group = 1 attention layer
    gemma3 (5 local:1 glob) group = 6 attention layers w/ static windows
    llama4  (interleaved)   group = [dense-MLP layer, MoE layer]
    granite (all-MoE)       group = 1 MoE layer
    rwkv6                   group = 1 RWKV block (time-mix + channel-mix)
    zamba2 (hybrid)         group = 6 Mamba2 layers + ONE shared attn+MLP
                            block (weights shared across groups)

Static facts (kind, window size, MoE or dense) live in ``LayerDesc``.  The
JAX package scans the groups with ``lax.scan`` over parameters stacked on a
leading ``n_groups`` axis; the port loops over a list of groups (an
``nn.ModuleList`` in the model), each holding its own layers, and zamba2's
shared block is one unstacked tree beside them (``stack/shared``).

The cache keeps the JAX tree and its leading ``n_groups`` axis:
``{"layers": [per layer of a group: {"k", "v"} | {"wkv", "shift_tm",
"shift_cm"} | {"ssm", "conv_x", "conv_b", "conv_c"}], "shared": {"k", "v"}}``
(``shared`` for zamba2 only: the shared block runs once a group, so it
has a KV cache a group).  Group ``g`` reads and writes its slice ``[g]``
in place: attention writes its K/V rows into the slice, and a recurrent
layer's new state is copied into it.

``cfg.remat`` wraps each group body (its layers and the shared block) as
the reference's ``_remat_wrap`` does, when no cache is passed and autograd
records (``records``): ``full`` keeps only the group's input and
recomputes the rest in the backward, ``dots`` also keeps the outputs of
the products without batch dimensions (``aten.mm``/``addmm``: the
reference's ``checkpoint_dots_with_no_batch_dims``), ``none`` keeps
everything.  It
uses ``torch.utils.checkpoint`` without reentry and without saving the RNG
state (no layer draws random numbers, and reading the CUDA RNG state is
not allowed while a CUDA graph captures the step).

Over a mesh (``ctx``, a ``MoeCtx`` with ``params``) each group's
parameters are gathered over the data axes at use, inside the
rematerialised body, so the recompute gathers again; over ``model`` each
layer computes on its blocks (``ctx.tp``, ``models/spmd.py``), and under
sequence parallelism the residual stream between layers is this rank's
chunk of the sequence (the recurrent mixers, like attention, take the
whole sequence and leave their chunk; a recurrent layer's cache holds
this rank's heads of its states).  ``cache_logical`` gives the cache's
logical axes, as the reference's.

Not ported, by design: ``scan_layers`` (the port loops over the groups)
and ``cast_in_scan`` (it only moves the reference's convert; the values
are the same).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..configs.base import ArchConfig
from .attention import attention_apply, attention_template, init_kv_cache
from .layers import mlp_apply, mlp_template, norm_apply, norm_template
from .moe import moe_apply, moe_template
from .rwkv import rwkv_block_apply, rwkv_cache_shape, rwkv_template
from .ssm import mamba_apply, mamba_cache_shape, mamba_template


@dataclass(frozen=True)
class LayerDesc:
    kind: str  # 'attn' | 'rwkv' | 'mamba'
    window: int = 0  # sliding window (0 = global) for attn layers
    moe: bool = False  # MoE MLP instead of dense MLP


SHARED = LayerDesc("attn")  # zamba2's shared block: a global attention layer with a dense MLP


def group_layout(cfg: ArchConfig) -> List[LayerDesc]:
    """The static per-layer plan of one group."""
    if cfg.family == "rwkv":
        return [LayerDesc("rwkv")]
    if cfg.family == "hybrid":
        return [LayerDesc("mamba") for _ in range(cfg.hybrid_attn_every or cfg.n_layers)]
    if cfg.local_per_global > 0:
        g = cfg.local_per_global + 1
        return [
            LayerDesc("attn", window=cfg.local_window if i < cfg.local_per_global else 0, moe=cfg.is_moe)
            for i in range(g)
        ]
    if cfg.is_moe and cfg.moe_interleave > 1:
        # llama4-style: dense layer then routed layer, repeating
        return [LayerDesc("attn", moe=(i % cfg.moe_interleave == cfg.moe_interleave - 1))
                for i in range(cfg.moe_interleave)]
    return [LayerDesc("attn", moe=cfg.is_moe)]


def n_groups(cfg: ArchConfig) -> int:
    layout = group_layout(cfg)
    if cfg.n_layers % len(layout) != 0:
        raise ValueError(
            f"{cfg.name}: n_layers={cfg.n_layers} not divisible by group size {len(layout)}"
        )
    return cfg.n_layers // len(layout)


def has_shared_block(cfg: ArchConfig) -> bool:
    return cfg.family == "hybrid" and cfg.hybrid_attn_every > 0


# --------------------------------------------------------------------------
# templates
# --------------------------------------------------------------------------
def _layer_template(cfg: ArchConfig, desc: LayerDesc) -> Dict[str, Any]:
    if desc.kind == "rwkv":
        return rwkv_template(cfg)
    if desc.kind == "mamba":
        return {"ln1": norm_template(cfg), "mamba": mamba_template(cfg)}
    return {
        "ln1": norm_template(cfg),
        "attn": attention_template(cfg),
        "ln2": norm_template(cfg),
        "mlp": moe_template(cfg) if desc.moe else mlp_template(cfg),
    }


def shared_block_template(cfg: ArchConfig) -> Dict[str, Any]:
    """zamba2's shared attention+MLP block (one copy, run once a group)."""
    return _layer_template(cfg, SHARED)


def group_template(cfg: ArchConfig) -> Dict[str, Any]:
    return {"layers": [_layer_template(cfg, d) for d in group_layout(cfg)]}


def stack_template(cfg: ArchConfig) -> Dict[str, Any]:
    """The decoder's template: one group template per group, and the
    shared block where the family has one."""
    t: Dict[str, Any] = {"groups": [group_template(cfg) for _ in range(n_groups(cfg))]}
    if has_shared_block(cfg):
        t["shared"] = shared_block_template(cfg)
    return t


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------
def _layer_cache(cfg: ArchConfig, desc: LayerDesc, batch: int, max_seq: int, G: int, device):
    """One layer's decode state for all G groups: name -> zeros (G, ...)."""
    if desc.kind == "attn":
        return init_kv_cache(cfg, batch, max_seq, G, cfg.cache_dtype, device)
    if desc.kind == "rwkv":
        shapes, fp32 = rwkv_cache_shape(cfg, batch), ("wkv",)
    else:
        shapes, fp32 = mamba_cache_shape(cfg, batch), ("ssm",)
    return {k: torch.zeros((G,) + s, dtype=torch.float32 if k in fp32 else cfg.cache_dtype, device=device)
            for k, s in shapes.items()}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None):
    """The whole stack's decode state: one entry per layer of a group (and
    the shared block's KV, a group each), every leaf with a leading
    ``n_groups`` dim; recurrent states in fp32, the rest in
    ``cfg.cache_dtype``."""
    G = n_groups(cfg)
    cache: Dict[str, Any] = {"layers": [_layer_cache(cfg, d, batch, max_seq, G, device)
                                        for d in group_layout(cfg)]}
    if has_shared_block(cfg):
        cache["shared"] = init_kv_cache(cfg, batch, max_seq, G, cfg.cache_dtype, device)
    return cache


def _layer_cache_logical(cfg: ArchConfig, desc: LayerDesc) -> Dict[str, Tuple[Optional[str], ...]]:
    """One layer's cache leaves' logical axes, without the leading
    ``"layers"`` dim (the reference's ``_layer_cache_shape``)."""
    if desc.kind == "rwkv":
        return {"wkv": ("batch", "heads", "head_dim", None), "shift_tm": ("batch", "embed"),
                "shift_cm": ("batch", "embed")}
    if desc.kind == "mamba":
        return {"ssm": ("batch", "heads", "state", "head_dim"), "conv_x": ("batch", None, "heads", "head_dim"),
                "conv_b": ("batch", None, None, "state"), "conv_c": ("batch", None, None, "state")}
    ax = ("batch", "seq", "kv_heads", "head_dim")
    return {"k": ax, "v": ax}


def cache_logical(cfg: ArchConfig):
    """The logical axes of ``init_cache``'s leaves, in its tree: every leaf
    led by ``"layers"`` (its ``n_groups`` dim)."""
    lead = lambda t: {k: ("layers",) + v for k, v in t.items()}
    out: Dict[str, Any] = {"layers": [lead(_layer_cache_logical(cfg, d)) for d in group_layout(cfg)]}
    if has_shared_block(cfg):
        out["shared"] = lead(_layer_cache_logical(cfg, SHARED))
    return out


def cache_leaves(cache) -> List[torch.Tensor]:
    """Every leaf of a cache, layout (G, B, ...)."""
    return [t for c in cache["layers"] + [cache.get("shared", {})] for t in c.values()]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _layer_apply(
    cfg: ArchConfig,
    desc: LayerDesc,
    p,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]],
    cache_pos,
    aux: Optional[List[torch.Tensor]] = None,
    ctx=None,
) -> torch.Tensor:
    """One layer; ``cache`` (this group's slice of the layer's state) is
    updated in place.  An MoE layer appends its aux loss to ``aux`` when
    the caller passes a list."""
    if desc.kind in ("rwkv", "mamba"):
        if desc.kind == "rwkv":
            x, new = rwkv_block_apply(cfg, p, x, cache, ctx)
        else:
            h, new = mamba_apply(cfg, p["mamba"], norm_apply(cfg, p["ln1"], x), cache, ctx)
            x = x + h
        if cache is not None:
            for k, t in new.items():
                cache[k].copy_(t)
        return x
    h, _ = attention_apply(
        cfg, p["attn"], norm_apply(cfg, p["ln1"], x), positions,
        window=desc.window, cache=cache, cache_pos=cache_pos, ctx=ctx,
    )
    x = x + h
    h2 = norm_apply(cfg, p["ln2"], x)
    if desc.moe:
        out, a = moe_apply(cfg, p["mlp"], h2, ctx)
        if aux is not None:
            aux.append(a)
        return x + out
    return x + mlp_apply(cfg, p["mlp"], h2, ctx)


def _slice(cache, g: int):
    return None if cache is None else {k: t[g] for k, t in cache.items()}


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def records(*tensors) -> bool:
    """True when autograd records an op on these tensors: grad is enabled
    and one of them requires grad.  A checkpoint is taken only then (a
    frozen model's forward takes none: a checkpoint that records nothing
    still holds its function and inputs in a reference cycle until the
    garbage collector runs)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def remat(cfg: ArchConfig, fn, *args, params=()):
    """``fn(*args)`` under ``cfg.remat`` (module docstring) when autograd
    records on ``args`` or ``params`` (the tensors ``fn`` reads besides its
    arguments); a plain call otherwise."""
    if cfg.remat == "none" or not records(*(a for a in args if torch.is_tensor(a)), *params):
        return fn(*args)
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {cfg.remat!r}")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def _group_apply(cfg, layout, p_g, shared, g: int, x, positions, cache, cache_pos, ctx=None):
    """One group's layers, then the shared block where the family has one.
    Returns (hidden, the group's summed MoE aux loss).  With a context that
    gathers parameters, the group's (and the shared block's) are gathered
    first."""
    if ctx is not None and ctx.params is not None:
        p_g = ctx.params.tree(p_g, f"stack.groups.{g}")
        if shared is not None:
            shared = ctx.params.tree(shared, "stack.shared")
    aux: List[torch.Tensor] = []
    for i, desc in enumerate(layout):
        c_i = None if cache is None else _slice(cache["layers"][i], g)
        x = _layer_apply(cfg, desc, p_g["layers"][i], x, positions, c_i, cache_pos, aux, ctx)
    if shared is not None:
        c_s = None if cache is None else _slice(cache["shared"], g)
        x = _layer_apply(cfg, SHARED, shared, x, positions, c_s, cache_pos, ctx=ctx)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in aux:
        total = total + a
    return x, total


def stack_apply(
    cfg: ArchConfig,
    stack,
    x: torch.Tensor,  # (B, S, D) embedded input
    positions: torch.Tensor,  # (B, S)
    cache: Optional[Dict[str, Any]] = None,
    cache_pos=None,
    ctx=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the layer groups in order, each followed by the shared block
    where the family has one, each group under ``cfg.remat`` when no cache
    is passed.  Returns (hidden, the summed MoE aux loss, group by group as
    the reference's scan carries it); the cache (if any) is updated in
    place."""
    layout = group_layout(cfg)
    shared = stack["shared"] if has_shared_block(cfg) else None
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for g, p_g in enumerate(stack["groups"]):
        body = partial(_group_apply, cfg, layout, p_g, shared, g, ctx=ctx)
        if cache is None:
            params = [*p_g.parameters(), *(shared.parameters() if shared is not None else ())]
            x, aux = remat(cfg, body, x, positions, None, cache_pos, params=params)
        else:
            x, aux = body(x, positions, cache, cache_pos)
        total = total + aux
    return x, total
