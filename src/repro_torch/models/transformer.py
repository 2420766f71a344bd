"""Decoder-stack assembly for attention layers (the JAX package's
``models/transformer.py``).

Every architecture is a repeating **group** of layers:

    dense / audio / vlm     group = 1 attention layer
    gemma3 (5 local:1 glob) group = 6 attention layers w/ static windows

Static facts (kind, window size) live in ``LayerDesc``.  The
JAX package scans the groups with ``lax.scan`` over parameters stacked on a
leading ``n_groups`` axis; the port loops over a list of groups (an
``nn.ModuleList`` in the model), each holding its own layers.  The KV cache
keeps the JAX tree and its leading ``n_groups`` axis,
``{"layers": [{"k": (G, B, Smax, Hkv, hd), "v": ...}, ...]}`` (one entry per
layer of the group), so a slot scatter and the tests compare like with
like; group ``g`` reads and writes its slice ``[g]`` in place.

Not ported, by design: ``remat`` and ``scan_layers`` (rematerialisation
and the compiled scan are JAX training mechanisms; the port runs eagerly,
forward only), ``cast_in_scan`` and ``MoeCtx``'s sharding anchors
(multi-chip layouts).  Not ported yet (ROADMAP A11): MoE layers, RWKV and
Mamba2 blocks and zamba2's shared block; ``group_layout`` raises for them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from ..configs.base import ArchConfig
from .attention import attention_apply, attention_template, init_kv_cache
from .layers import mlp_apply, mlp_template, norm_apply, norm_template

A11_LEFT = "moe.py, ssm.py, rwkv.py and frontend.py"


def not_ported(cfg: ArchConfig, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{cfg.name}: {what} is not ported to repro_torch yet "
        f"(ROADMAP A11 still holds {A11_LEFT}); the dense family runs"
    )


@dataclass(frozen=True)
class LayerDesc:
    kind: str  # 'attn' (the only kind ported)
    window: int = 0  # sliding window (0 = global)


def group_layout(cfg: ArchConfig) -> List[LayerDesc]:
    """The static per-layer plan of one group."""
    if cfg.family == "rwkv":
        raise not_ported(cfg, "the RWKV6 block")
    if cfg.family == "hybrid":
        raise not_ported(cfg, "the Mamba2 layer and zamba2's shared block")
    if cfg.is_moe:
        raise not_ported(cfg, "the MoE layer")
    if cfg.local_per_global > 0:
        g = cfg.local_per_global + 1
        return [
            LayerDesc("attn", window=cfg.local_window if i < cfg.local_per_global else 0)
            for i in range(g)
        ]
    return [LayerDesc("attn")]


def n_groups(cfg: ArchConfig) -> int:
    layout = group_layout(cfg)
    if cfg.n_layers % len(layout) != 0:
        raise ValueError(
            f"{cfg.name}: n_layers={cfg.n_layers} not divisible by group size {len(layout)}"
        )
    return cfg.n_layers // len(layout)


# --------------------------------------------------------------------------
# templates
# --------------------------------------------------------------------------
def _layer_template(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": norm_template(cfg),
        "attn": attention_template(cfg),
        "ln2": norm_template(cfg),
        "mlp": mlp_template(cfg),
    }


def group_template(cfg: ArchConfig) -> Dict[str, Any]:
    return {"layers": [_layer_template(cfg) for _ in group_layout(cfg)]}


def stack_template(cfg: ArchConfig) -> Dict[str, Any]:
    """The decoder's template: one group template per group."""
    return {"groups": [group_template(cfg) for _ in range(n_groups(cfg))]}


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None):
    """The whole stack's KV cache: one entry per layer of a group, every
    leaf with a leading ``n_groups`` dim."""
    G = n_groups(cfg)
    return {"layers": [init_kv_cache(cfg, batch, max_seq, G, cfg.cache_dtype, device) for _ in group_layout(cfg)]}


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
) -> torch.Tensor:
    h, _ = attention_apply(
        cfg, p["attn"], norm_apply(cfg, p["ln1"], x), positions,
        window=desc.window, cache=cache, cache_pos=cache_pos,
    )
    x = x + h
    return x + mlp_apply(cfg, p["mlp"], norm_apply(cfg, p["ln2"], x))


def _group_apply(cfg: ArchConfig, layout: List[LayerDesc], p_group, x, positions, cache, g: int,
                 cache_pos) -> torch.Tensor:
    for i, desc in enumerate(layout):
        c_i = None if cache is None else {k: t[g] for k, t in cache["layers"][i].items()}
        x = _layer_apply(cfg, desc, p_group["layers"][i], x, positions, c_i, cache_pos)
    return x


def stack_apply(
    cfg: ArchConfig,
    groups,
    x: torch.Tensor,  # (B, S, D) embedded input
    positions: torch.Tensor,  # (B, S)
    cache: Optional[Dict[str, Any]] = None,
    cache_pos=None,
) -> torch.Tensor:
    """Run the layer groups in order; the cache (if any) is updated in place."""
    layout = group_layout(cfg)
    for g, p_g in enumerate(groups):
        x = _group_apply(cfg, layout, p_g, x, positions, cache, g, cache_pos)
    return x
