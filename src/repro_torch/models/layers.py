"""Shared model building blocks and the parameter-template system (the JAX
package's ``models/layers.py``).

Every parameter is declared as a ``PSpec`` (shape, logical axes, init
kind, scale).  The template tree drives ``init_params`` (seeded draws from
a ``torch.Generator``; torch cannot reproduce ``jax.random``'s numbers, so
the tests carry the JAX package's parameters across instead, through
``models/convert.py``) and ``count_template`` (exact N without
allocation).  The logical axes are the JAX templates', copied: the port
reads them only to find the expert leaves (``"experts"``) for
``param_counts``; the JAX package's sharding resolver also reads them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .spmd import tp_of


@dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'const' | 'embed'
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"PSpec shape {self.shape} and logical axes {self.logical} differ in rank")


def map_template(template, fn: Callable[[PSpec, str], Any], path: str = ""):
    """The template tree (dicts and lists) with ``fn(leaf, path)`` applied
    to each leaf, ``path`` the leaf's keys joined by "/"."""
    if isinstance(template, PSpec):
        return fn(template, path)
    if isinstance(template, dict):
        return {k: map_template(v, fn, f"{path}/{k}") for k, v in template.items()}
    return [map_template(v, fn, f"{path}/{i}") for i, v in enumerate(template)]


def init_tensor(spec: PSpec, gen: torch.Generator, dtype, device) -> torch.Tensor:
    """One parameter by ``init_params``'s rules: ones/zeros/const, an
    ``embed`` normal of std ``scale``, else a normal of std
    ``scale / sqrt(fan_in)`` with fan_in the second-to-last dimension."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "const":
        return torch.full(spec.shape, spec.scale, dtype=dtype, device=device)
    if spec.init == "embed":
        std = spec.scale
    else:
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / (fan_in ** 0.5)
    # in place: a draw of llama4's expert leaves is 21.5 GB in fp32
    return torch.randn(spec.shape, generator=gen, dtype=dtype, device=device).mul_(std)


def template_leaves(template) -> Iterator[PSpec]:
    if isinstance(template, PSpec):
        yield template
        return
    for v in template.values() if isinstance(template, dict) else template:
        yield from template_leaves(v)


def count_template(template) -> int:
    return sum(math.prod(s.shape) for s in template_leaves(template))


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,d...->bs...'): x (B, S, D) times a weight (D, ...) as one
    (B*S, D) x (D, prod(...)) product, in x's dtype."""
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def largest_divisor(S: int, chunk: int) -> int:
    """The chunked scans' chunk: the largest divisor of S not exceeding
    ``chunk``."""
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    return Q


# --------------------------------------------------------------------------
# norms / rope (fp32 inside, cast back)
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_template(cfg: ArchConfig, dim: Optional[int] = None) -> Dict[str, PSpec]:
    """Pre-norm parameter template honouring ``cfg.norm_type``."""
    d = cfg.d_model if dim is None else dim
    t = {"scale": PSpec((d,), ("embed",), init="ones")}
    if cfg.norm_type == "layernorm":
        t["bias"] = PSpec((d,), ("embed",), init="zeros")
    return t


def norm_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def sinusoidal_embed(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Classic transformer sin/cos position embedding. positions (B,S) -> (B,S,dim)."""
    half = dim // 2
    freqs = torch.exp(
        -torch.arange(half, dtype=torch.float32, device=positions.device) * (math.log(10000.0) / half)
    )
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rope_embed(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for ``positions`` (any shape) -> (+ (hd/2,)) trailing."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) -> broadcast over heads.
    Rotates the two halves of the head dimension (not interleaved pairs)."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------
def mlp_template(cfg: ArchConfig) -> Dict[str, PSpec]:
    D, F_ = cfg.d_model, cfg.d_ff
    t = {"wo": PSpec((F_, D), ("mlp", "embed"))}
    t["wi"] = PSpec((D, F_), ("embed", "mlp"))
    if cfg.mlp_type in ("swiglu", "geglu"):
        t["wg"] = PSpec((D, F_), ("embed", "mlp"))
    return t


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ArchConfig, p, x: torch.Tensor, ctx=None) -> torch.Tensor:
    """x: the residual stream's layout, (B, S, D) or this rank's chunk of
    the sequence under SP.  Over ``model`` (``models/spmd.py``) ``wi``/``wg``
    split on ``mlp`` are column-parallel and ``wo`` row-parallel; whole, the
    MLP runs on this rank's rows as they are."""
    tp = tp_of(ctx)
    split = tp is not None and p["wi"].shape[-1] != cfg.d_ff
    if split:
        x = tp.enter(x)
    h = x @ p["wi"].to(x.dtype)
    if cfg.mlp_type == "swiglu":
        g = x @ p["wg"].to(x.dtype)
        h = F.silu(g.float()).to(x.dtype) * h
    elif cfg.mlp_type == "geglu":
        g = x @ p["wg"].to(x.dtype)
        h = _gelu(g.float()).to(x.dtype) * h
    elif cfg.mlp_type == "relu2":  # nemotron squared-ReLU
        h = F.relu(h.float()).square().to(x.dtype)
    elif cfg.mlp_type == "gelu":  # starcoder2/musicgen non-gated GELU
        h = _gelu(h.float()).to(x.dtype)
    else:
        raise ValueError(cfg.mlp_type)
    out = h @ p["wo"].to(x.dtype)
    return tp.leave(out) if split else out
