"""Load the JAX package's parameters into the port.

``params_from_jax(cfg, tree)`` takes the JAX package's parameter tree as
numpy arrays (``jax.tree.map(np.asarray, params)``, done by the caller: the
port never imports JAX), splits the stacked ``groups`` axis (the JAX
package scans its layer groups over parameters stacked on a leading
``n_groups`` axis) into the port's list of groups, keeps zamba2's
unstacked shared block (``stack/shared``) as it is, and loads the result
with ``build_model``: cast at load for serving, or, with ``train=True``, as
the fp32 masters of the training form, never cast.  With it both packages
compute with the same weights, which torch cannot draw: it cannot
reproduce ``jax.random``.

Two layout functions carry any tree of the model's shape across, each way:
``to_port(cfg, tree)`` turns a JAX-package tree (numpy leaves, stacked
``groups``) into the training form's flat ``{name: tensor}`` dict, and
``to_jax(cfg, flat)`` turns such a dict back into a JAX-layout tree of
numpy arrays.  Parameters, gradients and AdamW's ``m`` and ``v`` all have
that shape, so the tests compare every leaf of every tree.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.data import resolve_device
from ..tree import flatten_with_paths, tree_map
from .layers import PSpec
from .model import Model, build_model, model_template
from .transformer import n_groups


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _tensor(a) -> torch.Tensor:
    """A torch copy of one leaf (numpy views of JAX arrays are read-only)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy's ml_dtypes bfloat16 has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _port_tree(cfg: ArchConfig, tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's nested layout of a JAX-package tree: the stacked groups
    split into a list, every leaf a torch copy on the host."""
    stack = tree["stack"]
    port = {k: _map(v, _tensor) for k, v in tree.items() if k != "stack"}
    port["stack"] = {k: _map(v, _tensor) for k, v in stack.items() if k != "groups"}
    port["stack"]["groups"] = [_map(stack["groups"], lambda a, g=g: _tensor(np.asarray(a)[g]))
                               for g in range(n_groups(cfg))]
    return port


def params_from_jax(cfg: ArchConfig, tree: Dict[str, Any], *, device=None, train: bool = False) -> Model:
    """A ``Model`` on ``device`` (CUDA unless the caller passes another)
    holding the JAX package's parameters ``tree`` (numpy leaves); the
    training form of it with ``train``."""
    return build_model(cfg, _port_tree(cfg, tree), device=device, train=train)


def to_port(cfg: ArchConfig, tree: Dict[str, Any], *, device=None) -> Dict[str, torch.Tensor]:
    """A JAX-layout tree of the model's shape (numpy leaves) as the
    training form's flat {name: tensor} dict on ``device`` (CUDA unless the
    caller passes another), each leaf in its own dtype."""
    dev = resolve_device(device)
    flat = flatten_with_paths(_port_tree(cfg, tree))
    return {k.replace("/", "."): v.to(dev) for k, v in flat.items()}


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_jax(cfg: ArchConfig, flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The training form's flat {name: tensor} dict as a JAX-layout tree of
    numpy arrays (the groups stacked on a leading axis; bf16 leaves as
    float32, which holds them exactly)."""

    def build(template, prefix: str):
        if isinstance(template, PSpec):
            return _host(flat[prefix])
        if isinstance(template, dict):
            return {k: build(v, f"{prefix}.{k}") for k, v in template.items()}
        return [build(v, f"{prefix}.{i}") for i, v in enumerate(template)]

    t = model_template(cfg)
    out = {k: build(v, k) if not isinstance(v, PSpec) else _host(flat[k]) for k, v in t.items() if k != "stack"}
    stack = {k: build(v, f"stack.{k}") for k, v in t["stack"].items() if k != "groups"}
    groups = [build(g, f"stack.groups.{i}") for i, g in enumerate(t["stack"]["groups"])]
    stack["groups"] = tree_map(lambda *xs: np.stack(xs), groups[0], *groups[1:])
    out["stack"] = stack
    return out
