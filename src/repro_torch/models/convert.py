"""Load the JAX package's parameters into the port.

``params_from_jax(cfg, tree)`` takes the JAX package's parameter tree as
numpy arrays (``jax.tree.map(np.asarray, params)``, done by the caller: the
port never imports JAX), splits the stacked ``groups`` axis (the JAX
package scans its layer groups over parameters stacked on a leading
``n_groups`` axis) into the port's list of groups, keeps zamba2's
unstacked shared block (``stack/shared``) as it is, and loads the result
with ``build_model``.  With it both packages compute with the same
weights, which torch cannot draw: it cannot reproduce ``jax.random``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from .model import Model, build_model
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


def params_from_jax(cfg: ArchConfig, tree: Dict[str, Any], *, device=None) -> Model:
    """A ``Model`` on ``device`` (CUDA unless the caller passes another)
    holding the JAX package's parameters ``tree`` (numpy leaves)."""
    stack = tree["stack"]
    port = {k: _map(v, _tensor) for k, v in tree.items() if k != "stack"}
    port["stack"] = {k: _map(v, _tensor) for k, v in stack.items() if k != "groups"}
    port["stack"]["groups"] = [_map(stack["groups"], lambda a, g=g: _tensor(np.asarray(a)[g]))
                               for g in range(n_groups(cfg))]
    return build_model(cfg, port, device=device)
