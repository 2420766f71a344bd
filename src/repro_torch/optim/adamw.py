"""AdamW with global-norm clipping and configurable moment dtype (the JAX
package's ``optim/adamw.py``).

Master parameters stay fp32; the forward casts them to the compute dtype
(``models/model.py``).  The arithmetic is the reference's step for step, in
fp32, with every scalar a tensor on the parameters' device: ``count`` is an
int32 tensor, the bias corrections ``1 - b ** count`` and the clip scale are
computed on the device, and the learning rate is a schedule of the count or
a filled tensor.  Nothing waits on the host, so ``update`` runs inside a
captured train step.

Parameters and moments are updated in place, the port's counterpart of the
reference's buffer donation; ``update`` still returns the trees (the same
tensors), as the reference's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple, Union

import torch

from ..tree import leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32  # bf16 halves optimizer memory at scale


def init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    device = leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in leaves(tree):
        total = total + leaf.float().square().sum()
    return torch.sqrt(total)


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig, gnorm=None) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, metrics); ``params`` and ``state``
    are updated in place and returned.  ``gnorm``: the gradient's global
    norm where ``grads`` are blocks of a tree split over ranks (the step
    over a mesh computes it); ``global_norm(grads)`` otherwise."""
    count = state["count"]
    count.add_(1)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0) if cfg.clip_norm else 1.0
    lr = cfg.lr(count) if callable(cfg.lr) else torch.full((), cfg.lr, dtype=torch.float32, device=count.device)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, count.float())
    c2 = 1.0 - torch.pow(b2, count.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = m.float() * b1 + g * (1 - b1)
        v32 = v.float() * b2 + torch.square(g) * (1 - b2)
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        p32 = p.float()
        p32 = p32 - lr * (step + cfg.weight_decay * p32)
        p.copy_(p32)
        m.copy_(m32)
        v.copy_(v32)
        return p

    tree_map(upd, params, grads, state["m"], state["v"])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, state, metrics
