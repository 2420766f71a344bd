"""Step builders: the training step as a ``StepPlan`` (the JAX package's
``launch/steps.py``).

A ``StepPlan`` holds the step function and its argument trees as tensors on
the ``meta`` device (shapes and dtypes, no storage: the counterpart of the
reference's ``ShapeDtypeStruct`` trees).  ``StepPlan.jitted()`` is the
counterpart of ``jax.jit``: on the card it captures the whole step (the
forward, ``torch.autograd.grad``, the microbatch loop and AdamW) into one
CUDA graph over static parameter, optimizer-state, batch and metric
buffers, and replays it (``core/executors/captured.py`` ``CapturedCall``);
on the CPU the same function runs eagerly.  Parameters and optimizer state
are donated (``donate_argnums``): the step updates them in place and
returns them.

The UTP connection (paper §2.1): a step IS the root task of a task tree —
``TrainStepOp.split() -> [microbatch fwd/bwd]* -> grad-reduce -> optimizer
update`` (``train/step_ops.py``); the plan here is the tree fused into one
program.

One device: ``mesh`` is None or a one-device ``DeviceMesh``.  Sharded
plans, and the prefill and decode plans, are ROADMAP A12.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import optim
from ..configs.base import ArchConfig, ShapeConfig
from ..core.data import resolve_device
from ..core.executors.captured import CapturedCall
from ..models.model import build_model


@dataclass
class StepPlan:
    name: str
    fn: Callable
    args: Tuple[Any, ...]  # meta-device tensor trees (positional)
    donate_argnums: Tuple[int, ...] = ()
    static_meta: Optional[Dict[str, Any]] = None

    def jitted(self) -> CapturedCall:
        """The step captured on its first call on the card, replayed after
        (eager on the CPU)."""
        return CapturedCall(self.fn, self.name, donate=[i in self.donate_argnums for i in range(len(self.args))])


def check_mesh(mesh) -> None:
    """None or a one-device mesh; a larger one is ROADMAP A12's."""
    if mesh is not None and mesh.size() != 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size()} devices: sharded step plans are ROADMAP A12; the port's plans run on one device")


# --------------------------------------------------------------------------
# batch specs
# --------------------------------------------------------------------------
def batch_specs(cfg: ArchConfig, batch: int, seq: int, with_labels: bool) -> Dict[str, torch.Tensor]:
    """The batch's tensors on the meta device: embeds (B, S, D) in the
    compute dtype for stub-frontend archs, else int32 tokens (B, S); int32
    labels (B, S) for training."""
    specs: Dict[str, torch.Tensor] = {}
    if cfg.frontend:
        specs["embeds"] = torch.empty((batch, seq, cfg.d_model), dtype=cfg.compute_dtype, device="meta")
    else:
        specs["tokens"] = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    if with_labels:
        specs["labels"] = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    return specs


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------
def make_train_step(
    cfg: ArchConfig,
    mesh,
    shape: ShapeConfig,
    opt_cfg: Optional[optim.AdamWConfig] = None,
    device=None,
) -> StepPlan:
    """The train step on ``device`` (CUDA unless the caller names another;
    raises without it): ``value_and_grad`` of the loss over
    ``cfg.microbatches`` microbatches (gradients accumulated in fp32, their
    mean taken, the metrics averaged), then ``optim.update``."""
    check_mesh(mesh)
    dev = resolve_device(device)
    model = build_model(cfg, device="meta", train=True)
    opt_cfg = opt_cfg or optim.AdamWConfig(state_dtype=cfg.optim_state_dtype)
    m = cfg.microbatches

    def train_step(params, opt_state, batch):
        for k, v in batch.items():
            if v.device.type != dev.type:
                raise ValueError(f"batch {k!r} on {v.device}, the plan's device is {dev}")
        if m > 1:
            mb = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:]) for k, v in batch.items()}
            grads, seq = None, []
            for i in range(m):
                (_, metrics), g = model.value_and_grad(params, {k: v[i] for k, v in mb.items()})
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
            (_, metrics), grads = model.value_and_grad(params, batch)
        new_params, new_opt, om = optim.update(grads, opt_state, params, opt_cfg)
        return new_params, new_opt, {**metrics, **om}

    p_specs = model.train_params()
    o_specs = {
        "m": {k: torch.empty(p.shape, dtype=opt_cfg.state_dtype, device="meta") for k, p in p_specs.items()},
        "v": {k: torch.empty(p.shape, dtype=opt_cfg.state_dtype, device="meta") for k, p in p_specs.items()},
        "count": torch.empty((), dtype=torch.int32, device="meta"),
    }
    b_specs = batch_specs(cfg, shape.global_batch, shape.seq_len, with_labels=True)
    return StepPlan(
        name="train_step",
        fn=train_step,
        args=(p_specs, o_specs, b_specs),
        donate_argnums=(0, 1),
        static_meta={"kind": "train", "device": dev},
    )

