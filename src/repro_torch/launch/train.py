"""Training entry point (the JAX package's ``launch/train.py``).

    python -m repro_torch.launch.train --arch qwen3-32b --shape train_4k \\
        --steps 1000 --ckpt-dir DIR --ckpt-every 100 [--reduced] [--device cpu]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --distributed ...

Runs ``Trainer`` (async checkpoints, resume) on one device, CUDA unless
``--device`` names another, where the step is one captured CUDA graph.
``--distributed`` joins the job torchrun started (its environment:
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``...; NCCL on the card, gloo on
the CPU) and trains over ``make_local_mesh()``, a (world, 1) mesh over
every rank, as the reference does without ``--production-mesh``.
``--reduced`` trains the reduced configuration at sequence 128, batch 8
(the reference's CPU harness shape); without it, the published
configuration at ``--shape``.  ``--production-mesh`` (with ``--multi-pod``:
the (2, 16, 16) one) joins the job as ``--distributed`` does and trains the
published configuration over ``make_production_mesh``, which needs a job of
256 (512) ranks; with ``--reduced`` the flags are ignored, as the
reference's are.  ``python -m repro_torch.launch.dryrun`` traces such a job
without the cards.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from .. import optim
from ..configs import get_arch, get_shape
from ..configs.base import ShapeConfig
from ..core.data import resolve_device
from ..train import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config + small shape (the CPU harness)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--distributed", action="store_true", help="train over every rank of a torchrun job")
    ap.add_argument("--production-mesh", action="store_true",
                    help="train over the (16, 16) mesh of a 256-rank job (joins it as --distributed)")
    ap.add_argument("--multi-pod", action="store_true", help="with --production-mesh: the (2, 16, 16) mesh")
    args = ap.parse_args(argv)
    production = args.production_mesh and not args.reduced

    cfg = get_arch(args.arch)
    shape = get_shape(args.shape)
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig("reduced_train", seq_len=128, global_batch=8, kind="train")

    mesh, started = None, False
    try:
        if args.distributed or production:
            import torch.distributed as dist

            from .mesh import make_local_mesh, make_production_mesh

            dev = resolve_device(args.device)
            if not dist.is_initialized():
                if dev.type == "cuda":
                    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
                dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
                started = True
            if production:
                mesh = make_production_mesh(multi_pod=args.multi_pod, device_type=dev.type)
            else:
                mesh = make_local_mesh(device_type=dev.type)
        trainer = Trainer(
            cfg, shape, mesh,
            TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir),
            opt_cfg=optim.AdamWConfig(
                lr=optim.warmup_cosine(3e-4, warmup=min(100, args.steps // 10 + 1), total=args.steps),
                state_dtype=cfg.optim_state_dtype,
            ),
            device=args.device,
        )
        out = trainer.train()
    finally:
        if started:
            dist.destroy_process_group()
    print(f"finished at step {out['step']}; stragglers={out['stragglers']} failures={out['failures']}")
    return out


if __name__ == "__main__":
    main()
