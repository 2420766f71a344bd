"""Training entry point (the JAX package's ``launch/train.py``).

    python -m repro_torch.launch.train --arch qwen3-32b --shape train_4k \\
        --steps 1000 --ckpt-dir DIR --ckpt-every 100 [--reduced] [--device cpu]

Runs ``Trainer`` (the captured step, async checkpoints, resume) on one
device, CUDA unless ``--device`` names another.  ``--reduced`` trains the
reduced configuration at sequence 128, batch 8 (the reference's CPU
harness shape); without it, the published configuration at ``--shape``.
The reference's ``--production-mesh``, ``--multi-pod`` and
``--distributed`` (multi-chip meshes) are ROADMAP A12.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from .. import optim
from ..configs import get_arch, get_shape
from ..configs.base import ShapeConfig
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
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    shape = get_shape(args.shape)
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig("reduced_train", seq_len=128, global_batch=8, kind="train")

    trainer = Trainer(
        cfg, shape, None,
        TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir),
        opt_cfg=optim.AdamWConfig(
            lr=optim.warmup_cosine(3e-4, warmup=min(100, args.steps // 10 + 1), total=args.steps),
            state_dtype=cfg.optim_state_dtype,
        ),
        device=args.device,
    )
    out = trainer.train()
    print(f"finished at step {out['step']}; stragglers={out['stragglers']} failures={out['failures']}")
    return out


if __name__ == "__main__":
    main()
