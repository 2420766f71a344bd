"""End-to-end LM training with the PyTorch port: data pipeline -> train
step (one captured CUDA graph on the card) -> async checkpoints ->
fault-tolerant loop, on any of the ten assigned architectures (reduced or
100m preset; the counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py --arch qwen3-32b --steps 300          # on the card
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --device cpu

Presets:
    reduced  the arch's CPU smoke config (default; runs anywhere)
    100m     a ~100M-param qwen3-family config, float32 compute, no remat

The loop is the production ``Trainer``: resumable (run the same command
again after killing it and it continues from the last checkpoint in
``--ckpt-dir``), failure-injectable (``--inject-failure N`` fails step N
once), straggler-tracked.
"""

import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch


def preset_100m(base):
    """~100M-param qwen3-family config (exact count printed at start)."""
    return dataclasses.replace(
        base,
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv=4,
        head_dim=64,
        d_ff=2048,
        vocab=32768,
        compute_dtype=torch.float32,
        remat="none",
        scan_layers=True,
    )


def main(argv=None) -> dict:
    """Returns the printed lines and the trainer's result (steps, metrics,
    stragglers, failures)."""
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import param_counts
    from repro_torch.train import Trainer, TrainerConfig

    ap = argparse.ArgumentParser(prog="torch_train_lm.py")
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--preset", default="reduced", choices=["reduced", "100m"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--inject-failure", type=int, default=-1)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    cfg = preset_100m(cfg) if args.preset == "100m" else cfg.reduced()
    n = param_counts(cfg)["total"]
    lines = [f"arch={cfg.name} preset={args.preset}: {n / 1e6:.1f}M params"]
    print(lines[-1])

    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch, kind="train")
    trainer = Trainer(
        cfg, shape, None,
        TrainerConfig(steps=args.steps, ckpt_every=max(args.steps // 4, 10), ckpt_dir=args.ckpt_dir, log_every=10),
        opt_cfg=optim.AdamWConfig(lr=optim.warmup_cosine(args.lr, warmup=20, total=args.steps)),
        device=args.device,
    )
    fail = {args.inject_failure} if args.inject_failure >= 0 else set()

    def inject(step):
        if step in fail:
            fail.discard(step)
            return True
        return False

    out = trainer.train(inject_failure=inject)
    first = out["metrics"][0]["loss"] if out["metrics"] else float("nan")
    last = out["metrics"][-1]["loss"] if out["metrics"] else float("nan")
    lines.append(f"done: {out['step']} steps, loss {first:.3f} -> {last:.3f}, "
                 f"stragglers={out['stragglers']} failures={out['failures']}")
    print(lines[-1])
    return {"lines": lines, **out}


if __name__ == "__main__":
    main()
