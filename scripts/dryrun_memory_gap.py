"""Where the card's peak of one eager train step exceeds the dry run's count.

Runs starcoder2-7b's train plan (published widths, ``--layers`` of them,
``--batch`` x ``--seq``; no mesh) once eagerly on the card under two
dispatch modes: ``launch.dryrun.LiveBytes`` (the dry run's count of live
bytes, with its modelled kernel workspaces, here on real tensors) and a
probe that reads the caching allocator around every op (its peak inside
the op, reset before it, and what it holds after).  Prints both peaks, how
far the allocator's holdings drift from LiveBytes' count between ops, and
the ops whose kernels allocate most beyond their outputs (the allocator's
peak inside the op over what it holds before and after), beside the
workspace ``launch.dryrun.workspace`` models for them.

    python scripts/dryrun_memory_gap.py [--layers 2] [--batch 4] [--seq 4096]     # on the card
"""

import argparse
import collections
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def main(argv=None) -> dict:
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset, sharded_batches
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    ap = argparse.ArgumentParser(prog="dryrun_memory_gap.py")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dryrun_memory_gap.py reads the card's allocator: it runs on the card only")

    cfg = dataclasses.replace(get_arch("starcoder2-7b"), n_layers=args.layers)
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    opt_cfg = optim.AdamWConfig(state_dtype=cfg.optim_state_dtype)
    plan = st.make_train_step(cfg, None, shape, opt_cfg, device="cuda")
    p, o = st.train_state(plan, build_model(cfg, seed=0, device="cuda", train=True).train_params(), opt_cfg)
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len, global_batch=shape.global_batch))
    batch = next(sharded_batches(ds, "cuda"))
    torch.cuda.synchronize()
    rec = []  # (op, allocated before, peak inside, allocated after, LiveBytes' count after, its workspace)

    class Probe(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = func(*args, **(kwargs or {}))
            rec.append((str(func), before, torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated(),
                        live.live, dryrun.workspace(func, args)))
            return out

    live = dryrun.LiveBytes()
    live.track(leaves((p, o, batch)))
    start = torch.cuda.memory_allocated()
    with live, Probe():
        plan.fn(p, o, batch)
    torch.cuda.synchronize()
    peak = max(rec, key=lambda r: r[2])
    drift = [r[3] - r[4] for r in rec]
    hidden = collections.Counter()
    modelled = {}
    for r in rec:
        h = r[2] - max(r[1], r[3])
        if h > hidden[r[0]]:
            hidden[r[0]], modelled[r[0]] = h, r[5]
    lines = [
        f"starcoder2-7b {args.layers} layers, B={args.batch} S={args.seq}: {len(rec)} ops; allocated before the "
        f"step {start / 1e9:.3f} GB",
        f"card peak {peak[2] / 1e9:.3f} GB at {peak[0]}; LiveBytes peak {live.peak / 1e9:.3f} GB "
        f"(ratio {live.peak / peak[2]:.4f})",
        f"allocator holdings less LiveBytes' count between ops: min {min(drift) / 1e9:.3f} max {max(drift) / 1e9:.3f} "
        f"GB",
    ]
    for op, h in hidden.most_common(6):
        lines.append(f"  inside {op}: {h / 1e9:.3f} GB beyond its outputs (modelled {modelled[op] / 1e9:.3f})")
    for line in lines:
        print(line)
    return {"lines": lines, "card_peak": peak[2], "live_peak": live.peak}


if __name__ == "__main__":
    main()
