"""Readings that set a cell's limits: the program's compared numbers over
many seeds and the control's, in one process (one set-up).

    python3 perfbench/control.py --workload lu-stream --seeds 11,12,13 --seconds 3

For each seed it makes the cell's inputs anew, drives the program through
the cell's own driver for ``--seconds`` (the timed path, at the cell's
sizes and load), and prints the program's numbers, then the control's: the
plain reference put in the program's place on the same inputs, computed
one precision step below what the configuration states (float32 with TF32
products, where the configuration states float32 with TF32 off), and the
reference in plain float32 for comparison.  A limit lies above every
program reading and below every control reading.  The benchmark's own runs
do not run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", type=int, default=3, help="seeds (the first) that also read the control")
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [q for q in sys.path if Path(q or ".").resolve() != HERE]

    import torch

    from perfbench import manifest as mf
    from perfbench.device import Device
    from perfbench.harness import Context, compare
    from perfbench.registry import Registry

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    reg = Registry()
    cell = mf.cell(mf.load(ROOT), args.workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    op = reg.operation(cfg["operation"])
    driver = reg.driver(traffic["driver"])
    device = torch.device("cuda", 0)
    ctx = Context(cfg, traffic, op, reg, device, Device(device), seeds[0], args.seconds)
    driver.prepare(ctx)
    print(f"{args.workload} on {torch.cuda.get_device_name(device)}: set-up {time.perf_counter() - T0:.1f} s",
          flush=True)
    for n, seed in enumerate(seeds):
        ctx.seed = seed
        driver.inputs(ctx)
        t0 = time.perf_counter()
        rec = driver.run(ctx, args.seconds, False)
        answers, rec.answers = rec.answers, []
        line = [f"seed {seed}: answers {len(answers)} failed {rec.failed} (window {time.perf_counter() - t0:.1f} s)",
                f"program {compare(ctx, answers)}"]
        if n < args.controls:
            line += [f"{precision} {compare(ctx, answers, precision)}" for precision in ("tf32", "float32")]
        print("; ".join(line), flush=True)
        del answers
    return 0


if __name__ == "__main__":
    sys.exit(main())
