"""The knee of a served cell: its open loop at a rising series of fixed
rates in one process (one set-up), to find the highest rate whose backlog
stays bounded through the window.  The rate a cell runs at is then fixed in
its traffic file; nothing here runs in the benchmark's own runs.

    python3 perfbench/sweep.py --workload lu-served --seed 7 --seconds 40 --rates 300,350,400,450

Give it the cell's own window.  For each rate it prints the requests due
and answered, the answers a second (first due to last ready), the p50 and
p95 of due-to-ready latency, and the median latency of the first and the
last fifth of the requests by due time: a backlog that grows through the window
shows as a last fifth far above the first, and the sweep stops after the
first rate whose last fifth reads over twice its first (above the knee the
queue, and the inputs it holds on the card, grow without end).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True, help="requests a second, comma-separated, rising")
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [q for q in sys.path if Path(q or ".").resolve() != HERE]

    import numpy as np
    import torch

    from perfbench import manifest as mf
    from perfbench.device import Device
    from perfbench.harness import Context
    from perfbench.reduce import p95
    from perfbench.registry import Registry

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    rates = [float(r) for r in args.rates.split(",")]
    reg = Registry()
    cell = mf.cell(mf.load(ROOT), args.workload)
    cfg, traffic = reg.config(cell["config"]), dict(reg.traffic(cell["traffic"]))
    traffic["rate"] = max(rates)
    device = torch.device("cuda", 0)
    ctx = Context(cfg, traffic, reg.operation(cfg["operation"]), reg, device, Device(device), args.seed,
                  args.seconds)
    driver = reg.driver(traffic["driver"])
    driver.prepare(ctx)
    print(f"{args.workload}: set-up {time.perf_counter() - T0:.1f} s; {torch.cuda.get_device_name(device)}")
    rng = np.random.default_rng([args.seed, 5])
    for rate in rates:
        ctx.due = driver.schedule(round(rate * args.seconds), args.seconds, rng)
        rec = driver.run(ctx, args.seconds, False)
        lat = rec.latencies_ms
        fifth = max(1, len(lat) // 5)
        first, last = statistics.median(lat[:fifth]), statistics.median(lat[-fifth:])
        print(f"rate {rate:g}/s: due {rec.attempted} answered {rec.completed} failed {rec.failed} "
              f"answered/s {rec.completed / rec.window_s:.1f} "
              f"p50 {statistics.median(lat):.3f} ms p95 {p95(lat):.3f} ms first fifth {first:.3f} ms "
              f"last fifth {last:.3f} ms lanes/drain {rec.resolved / max(rec.drains, 1):.2f} "
              f"host ms/request {rec.host_request_s / max(rec.completed, 1) * 1e3:.3f}", flush=True)
        rec.answers.clear()
        if last > 2 * first:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
