"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on the machine that holds the card(s) the cell
asks for.  Prints one JSON line last on standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks`` last), and each compared number beside its
limit as the last lines of standard error.  Exits non-zero, printing no
result, without CUDA or with fewer cards than the cell asks for, and when a
JAX module or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache inside the checkout, at fixed paths: only a
# checkout's first run builds (the port's nvcc libraries already go to
# build/repro_torch/)
CACHES = {
    "TRITON_CACHE_DIR": ROOT / "build" / "triton",
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
    "TORCHINDUCTOR_CACHE_DIR": ROOT / "build" / "inductor",
    "CUDA_CACHE_PATH": ROOT / "build" / "cuda_cache",
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    # the script's own folder off the path (its modules load as perfbench.*,
    # never under bare names such as ``trace``), the checkout and the port on
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [q for q in sys.path if Path(q or ".").resolve() != HERE]

    import torch

    from perfbench import harness
    from perfbench import manifest as mf
    from perfbench.registry import Registry

    m = mf.load(ROOT)
    cell = mf.cell(m, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has {have}", file=sys.stderr)
        return 3
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
        print(f"card: {card}", file=sys.stderr)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"card: nvidia-smi not read ({e})", file=sys.stderr)
    result = harness.run_cell(m, Registry(), args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
