#!/usr/bin/env python3
"""The nine tile kernels' times at chip_smoke.py's 2b and 2d groups, in two
trees on one card, alternating: the other tree, this one, this one, the
other (each side in a process of its own, building its own library).

    python3 scripts/tile_kernels_ab.py OTHER_ROOT

``OTHER_ROOT`` is another checkout of the repository, for example the
parent commit unpacked into a directory that ``.gitignore`` lists (the card's
copy of the repository has no ``.git``, so unpack it before the call)::

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 scripts/tile_kernels_ab.py build/parent

Each run prints one ``AB <side> {...}`` line of kernel milliseconds, keyed as
chip_smoke.py's 2b entries (``gemmnn``, ``gemmnn_vector``, ...) and its 2d
entries with ``_stacked`` appended; the last lines give each key's two sides
(mean of their runs) and the ratio.  Only times taken in one call compare:
two calls may land on two cards.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_side(root: Path, label: str) -> None:
    """2b's and 2d's kernel times of the tree at ``root``, as an AB line."""
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import tile_linalg as tl

    if not torch.cuda.is_available():
        raise SystemExit("tile_kernels_ab: no CUDA device; this script runs on the card only")
    _build.build(["tile_lu_sm90"])
    rng = np.random.default_rng(0)
    times = {k: v["ms"] for k, v in cs.kernel_timings(torch, tl).items()}
    times.update({f"{k}_stacked": v["ms"] for k, v in cs.stacked_timings(torch, tl, rng).items()})
    print("AB", label, json.dumps(times), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--side":
        one_side(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    runs = {"other": [], "this": []}
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--side", str(root), label],
                             capture_output=True, text=True, timeout=900)
        line = next((x for x in out.stdout.splitlines() if x.startswith("AB ")), None)
        if out.returncode or line is None:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        print(line, flush=True)
        runs[label].append(json.loads(line.split(" ", 2)[2]))
    for key in runs["this"][0]:
        a = sum(r[key] for r in runs["other"]) / len(runs["other"])
        b = sum(r[key] for r in runs["this"]) / len(runs["this"])
        print(f"{key}: other {a:.4f} ms, this {b:.4f} ms, this / other {b / a:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
