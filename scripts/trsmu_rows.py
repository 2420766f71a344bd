#!/usr/bin/env python3
"""TRSMU's rows a CTA on the card: the kernel of
``src/repro_torch/kernels/csrc/tile_lu_sm90.cu`` timed at 16 and at 32 rows
of B a CTA, on the same inputs, through the port's own wrapper
(``tile_linalg.grid_trsmu`` under ``chip_smoke.forced_shape``).

    python3 scripts/trsmu_rows.py

Cases, all 128 x 128 tiles:

- the LU plan's TRSMU group (n = 4096, 32 x 32 partitions: 31 tasks);
- the served stacked group (n = 1024, 8 x 8: 7 tasks over 64 lanes);
- unstacked groups of 4 to 448 tasks on packed L\\U tiles, the sizes around
  the point where 32 rows a CTA first gives every SM a CTA.

Each case is timed in the order 16, 32, 32, 16 rows (``cuda_ms_fresh``: the
written blocks put back before each call) and checked against the plain
version at each.  The card's name and power limit and its SM count head the
output.  Needs one card."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SWEEP = (4, 8, 16, 24, 31, 33, 48, 64, 128, 448)
ROWS = (16, 32, 32, 16)


def timed(torch, cs, tl, idxs, grids, slots) -> list:
    """ms of one grid_trsmu call at each of ROWS, each result checked."""
    w = slots[1]
    wr, wc = idxs[1].long().unbind(1)
    stacked = grids[w].dim() == 5
    fresh = grids[w][:, wr, wc] if stacked else grids[w][wr, wc]
    want = [g.clone() for g in grids]
    tl.grid_trsmu_plain(idxs, [want[s] for s in slots])
    out = []
    for rows in ROWS:
        work = [g.clone() for g in grids]

        def put():
            if stacked:
                work[w][:, wr, wc] = fresh
            else:
                work[w].index_put_((wr, wc), fresh)

        with cs.forced_shape(tl, rows):
            run = lambda: tl.grid_trsmu(idxs, [work[s] for s in slots])
            run()
            torch.cuda.synchronize()
            cs.close(work[w], want[w], cs.TOL["trsmu"])
            out.append(cs.cuda_ms_fresh(run, put, 20))
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("trsmu_rows: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import dd_matrix
    from repro_torch.core.data import to_grid
    from repro_torch.kernels import tile_linalg as tl
    from repro_torch.linalg import GETRF

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout.strip())
    print(f"sms={torch.cuda.get_device_properties(0).multi_processor_count}")
    b = cs.N // cs.P
    for n, parts, lanes in ((cs.N, cs.P, None), (cs.SN, cs.SP, cs.LANES)):
        groups = cs.plan_groups(GETRF, [((n, n), ((parts, parts),))])
        g = max((g for g in groups if g.op.name == "trsmu" and len(g.segments) == 1), key=lambda g: g.size)
        grid = (to_grid(dd_matrix(n, seed=1), b, b) if lanes is None
                else cs.lane_grids(torch, dd_matrix, n, b, lanes))
        idxs = [torch.from_numpy(ix).cuda() for ix in g.idxs]
        ms = timed(torch, cs, tl, idxs, [grid], g.segments[0][0])
        label = f"plan group {g.size} tasks" + ("" if lanes is None else f" x {lanes} lanes")
        print(f"trsmu {label}: " + " ".join(f"rows{r}={t:.4f}" for r, t in zip(ROWS, ms)) + " ms")
    rng = np.random.default_rng(0)
    for n in SWEEP:
        u = torch.from_numpy(cs.packed_lu_tiles(rng, n, b)).cuda().view(n, 1, b, b)
        x = torch.from_numpy(rng.standard_normal((n, 1, b, b)).astype(np.float32) * 0.3).cuda()
        ix = torch.stack([torch.arange(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)], 1).cuda()
        ms = timed(torch, cs, tl, [ix, ix], [u, x], (0, 1))
        print(f"trsmu sweep {n} tasks: " + " ".join(f"rows{r}={t:.4f}" for r, t in zip(ROWS, ms)) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
