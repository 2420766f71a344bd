#!/usr/bin/env python3
"""Where GEMMNN's time goes on the card: the tensor-core kernel of
``src/repro_torch/kernels/csrc/tile_lu_sm90.cu`` timed whole and with parts
removed, at the LU plan's largest group (n = 4096, 32 x 32 partitions: 961
tasks of 128^3) and at the served stacked group (n = 1024, 8 x 8, 49 tasks
over 64 lanes), under each output tile the wrapper may choose.

    python3 scripts/gemmnn_anatomy.py

Each variant is the committed source with code removed, never added:

- ``full``: the kernel as committed;
- ``no_products``: no mma and no promotion of the partials (the operand
  splits then go too): staging, C in and out;
- ``c_only``: ``no_products`` without the A/B staging: C read and written;
- ``ab_only``: ``no_products`` without reading C: A/B staged, C written.

Only ``full`` computes the right result; the others are timed and nothing
else.  Each variant builds with ``nvcc`` into ``build/anatomy/`` and is
called through the port's own wrapper (``tile_linalg.grid_gemmnn``).  The
card's name and power limit head the output.  Needs one card."""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

MMA_LOOP = re.compile(r"#pragma unroll\n\s*for \(int i = 0; i < FM; \+\+i\)\n#pragma unroll\n\s*for \(int j = 0; j < FN; "
                      r"\+\+j\) mma_tf32(?:<[^>]*>)?\(part\[i\]\[j\], \w+\[i\], \w+\[j\]\);\n")
PROMOTE = re.compile(r"promote\(acc, part\);")
STAGING = re.compile(r"if \((?:ch|next) < nchunks\)\s*stage_chunk<kTile, kBT>\([^;]*;")
C_READ = re.compile(r"if \(vec\) \{(?:  //[^\n]*)?\n\s*if \(r < m && c < q\) cv = [^\n]*\n\s*\} else \{\n[^\n]*\n[^\n]*\n\s*\}\n")


def cut(src: str, pattern: re.Pattern, count: int, repl: str = "") -> str:
    out, n = pattern.subn(repl, src)
    if n != count:
        raise SystemExit(f"gemmnn_anatomy: expected {count} match(es) of {pattern.pattern[:40]!r}, found {n}")
    return out


def variants(src: str) -> dict:
    no_products = cut(cut(src, MMA_LOOP, 3), PROMOTE, 1)
    return {
        "full": src,
        "no_products": no_products,
        "c_only": cut(no_products, STAGING, 2),
        "ab_only": cut(no_products, C_READ, 1),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gemmnn_anatomy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import dd_matrix
    from repro_torch.core.data import to_grid
    from repro_torch.kernels import _build
    from repro_torch.kernels import tile_linalg as tl
    from repro_torch.linalg import GETRF

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout.strip())
    out = ROOT / "build" / "anatomy"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants((_build.CSRC / "tile_lu_sm90.cu").read_text()).items():
        (out / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the {name} variant:\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).tile_gemmnn
        fn.argtypes, fn.restype = tl._ARGTYPES["gemmnn"], ctypes.c_int
        fns[name] = fn

    b = cs.N // cs.P
    cases = []
    for n, parts, lanes in ((cs.N, cs.P, None), (cs.SN, cs.SP, cs.LANES)):
        groups = cs.plan_groups(GETRF, [((n, n), ((parts, parts),))])
        g = max((g for g in groups if g.op.name == "gemmnn" and len(g.segments) == 1), key=lambda g: g.size)
        grid = (to_grid(dd_matrix(n, seed=1), b, b) if lanes is None
                else cs.lane_grids(torch, dd_matrix, n, b, lanes))
        idxs = [torch.from_numpy(ix).cuda() for ix in g.idxs]
        label = f"{g.size} tasks" + ("" if lanes is None else f" x {lanes} lanes")
        cases.append((label, idxs, grid, g.segments[0][0]))
    for label, idxs, grid, slots in cases:
        for tile in cs.SHAPES["gemmnn"][1:]:
            times = []
            for name, fn in fns.items():
                tl._FNS["gemmnn"] = fn
                work = [grid.clone()]
                with cs.forced_shape(tl, tile):
                    ms = cs.cuda_ms(lambda: tl.grid_gemmnn(idxs, [work[s] for s in slots]), 20)
                times.append(f"{name}={ms:.4f}")
            print(f"gemmnn {label}, tile {tile}: " + " ".join(times) + " ms")
    tl._FNS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
