#!/usr/bin/env python3
"""TRSML's columns a CTA on the card: the kernel of
``src/repro_torch/kernels/csrc/tile_lu_sm90.cu`` timed at 16 and at 32
columns of B a CTA, on the same inputs, through the port's own wrapper
(``tile_linalg.grid_trsml`` under ``chip_smoke.forced_shape``).

    python3 scripts/trsml_cols.py [--compare OTHER.cu]

``--compare`` also times a source that exports the simple kernel's C entry
``tile_trsml`` (no launch-shape argument), such as the parent commit's
``tile_linalg.cu`` (``git show 58d39dd:src/repro_torch/kernels/csrc/
tile_linalg.cu > build/trsml_cols/simple.cu`` before the chip call: the
card's copy has no ``.git``); it is built with ``nvcc`` into
``build/trsml_cols/``.

Cases, all on 128 x 128 packed L\\U tiles with 0.3-scale Gaussian
right-hand sides, one block a task (identity indices):

- 31 tasks, bc = 128 (the LU plan's TRSML group at n = 4096, 32 x 32);
- 7 tasks x 64 lanes, bc = 128 (the served LU template's group);
- 1 task, bc = 1 (each of the vector solve's 32 launches at n = 4096);
- 1 task x 64 lanes, bc = 1 (the served vector solve's groups);
- 1 task, bc = 8 and 15;
- a sweep: 1 to 128 tasks at bc = 128, and bc = 16 to 64 at 1 and 31
  tasks, around the point where 32 columns a CTA first give every SM a CTA.

Each case is timed in the order compare, shapes, shapes reversed, compare
(``cuda_ms_fresh``: the written blocks put back before each call) and every
result is checked against the plain version.  The card's name and power
limit head the output.  Needs one card."""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

B = 128
CASES = ((31, None, 128), (7, 64, 128), (1, None, 1), (1, 64, 1), (1, None, 8), (1, None, 15),
         *((n, None, 128) for n in (1, 2, 4, 8, 16, 24, 33, 48, 64, 128)),
         *((n, None, bc) for n in (1, 31) for bc in (16, 24, 32, 40, 64)))


def simple_entry(src: Path):
    """``tile_trsml`` of ``src`` built into build/trsml_cols/, its argument
    types declared: per argument grid, nc, idx, lane stride; n, batch, b,
    bc; stream."""
    from repro_torch.kernels import _build

    out = ROOT / "build" / "trsml_cols" / f"{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)], check=True)
    fn = ctypes.CDLL(str(out)).tile_trsml
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, i, vp, ll] * 2 + [i] * 4 + [vp]
    fn.restype = i
    return fn


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--compare", type=Path, help="a source exporting the simple kernel's tile_trsml")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trsml_cols: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import tile_linalg as tl

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout.strip())
    other = simple_entry(args.compare) if args.compare else None
    rng = np.random.default_rng(0)
    for n, lanes, bc in CASES:
        lead = () if lanes is None else (lanes,)
        count = n * (lanes or 1)
        lt = torch.from_numpy(cs.packed_lu_tiles(rng, count, B)).cuda().view(*lead, n, 1, B, B)
        x0 = torch.from_numpy(rng.standard_normal((*lead, n, 1, B, bc)).astype(np.float32) * 0.3).cuda()
        ix = torch.stack([torch.arange(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)], 1).cuda()
        want = x0.clone()
        tl.grid_trsml_plain([ix, ix], [lt, want])
        work = x0.clone()

        def put():
            work.copy_(x0)

        runs = []
        if other is not None:
            def simple():
                stream = torch.cuda.current_stream().cuda_stream
                err = other(lt.data_ptr(), 1, ix.data_ptr(), lt.stride(0) if lanes else 0, work.data_ptr(), 1,
                            ix.data_ptr(), work.stride(0) if lanes else 0, n, lanes or 1, B, bc, stream)
                if err:
                    raise RuntimeError(f"simple tile_trsml failed: CUDA error {err}")

            runs.append(("simple", simple))
        for shape in cs.SHAPES["trsml"]:
            def kernel(shape=shape):
                with cs.forced_shape(tl, shape):
                    tl.grid_trsml([ix, ix], [lt, work])

            runs.append((f"cols{shape}", kernel))
        order = runs + runs[::-1]
        times = {}
        for label, run in order:
            put()
            run()
            torch.cuda.synchronize()
            cs.close(work, want, cs.TOL["trsml"])
            times.setdefault(label, []).append(cs.cuda_ms_fresh(run, put, 20))
        chosen = tl.launch_shape("trsml", [(B, B), (B, bc)], n, lanes or 1, tl.sm_count(lt.device))[0]
        label = f"{n} tasks" + ("" if lanes is None else f" x {lanes} lanes") + f" bc={bc}"
        print(f"trsml {label} (wrapper's shape {chosen}): "
              + " ".join(f"{k}={'/'.join(f'{t:.4f}' for t in v)}" for k, v in times.items()) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
