#!/usr/bin/env python3
"""Where TRSML's time goes on the card: the kernel of
``src/repro_torch/kernels/csrc/tile_lu_sm90.cu`` timed whole and with parts
removed, at the LU plan's TRSML group (31 tasks of 128 x 128, bc = 128),
the served stacked group (7 tasks over 64 lanes) and the vector solve's
one-task bc = 1 group, each at the launch shape the wrapper chooses.

    python3 scripts/trsml_anatomy.py

Each variant is the committed source with code removed, never added:

- ``full``: the kernel as committed;
- ``empty``: the kernel returns at once (launch and timing events alone);
- ``stage_only``: L's panels and B staged and X written back, no solve;
- ``no_inblock``: no substitution inside the 16-row blocks;
- ``no_update``: no block update by the rows before the block.

Only ``full`` computes the right result; the others are timed and nothing
else.  Each variant builds with ``nvcc`` into ``build/trsml_anatomy/`` and
is called through the port's own wrapper (``tile_linalg.grid_trsml``) on
packed L\\U tiles with 0.3-scale Gaussian right-hand sides, timed by
``chip_smoke.cuda_ms_fresh`` in the order of the variants and back.  The
card's name and power limit head the output.  Needs one card."""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

B = 128
CASES = ((31, None, 128), (7, 64, 128), (1, None, 1))  # tasks, lanes, bc

KERNEL_START = "  constexpr int kCols = kHalfWarps * kColsPerHalfWarp;\n  extern __shared__"
SOLVE = "  trsml_columns<kColsPerHalfWarp>(P, X, b, cols, ldx);\n"
INBLOCK = "    unit_lower_block(x, lr + I0, r, w);\n"
UPDATE = "    for (int k = 0; k < I0; k += 4) {\n      const float4 l ="


def cut(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"trsml_anatomy: expected one match of {old[:40]!r}, found {src.count(old)}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    return {
        "full": src,
        "empty": cut(src, KERNEL_START, "  if (b > 0) return;\n" + KERNEL_START),
        "stage_only": cut(src, SOLVE, ""),
        "no_inblock": cut(src, INBLOCK, ""),
        "no_update": cut(src, UPDATE, UPDATE.replace("k < I0", "k < 0")),
    }


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("trsml_anatomy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import tile_linalg as tl

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout.strip())
    out = ROOT / "build" / "trsml_anatomy"
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
        fn = ctypes.CDLL(str(out / f"{name}.so")).tile_trsml
        fn.argtypes, fn.restype = tl._ARGTYPES["trsml"], ctypes.c_int
        fns[name] = fn

    rng = np.random.default_rng(0)
    for n, lanes, bc in CASES:
        lead = () if lanes is None else (lanes,)
        lt = torch.from_numpy(cs.packed_lu_tiles(rng, n * (lanes or 1), B)).cuda().view(*lead, n, 1, B, B)
        x0 = torch.from_numpy(rng.standard_normal((*lead, n, 1, B, bc)).astype(np.float32) * 0.3).cuda()
        ix = torch.stack([torch.arange(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)], 1).cuda()
        work = x0.clone()
        times = {}
        for name in [*fns, *reversed(fns)]:
            tl._FNS["trsml"] = fns[name]
            times.setdefault(name, []).append(
                cs.cuda_ms_fresh(lambda: tl.grid_trsml([ix, ix], [lt, work]), lambda: work.copy_(x0), 20))
        shape = tl.launch_shape("trsml", [(B, B), (B, bc)], n, lanes or 1, tl.sm_count(lt.device))[0]
        label = f"{n} tasks" + ("" if lanes is None else f" x {lanes} lanes") + f" bc={bc}, {shape} columns a CTA"
        print(f"trsml {label}: " + " ".join(f"{k}={'/'.join(f'{t:.4f}' for t in v)}" for k, v in times.items())
              + " ms")
    tl._FNS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
