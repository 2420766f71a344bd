#!/usr/bin/env python3
"""TRSM's and TRSMUL's division on the card: the committed kernels of
``src/repro_torch/kernels/csrc/tile_lu_sm90.cu``, whose in-block
substitution divides by the diagonal with ``div_rn`` (the reciprocal taken
once a block, then Markstein's correction of each quotient), beside the same
source with ``div_rn`` turned into the plain division ``a / d``, built with
``nvcc`` into ``build/solve_division/``.

    python3 scripts/solve_division.py

Both run through the port's own wrappers (the variant's C entries put in
place of the committed ones in ``tile_linalg._FNS``), on the same inputs:

- bit for bit: every result of the two builds must be equal (``div_rn``
  returns IEEE's quotient), at b = 8 ... 128 and the ragged 96 and 120,
  right-hand-side widths 1, 3, 40 and b for TRSMUL, under both launch shapes,
  unstacked and over 3 lanes; each also within ``chip_smoke.TOL`` of the
  plain version;
- times, in the order plain division, div_rn, div_rn, plain division
  (``chip_smoke.kernel_timing``: the written blocks put back before each
  call), at the groups chip_smoke.py times: TRSM at the n = 4096, 32 x 32
  Cholesky plan's 31-task and 1-task groups, TRSMUL at the matrix-RHS LU
  solve plan's 4-task group and the vector solve plan's one-task bc = 1
  group.

The card's name and power limit head the output.  Needs one card."""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

KERNELS = ("trsm", "trsmul")
DIV_RN_BODY = "  const float q = __fmul_rn(a, dinv);\n  return __fmaf_rn(__fmaf_rn(-d, q, a), dinv, q);\n"


def plain_division_entries(tl) -> dict:
    """``tile_trsm`` and ``tile_trsmul`` of the committed source with
    ``div_rn`` returning ``a / d``, argument types declared."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "tile_lu_sm90.cu").read_text()
    if src.count(DIV_RN_BODY) != 1:
        raise RuntimeError("div_rn's body is not the one this script rewrites")
    out = ROOT / "build" / "solve_division" / "libplain_division.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    variant = out.with_name("plain_division.cu")
    variant.write_text(src.replace(DIV_RN_BODY, "  return a / d;\n"))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(variant)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    fns = {}
    for name in KERNELS:
        fn = getattr(lib, f"tile_{name}")
        fn.argtypes = tl._ARGTYPES[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


class entries:
    """Within the block, the wrappers launch ``fns``' kernels."""

    def __init__(self, tl, fns: dict):
        self.tl, self.fns = tl, fns

    def __enter__(self):
        self.tl._kernel_fn(KERNELS[0])  # the committed library loaded, its entries in _FNS
        self.saved = {k: self.tl._FNS[k] for k in KERNELS}
        self.tl._FNS.update(self.fns)

    def __exit__(self, *exc):
        self.tl._FNS.update(self.saved)


def bitwise_checks(torch, tl, cs, plain_fns, rng) -> int:
    """Both builds on the same grids, every launch shape; returns the cases run."""
    cases = 0
    for b in (*cs.TILES, *cs.RAGGED):
        for name in KERNELS:
            for bc in sorted({1, 3, 40 if b >= 40 else b, b}) if name == "trsmul" else [b]:
                shapes = tl.tile_shapes(name, b, bc)
                for shape in cs.SHAPES[name]:
                    for lanes in (None, 3):
                        grids, which, idxs = cs.grid_case(tl, name, rng, shapes, lanes=lanes)
                        ix = [torch.from_numpy(i).cuda() for i in idxs]
                        g0 = [torch.from_numpy(g).cuda() for g in grids]
                        out = []
                        for fns in (None, plain_fns):
                            g = [x.clone() for x in g0]
                            with cs.forced_shape(tl, shape):
                                if fns is None:
                                    getattr(tl, f"grid_{name}")(ix, [g[k] for k in which])
                                else:
                                    with entries(tl, fns):
                                        getattr(tl, f"grid_{name}")(ix, [g[k] for k in which])
                            out.append(g)
                        want = [x.clone() for x in g0]
                        getattr(tl, f"grid_{name}_plain")(ix, [want[k] for k in which])
                        torch.cuda.synchronize()
                        for x, y, z in zip(*out, want):
                            cs.close(x, z, cs.TOL[name])
                            if not torch.equal(x, y):
                                raise AssertionError(f"{name} b={b} bc={bc} shape={shape} lanes={lanes}: div_rn and "
                                                     f"a / d differ by {(x - y).abs().max().item():.3e}")
                        cases += 1
    return cases


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("solve_division: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import dd_matrix, spd_matrix
    from repro_torch.core.data import to_grid
    from repro_torch.kernels import tile_linalg as tl
    from repro_torch.linalg import LUSOLVE, POTRF

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout.strip())
    plain_fns = plain_division_entries(tl)
    print(f"bit for bit: {bitwise_checks(torch, tl, cs, plain_fns, np.random.default_rng(0))} cases, div_rn equal "
          f"to a / d in every one")

    N, P, b = cs.N, cs.P, cs.N // cs.P
    a_spec = ((N, N), ((P, P),))
    chol = cs.plan_groups(POTRF, [a_spec])
    solve = cs.plan_groups(LUSOLVE, [a_spec, ((N, cs.RHS), ((P, cs.RHS_P),))])
    vec = cs.plan_groups(LUSOLVE, [a_spec, ((N, 1), ((P, 1),))])
    spd = [to_grid(spd_matrix(N, seed=1), b, b)]
    dd = [to_grid(dd_matrix(N, seed=1), b, b)]
    rhs = to_grid(0.3 * torch.randn(N, cs.RHS, generator=torch.Generator().manual_seed(1)).cuda(), b,
                  cs.RHS // cs.RHS_P)
    vrhs = to_grid(0.3 * torch.randn(N, 1, generator=torch.Generator().manual_seed(3)).cuda(), b, 1)
    groups = (("trsm", chol, spd, " (31 tasks)", None), ("trsm", chol, spd, " (1 task)", lambda g: g.size == 1),
              ("trsmul", solve, dd + [rhs], " (solve, 4 tasks)", None),
              ("trsmul", vec, dd + [vrhs], " (vector solve)", lambda g: g.size == 1))
    for name, plan, grids, label, pick in groups:
        times = {"a / d": [], "div_rn": []}
        for which in ("a / d", "div_rn", "div_rn", "a / d"):
            if which == "div_rn":
                t = cs.kernel_timing(torch, tl, name, plan, grids, pick=pick, label=f"{label} div_rn")
            else:
                with entries(tl, plain_fns):
                    t = cs.kernel_timing(torch, tl, name, plan, grids, pick=pick, label=f"{label} a / d")
            times[which].append(t["ms"])
        print(f"division {name}{label}: " + " ".join(f"{k}={'/'.join(f'{v:.4f}' for v in vs)}"
                                                     for k, vs in times.items()) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
