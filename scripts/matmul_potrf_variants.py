#!/usr/bin/env python3
"""The design choices of B12 ``matmul`` and B3 POTRF on the card: the
committed kernels of ``src/repro_torch/kernels/csrc/matmul.cu`` and
``tile_lu_sm90.cu`` beside variants of the same sources, each variant a
textual edit or two of the committed file, built with ``nvcc`` into
``build/matmul_potrf_variants/``.

    python3 scripts/matmul_potrf_variants.py

Variants (each run through the port's own wrappers, its C entry put in place
of the committed one):

- bf16 ``wgmma`` route at 4096^3: 4 ring stages (not 3); CTAs numbered along
  N first (not down M);
- fp32 ``tf32x3`` route at 4096^3: partials promoted every 8 or 16 deep (not
  32: the route's knob), each one's error against float64 printed beside
  ``torch.matmul``'s; 32-deep chunks in 4 ring slots (not 64 in 3); and
  ``no split``, whose operands go to the tensor cores unsplit (its products
  are wrong: timed only) -- the cost of everything but splitting;
- POTRF at the n = 4096, 32 x 32 Cholesky plan's one-task group and stacked
  over 64 lanes: l published in one order, l[r] at r, and read as twelve
  scalar loads a thread (not in two orders, read as three float4s).

Every variant but ``no split`` is checked against the plain version (the
matmul at 4096^3 and at a ragged shape, POTRF at b = 128, 120 and 33). Times
run committed, variants, variants, committed, each ``chip_smoke.cuda_ms``
(matmul) or ``chip_smoke.kernel_timing`` (POTRF).  The card's name and power
limit head the output.  Needs one card."""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

OUT = ROOT / "build" / "matmul_potrf_variants"

# name -> (source, [(committed text, variant text), ...])
VARIANTS = {
    "wgmma 4 stages": ("matmul", [("constexpr int kWgStages = 3;", "constexpr int kWgStages = 4;")]),
    "wgmma CTAs along N": ("matmul", [
        ("const int m0 = blockIdx.x * kWgBM, n0 = blockIdx.y * kWgBN;",
         "const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * kWgBN;"),
        ("const dim3 grid((M + kWgBM - 1) / kWgBM, (N + kWgBN - 1) / kWgBN);\n  matmul_wgmma_kernel",
         "const dim3 grid((N + kWgBN - 1) / kWgBN, (M + kWgBM - 1) / kWgBM);\n  matmul_wgmma_kernel")]),
    "tf32x3 promote 8": ("matmul", [("constexpr int kPromote = 32;", "constexpr int kPromote = 8;")]),
    "tf32x3 promote 16": ("matmul", [("constexpr int kPromote = 32;", "constexpr int kPromote = 16;")]),
    "tf32x3 32-deep chunks, 4 slots": ("matmul", [
        ("constexpr int kTcKC = 64;", "constexpr int kTcKC = 32;"),
        ("constexpr int kTcStages = 3;", "constexpr int kTcStages = 4;")]),
    "tf32x3 no split": ("matmul", [(
        "  big = tf32_rna(x);\n  small = tf32_rna(x - __uint_as_float(big));\n",
        "  big = __float_as_uint(x);\n  small = big;\n")]),
    "potrf one-order l": ("tile_lu_sm90", [
        ("""    lcol[kMaxB + 8 * (col % kGetrfWarps) + col / kGetrfWarps] = l[j];
  }
  *reinterpret_cast<float4*>(lcol + 4 * lane) = make_float4(l[0], l[1], l[2], l[3]);
""", """    lcol[col] = l[j];
  }
"""),
        ("""    const float4 r0 = *reinterpret_cast<const float4*>(l + kMaxB + 8 * w);
    const float4 r1 = *reinterpret_cast<const float4*>(l + kMaxB + 8 * w + 4);
    const float4 c0 = *reinterpret_cast<const float4*>(l + 4 * lane);
    const float li[kGR] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    const float lj[kGC] = {c0.x, c0.y, c0.z, c0.w};""",
         """    float li[kGR], lj[kGC];
#pragma unroll
    for (int i = kFirst; i < kGR; ++i) li[i] = l[w + kGetrfWarps * i];
#pragma unroll
    for (int j = kJ; j < kGC; ++j) lj[j] = l[lane + 32 * j];""")]),
}
UNCHECKED = ("tf32x3 no split",)


def build_variants() -> dict:
    """Each variant's shared library, built in parallel: name -> path."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (source, edits)) in enumerate(VARIANTS.items()):
        src = (_build.CSRC / f"{source}.cu").read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the committed {source}.cu no longer holds {old!r}")
            src = src.replace(old, new)
        cu, so = OUT / f"v{i}.cu", OUT / f"libv{i}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        regs = [line.split("Used")[1].split(",")[0].strip() for line in log.splitlines() if "Used" in line]
        print(f"built {name}: registers of its kernels {regs}")
        out[name] = so
    return out


def entry(so: Path, symbol: str, argtypes):
    fn = getattr(ctypes.CDLL(str(so)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import tile_linalg as tl
    from repro_torch.kernels.ref import fp32_matmul

    if not torch.cuda.is_available():
        print("matmul_potrf_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout.strip())
    _build.build(["matmul", "tile_lu_sm90"])
    libs = build_variants()
    rng = np.random.default_rng(0)
    routes = {tl.WGMMA: torch.bfloat16, tl.TF32X3: torch.float32}
    mm_args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for route, dtype in routes.items():
        committed = tl._matmul_fn(route)
        fns = {"committed": committed}
        fns.update({name: entry(so, f"matmul_{route}", mm_args)
                    for name, so in libs.items() if name.startswith(route)})
        tol = cs.MATMUL_TOL[str(dtype).split(".")[-1]]
        cases = [(cs.randn(torch, rng, (m, k), dtype), cs.randn(torch, rng, (k, n), dtype))
                 for m, k, n in ((cs.MM_N, cs.MM_N, cs.MM_N), (384, 128, 384))]
        times = {name: [] for name in fns}
        with fp32_matmul():
            want64 = cases[0][0].double() @ cases[0][1].double()
            lib_e64 = (torch.matmul(*cases[0]).double() - want64).abs().max().item()
            try:
                for name, fn in fns.items():
                    tl._MATMUL_FNS[route] = fn
                    for a, b in cases:
                        got = tl._matmul_launch(route, a, b)
                        if name not in UNCHECKED:
                            e = cs.close(got.float(), tl.matmul_plain(a, b).float(), tol)
                            e64 = (got.double() - want64).abs().max().item() if a is cases[0][0] else None
                            vs64 = "" if e64 is None else (f" max_abs_err_vs_f64={e64:.3e} (torch.matmul "
                                                           f"{lib_e64:.3e}; ratio {e64 / lib_e64:.2f})")
                            print(f"check {route} {name} {tuple(a.shape)}@{tuple(b.shape)}: max_abs_err={e:.3e} "
                                  f"(tol {tol}){vs64}")
                a, b = cases[0]
                order = list(fns) + list(fns)[::-1]
                for name in order:
                    tl._MATMUL_FNS[route] = fns[name]
                    times[name].append(cs.cuda_ms(lambda: tl._matmul_launch(route, a, b), 20))
            finally:
                tl._MATMUL_FNS[route] = committed
            lib_ms = cs.cuda_ms(lambda: torch.matmul(*cases[0]), 20)
        for name, ts in times.items():
            print(f"time  matmul {route} {cs.MM_N}^3 {name}: ms={' / '.join(f'{t:.4f}' for t in ts)} "
                  f"(torch.matmul {lib_ms:.4f})")

    from repro_torch.core import spd_matrix
    from repro_torch.core.data import to_grid
    from repro_torch.linalg import POTRF

    chol = cs.plan_groups(POTRF, [((cs.N, cs.N), ((cs.P, cs.P),))])
    spd = [to_grid(spd_matrix(cs.N, seed=1), cs.N // cs.P, cs.N // cs.P)]
    b = cs.SN // cs.SP
    served = cs.plan_groups(POTRF, [((cs.SN, cs.SN), ((cs.SP, cs.SP),))])
    lanes = [cs.lane_grids(torch, spd_matrix, cs.SN, b, cs.LANES)]
    committed = tl._kernel_fn("potrf")
    fns = {"committed": committed, "potrf one-order l": entry(libs["potrf one-order l"], "tile_potrf",
                                                                 tl._ARGTYPES["potrf"])}
    try:
        for name, fn in fns.items():
            tl._FNS["potrf"] = fn
            for edge in (128, 120, 33):
                tiles = torch.from_numpy(cs.spd_tiles(rng, 4, edge)).cuda()
                e = cs.close(tl.batched_potrf(tiles), tl.potrf_plain(tiles), cs.TOL["potrf"])
                print(f"check potrf {name} b={edge}: max_abs_err={e:.3e} (tol {cs.TOL['potrf']})")
        for name in list(fns) + list(fns)[::-1]:
            tl._FNS["potrf"] = fns[name]
            t = cs.kernel_timing(torch, tl, "potrf", chol, spd, label=f" {name}")
            s = cs.stacked_timing(torch, tl, rng, "potrf", served, lanes)
            t.pop("launch"), s.pop("launch")
    finally:
        tl._FNS["potrf"] = committed
    return 0


if __name__ == "__main__":
    sys.exit(main())
