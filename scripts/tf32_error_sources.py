#!/usr/bin/env python3
"""Where GEMMNN's error against float64 comes from on the card: the split of
each operand into TF32 terms, or the tensor cores' fp32 accumulation.

    python3 scripts/tf32_error_sources.py [--compare OTHER.cu ...]

GEMMNN (``src/repro_torch/kernels/csrc/tile_lu_sm90.cu``, which promotes
each 8-deep step's tensor-core partial into an fp32 sum and takes C - sum
last) is built from the committed source into ``build/tf32_probe/``, and so
is every ``--compare`` source that exports the same ``tile_gemmnn`` (the
entry that takes a segment table per argument): for example the kernel whose
one tensor-core accumulator starts from -C, once its entry and
``block_offset`` are given the segment tables (that commit's source predates
them)::

    mkdir -p build/tf32_probe
    git show 366bfd0:src/repro_torch/kernels/csrc/tile_lu_sm90.cu > build/tf32_probe/from_c.cu
    python3 scripts/tf32_error_sources.py --compare build/tf32_probe/from_c.cu

Each kernel runs through the port's own wrapper (``tile_linalg.grid_gemmnn``)
on the LU plan's largest GEMMNN group (n = 4096, 32 x 32 partitions: 961
tasks of 128^3, ``dd_matrix`` blocks) and on single 128^3 tiles
(``dd_matrix`` blocks, and 0.3-scale Gaussian ones), each in three ways
against float64 on the same inputs:

- ``fp32``: the inputs as they are;
- ``tf32``: A and B rounded to TF32 first, so the small terms are 0 and the
  products exact: what is left is the accumulation's rounding;
- ``tf32 C=0``: the same with C = 0, so nothing large sits in the sum.

Beside them: ``torch.matmul`` in fp32 (TF32 off), and two emulations of the
3xTF32 split with round-to-nearest fp32 sums (``torch.matmul`` of the TF32
terms, 8 deep at a time), which have the split's error and no tensor-core
rounding: one running sum from -C (``emu_from_c``), and each step's partial
promoted into a sum from 0 with C - sum last (``emu_promoted``, the
committed kernel's order).  Each entry gives the largest absolute error and
the mean signed error (a bias shows a rounding that is not to nearest).
Then each kernel's time at the 961-task group, and the error of whole
``run_lu`` / ``run_lu_solve`` drains (n = 4096, g2p) against float64.  The
card's name and power limit head the output.  Needs one card."""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def tf32(torch, x):
    """x rounded to TF32 as cvt.rna does (the kernel's ``tf32_rna``)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split_emulation(torch, a, b, c, promoted: bool):
    """C - A B with each operand split into big + small TF32 terms and the
    three products of each 8-deep step summed small*big, big*small, big*big,
    every sum rounded to nearest in fp32 (TF32 products are exact in fp32):
    into one running sum from -C, or (``promoted``) into a step partial from
    0 that is added into a sum from 0, with C - sum last."""
    ab, bb = tf32(torch, a), tf32(torch, b)
    as_, bs = tf32(torch, a - ab), tf32(torch, b - bb)
    acc = torch.zeros_like(c) if promoted else -c
    for k0 in range(0, a.shape[-1], 8):
        k = slice(k0, k0 + 8)
        if promoted:
            acc = acc + (as_[..., k] @ bb[..., k, :] + ab[..., k] @ bs[..., k, :] + ab[..., k] @ bb[..., k, :])
        else:
            acc = acc + as_[..., k] @ bb[..., k, :]
            acc = acc + ab[..., k] @ bs[..., k, :]
            acc = acc + ab[..., k] @ bb[..., k, :]
    return c - acc if promoted else -acc


def stats(got, want) -> str:
    d = got.double() - want
    return f"max_abs={d.abs().max().item():.3e} mean_signed={d.mean().item():+.3e}"


def build(tl, _build, sources: dict, out: Path) -> dict:
    """Each source's ``tile_gemmnn``, built with the port's nvcc flags (one
    nvcc each, in parallel); prints GEMMNN's registers and spills."""
    procs = {label: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{label}.so"), str(src)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for label, src in sources.items()}
    fns = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {sources[label]}:\n{log}")
        entry, regs = "", []
        for ln in log.splitlines():  # each GEMMNN instantiation's registers and spills
            if "Compiling entry" in ln or "Function properties" in ln:
                entry = ln
            elif "gemmnn_kernel" in entry and ("registers" in ln or "spill" in ln):
                regs.append(ln.split(":", 1)[-1].strip())
        print(f"kernel {label} ({sources[label]}) built; ptxas, gemmnn_kernel: {' | '.join(regs)}")
        fn = ctypes.CDLL(str(out / f"{label}.so")).tile_gemmnn
        fn.argtypes, fn.restype = tl._ARGTYPES["gemmnn"], ctypes.c_int
        fns[label] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", action="append", default=[], type=Path,
                    help="another GEMMNN source exporting tile_gemmnn (repeatable)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tf32_error_sources: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import dd_matrix
    from repro_torch.core.data import to_grid
    from repro_torch.kernels import _build
    from repro_torch.kernels import tile_linalg as tl
    from repro_torch.kernels.ref import fp32_matmul
    from repro_torch.linalg import GETRF, run_lu, run_lu_solve

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout.strip())
    for name in tl.LIBRARY:  # load both libraries first: a later load would reset the swapped entry
        tl._kernel_fn(name)
    out = ROOT / "build" / "tf32_probe"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"committed": _build.CSRC / "tile_lu_sm90.cu"}
    for src in args.compare:
        sources[src.stem] = src.resolve()
    fns = build(tl, _build, sources, out)

    n, p = cs.N, cs.P
    b = n // p
    g = max((g for g in cs.plan_groups(GETRF, [((n, n), ((p, p),))])
             if g.op.name == "gemmnn" and len(g.segments) == 1), key=lambda g: g.size)
    slots = g.segments[0][0]
    idxs = [torch.from_numpy(ix).cuda() for ix in g.idxs]
    grid = to_grid(dd_matrix(n, seed=1), b, b)
    gen = torch.Generator(device="cuda").manual_seed(7)
    tiles = {
        f"{g.size} tasks (LU plan)": None,
        "128^3 tile dd": [dd_matrix(b, seed=s) for s in (1, 2, 3)],
        "128^3 tile randn": [0.3 * torch.randn(b, b, device="cuda", generator=gen) for _ in range(3)],
    }

    def operands(label, way):
        """(A, B, C) stacks and a function running a kernel in place on
        copies of them, for one case and way of preparing its inputs."""
        if tiles[label] is None:
            grd = tf32(torch, grid) if way != "fp32" else grid.clone()
            (ar, ac), (br_, bc), (cr, cc) = ((ix[:, 0].long(), ix[:, 1].long()) for ix in idxs)
            if way == "tf32 C=0":
                grd[cr, cc] = 0.0
            a, bm, c = grd[ar, ac], grd[br_, bc], grd[cr, cc]

            def run(fn):
                tl._FNS["gemmnn"] = fn
                work = grd.clone()
                tl.grid_gemmnn(idxs, [work for _ in slots])
                return work[cr, cc]
        else:
            a, bm, c = (x[None].clone() for x in tiles[label])
            if way != "fp32":
                a, bm = tf32(torch, a), tf32(torch, bm)
            if way == "tf32 C=0":
                c = torch.zeros_like(c)

            def run(fn):
                tl._FNS["gemmnn"] = fn
                return tl.batched_gemmnn(a, bm, c)
        return a, bm, c, run

    for label in tiles:
        for way in ("fp32", "tf32", "tf32 C=0"):
            a, bm, c, run = operands(label, way)
            want = c.double() - a.double() @ bm.double()
            with fp32_matmul():
                lib = c - torch.matmul(a, bm)
                emus = {f"emu_{o}": split_emulation(torch, a, bm, c, o == "promoted") for o in ("from_c", "promoted")}
            parts = [f"{k}: {stats(v, want)}" for k, v in emus.items()]
            parts += [f"kernel {k}: {stats(run(fn), want)}" for k, fn in fns.items()]
            print(f"error {label} [{way}]: torch.matmul fp32: {stats(lib, want)}; " + "; ".join(parts))

    (cr, cc) = (idxs[2][:, 0].long(), idxs[2][:, 1].long())
    fresh = grid[cr, cc]
    for label, fn in fns.items():
        tl._FNS["gemmnn"] = fn
        work = grid.clone()
        with cs.forced_shape(tl, 64):
            ms = cs.cuda_ms_fresh(lambda: tl.grid_gemmnn(idxs, [work for _ in slots]),
                                  lambda: work.index_put_((cr, cc), fresh), 20)
        print(f"time {g.size} tasks, tile 64: kernel {label} kernel_ms={ms:.4f}")

    import numpy as np

    a = dd_matrix(n, seed=0)
    a64 = a.double()
    bm = torch.from_numpy(np.random.default_rng(0).standard_normal((n, cs.RHS)).astype(np.float32)).cuda()
    ref_lu = torch.linalg.lu_factor_ex(a64, pivot=False).LU
    ref_x = torch.linalg.solve(a64, bm.double())
    ref_xv = torch.linalg.solve(a64, bm[:, :1].double())
    for label, fn in fns.items():
        tl._FNS["gemmnn"] = fn
        lo, up = run_lu(a, graph="g2p", partitions=((p, p),))
        e_lu = (torch.tril(lo, -1).double() + up.double() - ref_lu).abs().max().item()
        x = run_lu_solve(a, bm, graph="g2p", partitions=((p, p),), b_partitions=((p, cs.RHS_P),))
        xv = run_lu_solve(a, bm[:, 0].contiguous(), graph="g2p", partitions=((p, p),))
        e_x = (x.double() - ref_x).abs().max().item()
        e_xv = (xv.double()[:, None] - ref_xv).abs().max().item()
        print(f"drains n={n} g2p kernel {label}: run_lu max_abs={e_lu:.3e} "
              f"lu_solve b=({n},{cs.RHS}) max_abs={e_x:.3e} vector max_abs={e_xv:.3e}")
    tl._FNS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
