#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase catches its own):

1. Environment: torch/CUDA versions, the card's name and power limit, and
   the build of the hand-written kernels from ``src/repro_torch/kernels/csrc``.
2. Kernels: each of the nine tile kernels — Cholesky's POTRF, TRSM, SYRK,
   GEMM and LU's GETRF, TRSML, TRSMU, TRSMUL, GEMMNN — is held against its
   plain PyTorch version on the card at b = 8 ... 128 (right-hand-side
   widths bc = 1, 8 and b where a kernel takes a non-square operand), in
   the fused-grid form (random distinct write blocks on random non-square
   grids, arguments of one tile shape in one grid, whole grids compared)
   and in the batched form (2a); then in the stacked grid form on
   (B, nr, nc, br, bc) grids, B = 3 and 4, all lanes sharing the indices
   and the last lane a copy of the one before it (2c).  Each is timed at
   the main path's shapes (the largest group of that kernel in the
   n = 4096, 32 x 32 plan of Cholesky, of LU, or for TRSMUL of the
   matrix-RHS LU solve, on the resident grids) beside its plain version,
   one PyTorch library call computing the same group, and the least time
   the card could take (its bound) (2b); and in stacked form at the
   serving shapes (the largest group in the n = 1024, 8 x 8 template plan
   over 64 lanes) beside the same group as 64 unstacked launches, the
   plain stacked version, a library call on the flattened stack and the
   bound, each result held against the plain version on those grids and
   on random ones (2d).  Each stacked check also asserts that the written
   grid left as it was would fail it.
3. Cholesky main path: blocked Cholesky of a 4096 x 4096 fp32 SPD matrix on
   graph g2p with 32 x 32 partitions (128 x 128 tiles), drained twice
   (first drain, then a drain-memo replay), checked against float64
   ``torch.linalg.cholesky`` and the structural counters; kernel launch
   counters are zeroed right before each drain and read right after.  Then
   g2 at the same size and g1 at n = 256 through ``run_cholesky``.
4. LU main paths, on a 4096 x 4096 column-diagonally-dominant matrix with
   32 x 32 partitions, each g2p drain between zeroed and read counters:
   ``run_lu``'s drain twice (packed factor against a float64 pivot-free LU),
   ``run_lu_solve``'s drain with b (4096, 512) in 32 x 4 blocks twice and
   with a vector b once (solution against float64 ``torch.linalg.solve``),
   a profiled replay of the matrix-RHS drain, then the same solve on g2
   and ``run_inv`` on g1 at n = 256.
5. Serving: ``BatchServer(graph="g2p", max_batch=64)``; each tick queues 64
   ``lu_solve`` (vector b), 16 ``lu`` and 16 ``cholesky`` requests of
   n = 1024 in 8 x 8 partitions, three signature buckets of one stacked
   launch list each.  Tick 1 captures; ticks 2-4 (fresh inputs, stacked
   launch counts zeroed before and read after each) must show 0 builds,
   3 launches, 3 stacked drains, 96 resolved, no host wait, a stacked
   launch of all nine kernels, each bucket's template counters,
   results within 2e-4 (factors) and 1e-3 (solutions) of float64, and
   factors whose componentwise backward error stays within fp32's bound
   for blocked LU and Cholesky, |LU - A| <= gamma_n |L||U|.  Then a
   profiled repeat tick, the same tick on g2, the 64 solves as sequential
   ``run_lu_solve`` replays and as one batched library call, and two fault
   rounds (``check_finite=True``, no retries): a NaN request fails alone
   with ``NumericalError``; an in-flight fault on one request bisects and
   fails it alone with ``InflightError``.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository beside it, the script fails before printing it.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, P = 4096, 32  # main paths: n x n fp32, P x P partitions -> 128 x 128 tiles
RHS, RHS_P = 512, 4  # matrix right-hand side of the LU solve: (N, 512) in P x 4 blocks
TILES = (8, 16, 32, 64, 128)
CHOLESKY = ("potrf", "trsm", "syrk", "gemm")
LU = ("getrf", "trsml", "trsmu", "trsmul", "gemmnn")
KERNELS = CHOLESKY + LU
WIDE = ("trsml", "trsmu", "trsmul", "gemmnn")  # take an operand of width bc
# the reference tests' tolerances (tests/test_kernels.py), atol = rtol
TOL = {"potrf": 2e-4, "trsm": 2e-3, "syrk": 1e-4, "gemm": 1e-4,
       "getrf": 2e-4, "trsml": 2e-3, "trsmu": 2e-3, "trsmul": 2e-3, "gemmnn": 1e-4}
_TL = "src/repro/kernels/tile_linalg.py"
REPLACES = {
    "potrf": f"{_TL}:181 batched_potrf; :367 make_grid_fused (grid_potrf :444)",
    "trsm": f"{_TL}:201 batched_trsm; :367 make_grid_fused (grid_trsm :445)",
    "syrk": f"{_TL}:223 batched_syrk; :367 make_grid_fused (grid_syrk :446)",
    "gemm": f"{_TL}:242 batched_gemm; :367 make_grid_fused (grid_gemm :447)",
    "getrf": f"{_TL}:265 batched_getrf; :367 make_grid_fused (grid_getrf :448)",
    "trsml": f"{_TL}:282 batched_trsml; :367 make_grid_fused (grid_trsml :449)",
    "trsmu": f"{_TL}:302 batched_trsmu; :367 make_grid_fused (grid_trsmu :450)",
    "trsmul": f"{_TL}:321 batched_trsmul; :367 make_grid_fused (grid_trsmul :451)",
    "gemmnn": f"{_TL}:340 batched_gemmnn; :367 make_grid_fused (grid_gemmnn :452)",
}
SOURCE = "src/repro_torch/kernels/csrc/tile_linalg.cu"
# FLOPs of one task from its arguments' tile shapes [(rows, cols), ...]
FLOPS = {
    "potrf": lambda s: s[0][0] ** 3 / 3,
    "trsm": lambda s: s[1][0] * s[0][0] ** 2,
    "syrk": lambda s: 2 * s[0][0] ** 3,
    "gemm": lambda s: 2 * s[0][0] ** 3,
    "getrf": lambda s: 2 * s[0][0] ** 3 / 3,
    "trsml": lambda s: s[0][0] ** 2 * s[1][1],
    "trsmul": lambda s: s[0][0] ** 2 * s[1][1],
    "trsmu": lambda s: s[1][0] * s[0][0] ** 2,
    "gemmnn": lambda s: 2 * s[0][0] * s[0][1] * s[1][1],
}
# H100 SXM published peaks (NVIDIA data sheet): fp32 on the CUDA cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
EXPECTED_LAUNCHES = {"potrf": 32, "trsm": 31, "syrk": 31, "gemm": 30}  # per drain at P = 32
# the serving path: BatchServer(graph="g2p", max_batch=64) on n = 1024 requests
# in 8 x 8 partitions (128 x 128 tiles, as on the main paths)
SN, SP, LANES = 1024, 8, 64
SERVED = {"lu_solve": 64, "lu": 16, "cholesky": 16}  # requests of each kind per tick
# each bucket's template plan (leaves, groups, prefusion groups, slots): the
# same at any tile size, so the same as the CPU tests' n = 64
TEMPLATES = {"lu_solve": (276, 80, 80, 59), "lu": (204, 29, 29, 22), "cholesky": (120, 28, 28, 22)}
STACKED_REPLACES = f"{_TL}:388 make_grid_fused kernel_stacked (_imap_stacked :401, pallas_call :433)"


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_fresh(fn, restore, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` alone, each call on inputs that ``restore``
    has just put back (``fn`` writes in place).  A device-side sleep ahead
    of each call lets the host queue the restore and the timed call, so the
    events time the card, not the host's launch path."""
    import torch

    for _ in range(warmup):
        restore()
        fn()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)  # cycles, about 0.5 ms
        restore()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def close(got, want, tol: float) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol * |want| everywhere."""
    import torch

    diff = (got.double() - want.double()).abs()
    if not torch.isfinite(got).all() or (diff > tol + tol * want.double().abs()).any():
        raise AssertionError(f"max abs err {diff.max().item():.3e} exceeds tolerance {tol}")
    return diff.max().item()


# --------------------------------------------------------------------------
# Phase 2a inputs: numpy tile stacks
# --------------------------------------------------------------------------
def spd_tiles(rng, n: int, b: int):
    import numpy as np

    m = rng.standard_normal((n, b, b)).astype(np.float32) / np.float32(np.sqrt(b))
    return m @ m.transpose(0, 2, 1) + 2.0 * np.eye(b, dtype=np.float32)


def lower_with_junk(rng, n: int, b: int):
    """Cholesky factors with finite junk above the diagonal (the kernels must
    ignore it, as the JAX tile bodies do)."""
    import numpy as np

    low = np.linalg.cholesky(spd_tiles(rng, n, b).astype(np.float64)).astype(np.float32)
    junk = np.triu(rng.standard_normal((n, b, b)).astype(np.float32), 1) * 0.3
    return low + junk


def dd_tiles(rng, n: int, b: int):
    """Column-diagonally-dominant tiles (``dd_matrix``'s recipe per tile)."""
    import numpy as np

    a = rng.standard_normal((n, b, b)).astype(np.float32)
    a /= np.abs(a).sum(axis=1, keepdims=True) * 1.5
    a[:, np.arange(b), np.arange(b)] = 1.0 + rng.uniform(0.0, 1.0, (n, b)).astype(np.float32)
    return a


def packed_lu_tiles(rng, n: int, b: int):
    """Packed L\\U of dd tiles from a float64 pivot-free LU, so the triangle a
    solve kernel must not read carries real junk."""
    m = dd_tiles(rng, n, b).astype("float64")
    for k in range(b):
        m[:, k + 1 :, k] /= m[:, k, k, None]
        m[:, k + 1 :, k + 1 :] -= m[:, k + 1 :, k, None] * m[:, k, None, k + 1 :]
    return m.astype("float32")


def special_tiles(name: str, rng, n: int, b: int):
    """The structured stack of a kernel's factor argument (argument 0), or None."""
    make = {"potrf": spd_tiles, "getrf": dd_tiles, "trsm": lower_with_junk, "trsml": packed_lu_tiles,
            "trsmu": packed_lu_tiles, "trsmul": packed_lu_tiles}.get(name)
    return None if make is None else make(rng, n, b)


def grid_case(tl, name: str, rng, b: int, bc: int, nr: int = 6, nc: int = 7, n: int = 12, lanes=None):
    """Random non-square grids, one per distinct tile shape (arguments of one
    shape address one grid, as in a single-root drain); distinct write
    blocks, the written grid's read blocks drawn from the rest.  With
    ``lanes`` the grids are stacked ``(lanes, nr, nc, br, bc)``, every lane
    with its own values and factor tiles, all lanes sharing the indices;
    the last lane copies the one before it, as a pow2 padding lane does."""
    import numpy as np

    lead = () if lanes is None else (lanes,)
    shapes = tl.tile_shapes(name, b, bc)
    w = tl.GRID_FUSED[name][1]
    grid_of, grids = {}, []
    for s in shapes:
        if s not in grid_of:
            grid_of[s] = len(grids)
            grids.append(rng.standard_normal(lead + (nr, nc) + s).astype(np.float32) * 0.3)
    blocks = rng.permutation(nr * nc)
    writes, rest = blocks[:n], blocks[n:]
    flat = []
    for a, s in enumerate(shapes):
        same = grid_of[s] == grid_of[shapes[w]]
        flat.append(writes if a == w else rng.choice(rest if same else np.arange(nr * nc), n))
    blk = np.unique(flat[0])
    g = grids[grid_of[shapes[0]]]
    for lane in range(1 if lanes is None else lanes):
        tiles = special_tiles(name, rng, len(blk), b)
        if tiles is not None:
            (g if lanes is None else g[lane]).reshape(-1, b, b)[blk] = tiles
    if lanes is not None:
        for g in grids:
            g[-1] = g[-2]
    idxs = [np.stack([f // nc, f % nc], 1).astype(np.int32) for f in flat]
    return grids, [grid_of[s] for s in shapes], idxs


def kernel_checks(torch, tl, rng) -> dict:
    """Phase 2a: every kernel against its plain version, both forms."""
    import numpy as np

    err = {k: 0.0 for k in KERNELS}
    n = 12
    for b in TILES:
        for name in KERNELS:
            w = tl.GRID_FUSED[name][1]
            for bc in sorted({1, 8, b}) if name in WIDE else [b]:
                grids, which, idxs = grid_case(tl, name, rng, b, bc, n=n)
                ix = [torch.from_numpy(i).cuda() for i in idxs]
                g0 = [torch.from_numpy(g).cuda() for g in grids]
                gk, gp = [g.clone() for g in g0], [g.clone() for g in g0]
                getattr(tl, f"grid_{name}")(ix, [gk[k] for k in which])
                getattr(tl, f"grid_{name}_plain")(ix, [gp[k] for k in which])
                torch.cuda.synchronize()
                e_grid = max(close(x, y, TOL[name]) for x, y in zip(gk, gp))
                for k in range(len(g0)):
                    if k != which[w] and not torch.equal(gk[k], g0[k]):
                        raise AssertionError(f"grid_{name} wrote a grid it only reads")
                # batched form on (n, br, bc) stacks
                stacks = [rng.standard_normal((n,) + s).astype(np.float32) * 0.3
                          for s in tl.tile_shapes(name, b, bc)]
                tiles = special_tiles(name, rng, n, b)
                if tiles is not None:
                    stacks[0] = tiles
                st = [torch.from_numpy(s).cuda() for s in stacks]
                before = [s.clone() for s in st]
                out_k = getattr(tl, f"batched_{name}")(*st)
                out_p = getattr(tl, f"{name}_plain")(*st)
                torch.cuda.synchronize()
                e_bat = close(out_k, out_p, TOL[name])
                for s, s0 in zip(st, before):
                    if not torch.equal(s, s0):
                        raise AssertionError(f"batched_{name} modified its input stack")
                err[name] = max(err[name], e_grid, e_bat)
                width = f" bc={bc:3d}" if name in WIDE else ""
                print(f"check {name:6s} b={b:3d}{width}: grid max_abs_err={e_grid:.3e} "
                      f"batched max_abs_err={e_bat:.3e} (tol {TOL[name]})")
    return err


def stacked_checks(torch, tl, rng) -> dict:
    """Phase 2c: the stacked grid form of every kernel (``make_grid_fused``'s
    ``kernel_stacked``) against its plain stacked version, B = 3 and 4,
    whole stacked grids compared: unwritten blocks and lanes keep their
    bytes, and the padding lane's result equals the lane it copies."""
    err = {k: 0.0 for k in KERNELS}
    for b in TILES:
        for name in KERNELS:
            w = tl.GRID_FUSED[name][1]
            for bc in sorted({1, 8, b}) if name in WIDE else [b]:
                e_case = 0.0
                for lanes in (3, 4):
                    grids, which, idxs = grid_case(tl, name, rng, b, bc, lanes=lanes)
                    ix = [torch.from_numpy(i).cuda() for i in idxs]
                    g0 = [torch.from_numpy(g).cuda() for g in grids]
                    gk, gp = [g.clone() for g in g0], [g.clone() for g in g0]
                    before = tl.STACKED_LAUNCHES[name]
                    getattr(tl, f"grid_{name}")(ix, [gk[k] for k in which])
                    getattr(tl, f"grid_{name}_plain")(ix, [gp[k] for k in which])
                    torch.cuda.synchronize()
                    if tl.STACKED_LAUNCHES[name] != before + 1:
                        raise AssertionError(f"grid_{name} on stacked grids did not count a stacked launch")
                    e = max(close(x, y, TOL[name]) for x, y in zip(gk, gp))
                    unchanged_fails(name, g0[which[w]], gp[which[w]])
                    out = gk[which[w]]
                    if not torch.equal(out[-1], out[-2]):
                        raise AssertionError(f"stacked {name}: the padding lane differs from the lane it copies")
                    for k in range(len(g0)):
                        if k != which[w] and not torch.equal(gk[k], g0[k]):
                            raise AssertionError(f"stacked {name} wrote a grid it only reads")
                    e_case = max(e_case, e)
                err[name] = max(err[name], e_case)
                width = f" bc={bc:3d}" if name in WIDE else ""
                print(f"check {name:6s}_stacked b={b:3d}{width} B=3,4: max_abs_err={e_case:.3e} "
                      f"(tol {TOL[name]})")
    return err


# --------------------------------------------------------------------------
# Phase 2b: kernel timings at the main paths' shapes
# --------------------------------------------------------------------------
def plan_groups(op, specs):
    """The leaf plan of one root ``op`` over data of ``specs`` = [(shape,
    partitions), ...], planned without executing."""
    from repro_torch.core import DepTracker, GData, GTask
    from repro_torch.core.executors import plan_schedule

    datas = []
    for shape, parts in specs:
        d = GData(shape, partitions=parts, value=None, device="cuda")
        d.materialize()
        datas.append(d)
    root = GTask(op, None, [d.root_view() for d in datas])
    children = []
    op.split(root, children.append)
    tracker = DepTracker()
    for t in children:
        tracker.add(t)
    return list(plan_schedule(tracker.waves(), tracker.dag()).groups())


def bound(name: str, w: int, g, grids):
    """Least time (ms) for one group: distinct input blocks read once, the
    written blocks written once, against the kernel's FLOPs at fp32 peak."""
    slots = g.segments[0][0]
    reads = set()
    for s, ix in zip(slots, g.idxs):
        reads |= {(s, int(r), int(c)) for r, c in ix}
    tile = [tuple(grids[s].shape[-2:]) for s in slots]
    nbytes = (sum(grids[s].shape[-2] * grids[s].shape[-1] for s, _, _ in reads)
              + g.size * tile[w][0] * tile[w][1]) * 4
    flops = g.size * FLOPS[name](tile)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_call(torch, name: str, stacks):
    """One PyTorch call computing a group's function on its gathered tiles:
    the yardstick, timed here and never called by the port."""
    sl = torch.linalg.solve_triangular
    if name == "potrf":
        return lambda: torch.linalg.cholesky(stacks[0])
    if name == "trsm":
        lstack = torch.linalg.cholesky(stacks[0])
        return lambda: sl(lstack.mT, stacks[1], upper=True, left=False)
    if name == "syrk":
        return lambda: torch.baddbmm(stacks[1], stacks[0], stacks[0].mT, alpha=-1)
    if name == "gemm":
        return lambda: torch.baddbmm(stacks[2], stacks[0], stacks[1].mT, alpha=-1)
    if name == "getrf":
        return lambda: torch.linalg.lu_factor_ex(stacks[0], pivot=False)
    if name == "trsml":
        return lambda: sl(stacks[0], stacks[1], upper=False, left=True, unitriangular=True)
    if name == "trsmu":
        return lambda: sl(stacks[0], stacks[1], upper=True, left=False)
    if name == "trsmul":
        return lambda: sl(stacks[0], stacks[1], upper=True, left=True)
    return lambda: torch.baddbmm(stacks[2], stacks[0], stacks[1], alpha=-1)


def kernel_timing(torch, tl, name: str, groups, grids) -> dict:
    """One kernel at the main path's shapes (its largest single-segment
    group), every timed call on the same fresh grids: the written blocks
    are put back before each call, untimed."""
    from repro_torch.kernels.ref import fp32_matmul

    g = max((g for g in groups if g.op.name == name and len(g.segments) == 1), key=lambda g: g.size)
    slots = g.segments[0][0]
    wa = tl.GRID_FUSED[name][1]
    w = slots[wa]
    idxs = [torch.from_numpy(ix).cuda() for ix in g.idxs]
    wr, wc = idxs[wa].long().unbind(1)
    fresh = grids[w][wr, wc]
    gk, gp = [x.clone() for x in grids], [x.clone() for x in grids]
    kern = lambda: getattr(tl, f"grid_{name}")(idxs, [gk[s] for s in slots])
    plain = lambda: getattr(tl, f"grid_{name}_plain")(idxs, [gp[s] for s in slots])
    kern()
    plain()
    torch.cuda.synchronize()
    err = close(gk[w], gp[w], TOL[name])
    lib = library_call(torch, name, [grids[s][ix[:, 0], ix[:, 1]] for s, ix in zip(slots, idxs)])
    ms = cuda_ms_fresh(kern, lambda: gk[w].index_put_((wr, wc), fresh), 20)
    plain_ms = cuda_ms_fresh(plain, lambda: gp[w].index_put_((wr, wc), fresh), 3)
    with fp32_matmul():
        lib_ms = cuda_ms(lib, 20)  # out of place: its inputs stay fresh
    bound_ms, bound_by = bound(name, wa, g, grids)
    shapes = "x".join(f"{r}:{c}" for r, c in (tuple(grids[s].shape[-2:]) for s in slots))
    print(f"time  {name:6s} tiles={shapes} tasks={g.size:4d}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) max_abs_err={err:.3e}")
    return dict(tasks=g.size, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def kernel_timings(torch, tl) -> dict:
    """Phase 2b: the Cholesky four at the Cholesky plan's largest groups,
    GETRF/TRSML/TRSMU/GEMMNN at the LU plan's, TRSMUL at the matrix-RHS
    LU solve plan's."""
    from repro_torch.core import dd_matrix, spd_matrix
    from repro_torch.core.data import to_grid
    from repro_torch.linalg import GETRF, LUSOLVE, POTRF

    b = N // P
    a_spec, b_spec = ((N, N), ((P, P),)), ((N, RHS), ((P, RHS_P),))
    chol = plan_groups(POTRF, [a_spec])
    lu = plan_groups(GETRF, [a_spec])
    solve = plan_groups(LUSOLVE, [a_spec, b_spec])
    spd = [to_grid(spd_matrix(N, seed=1), b, b)]
    dd = [to_grid(dd_matrix(N, seed=1), b, b)]
    rhs = to_grid(0.3 * torch.randn(N, RHS, generator=torch.Generator().manual_seed(1)).cuda(), b, RHS // RHS_P)
    out = {}
    for name in CHOLESKY:
        out[name] = kernel_timing(torch, tl, name, chol, spd)
    for name in ("getrf", "trsml", "trsmu", "gemmnn"):  # TRSMUL is not in run_lu
        out[name] = kernel_timing(torch, tl, name, lu, dd)
    out["trsmul"] = kernel_timing(torch, tl, "trsmul", solve, dd + [rhs])
    return out


def lane_grids(torch, make, n: int, b: int, lanes: int):
    """(lanes, n/b, n/b, b, b) stacked grids of ``make(n, seed=lane)``."""
    from repro_torch.core.data import to_grid

    return torch.stack([to_grid(make(n, seed=lane), b, b) for lane in range(lanes)])


def unchanged_fails(name: str, before, want) -> None:
    """Raises unless the written grid as it was before the call fails the
    check against the plain version's result: a kernel that did nothing
    must not pass."""
    try:
        close(before, want, TOL[name])
    except AssertionError:
        return
    raise AssertionError(f"stacked {name}: the written blocks left as they were pass the check; it cannot see "
                         "the kernel")


def stacked_random_check(torch, tl, rng, name: str, g, grids) -> float:
    """Phase 2d's check at the serving shapes: the group's stacked launch, its
    LANES unstacked launches and its plain stacked version on random
    0.3-scale grids of the timed grids' shapes, argument 0's factor tiles
    made per lane as in 2a; the group's own indices; whole grids compared.
    On the timed dd/spd grids some kernels change their blocks by less than
    the tolerance, so this check, not that one, is the one that must fail a
    kernel that did nothing; the script asserts that it would."""
    import numpy as np

    slots = g.segments[0][0]
    w = slots[tl.GRID_FUSED[name][1]]
    torch.manual_seed(int(rng.integers(2**31)))
    g0 = [0.3 * torch.randn(x.shape, device=x.device) for x in grids]
    blk = np.unique(g.idxs[0], axis=0)
    b = grids[slots[0]].shape[-1]
    tiles = special_tiles(name, rng, LANES * len(blk), b)
    if tiles is not None:
        r, c = torch.from_numpy(blk).long().cuda().unbind(1)
        g0[slots[0]][:, r, c] = torch.from_numpy(tiles).cuda().view(LANES, len(blk), b, b)
    idxs = [torch.from_numpy(ix).cuda() for ix in g.idxs]
    gk, gu, gp = ([x.clone() for x in g0] for _ in range(3))
    fused = getattr(tl, f"grid_{name}")
    fused(idxs, [gk[s] for s in slots])
    for i in range(LANES):
        fused(idxs, [gu[s][i] for s in slots])
    getattr(tl, f"grid_{name}_plain")(idxs, [gp[s] for s in slots])
    torch.cuda.synchronize()
    err = max(close(x, y, TOL[name]) for x, y in zip(gk + gu, gp + gp))
    unchanged_fails(name, g0[w], gp[w])
    for k in range(len(g0)):
        if k != w and not (torch.equal(gk[k], g0[k]) and torch.equal(gu[k], g0[k])):
            raise AssertionError(f"stacked {name} wrote a grid it only reads")
    return err


def stacked_timing(torch, tl, rng, name: str, groups, grids) -> dict:
    """One kernel's stacked form at the serving shapes: its largest
    single-segment group in the template plan, on (LANES, ...) stacked
    grids; beside it the same group as LANES unstacked launches (one per
    lane), the plain stacked version, one library call on the flattened
    LANES * size stack, and the bound (LANES times one lane's).  The
    results are held against the plain version on these grids and on
    random ones (``stacked_random_check``)."""
    from repro_torch.kernels.ref import fp32_matmul

    g = max((g for g in groups if g.op.name == name and len(g.segments) == 1), key=lambda g: g.size)
    err_random = stacked_random_check(torch, tl, rng, name, g, grids)
    slots = g.segments[0][0]
    wa = tl.GRID_FUSED[name][1]
    w = slots[wa]
    idxs = [torch.from_numpy(ix).cuda() for ix in g.idxs]
    wr, wc = idxs[wa].long().unbind(1)
    fresh = grids[w][:, wr, wc]
    gk, gu, gp = ([x.clone() for x in grids] for _ in range(3))
    fused = getattr(tl, f"grid_{name}")
    kern = lambda: fused(idxs, [gk[s] for s in slots])
    lanes = lambda: [fused(idxs, [gu[s][i] for s in slots]) for i in range(LANES)]
    plain = lambda: getattr(tl, f"grid_{name}_plain")(idxs, [gp[s] for s in slots])
    kern()
    lanes()
    plain()
    torch.cuda.synchronize()
    err = max(close(gk[w], gp[w], TOL[name]), close(gu[w], gp[w], TOL[name]))

    def restore(x):
        def put():
            x[w][:, wr, wc] = fresh

        return put

    lib = library_call(torch, name, [grids[s][:, ix[:, 0].long(), ix[:, 1].long()].flatten(0, 1)
                                     for s, ix in zip(slots, idxs)])
    ms = cuda_ms_fresh(kern, restore(gk), 20)
    lanes_ms = cuda_ms_fresh(lanes, restore(gu), 5)
    plain_ms = cuda_ms_fresh(plain, restore(gp), 3)
    with fp32_matmul():
        lib_ms = cuda_ms(lib, 20)
    one_ms, bound_by = bound(name, wa, g, [x[0] for x in grids])
    bound_ms = LANES * one_ms
    shapes = "x".join(f"{r}:{c}" for r, c in (tuple(grids[s].shape[-2:]) for s in slots))
    print(f"time  {name:6s}_stacked B={LANES} tiles={shapes} tasks={g.size:3d}: kernel_ms={ms:.4f} "
          f"{LANES}_unstacked_launches_ms={lanes_ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) max_abs_err={err:.3e} random_grids_max_abs_err={err_random:.3e}")
    return dict(tasks=g.size, err=max(err, err_random), ms=ms, unstacked_ms=lanes_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def stacked_timings(torch, tl, rng) -> dict:
    """Phase 2d: each kernel's stacked form at its largest group of the
    served templates (n = 1024, 8 x 8; the Cholesky four in the Cholesky
    plan, GETRF/TRSML/TRSMU/GEMMNN in the LU plan, TRSMUL in the vector-b
    LU-solve plan) over LANES lanes."""
    from repro_torch.core import dd_matrix, spd_matrix
    from repro_torch.linalg import GETRF, LUSOLVE, POTRF

    b = SN // SP
    a_spec = ((SN, SN), ((SP, SP),))
    chol = plan_groups(POTRF, [a_spec])
    lu = plan_groups(GETRF, [a_spec])
    solve = plan_groups(LUSOLVE, [a_spec, ((SN, 1), ((SP, 1),))])
    spd = [lane_grids(torch, spd_matrix, SN, b, LANES)]
    dd = [lane_grids(torch, dd_matrix, SN, b, LANES)]
    gen = torch.Generator().manual_seed(2)
    rhs = torch.randn(LANES, SP, 1, b, 1, generator=gen).cuda()
    out = {}
    for name in CHOLESKY:
        out[name] = stacked_timing(torch, tl, rng, name, chol, spd)
    for name in ("getrf", "trsml", "trsmu", "gemmnn"):
        out[name] = stacked_timing(torch, tl, rng, name, lu, dd)
    out["trsmul"] = stacked_timing(torch, tl, rng, "trsmul", solve, dd + [rhs])
    return out


# --------------------------------------------------------------------------
# Phases 3 and 4: the main paths
# --------------------------------------------------------------------------
TASK_BINS = (1, 4, 16, 64, 256, 1024, 4096)  # upper edges of the CTAs-per-launch bins


def by_launch_size(prof, path: Path) -> str:
    """Device time of each kernel split by its launches' CTA counts (tasks
    times lanes per launch, binned), read from the profiler's trace written
    to ``path``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    bins = {}
    for ev in trace.get("traceEvents", []) if isinstance(trace, dict) else trace:
        grid = ev.get("args", {}).get("grid") if ev.get("cat") == "kernel" else None
        m = re.search(r"(\w+)_kernel\b", ev.get("name", ""))
        if grid is None or not m or m.group(1) not in KERNELS:
            continue
        tasks = grid[0] * (grid[1] if len(grid) > 1 else 1)
        hi = next((e for e in TASK_BINS if tasks <= e), tasks)
        lo = max((e + 1 for e in TASK_BINS if e < hi), default=1)
        key = (m.group(1), lo, hi)
        n, us = bins.get(key, (0, 0.0))
        bins[key] = (n + 1, us + ev["dur"])
    if not bins:
        return "no kernel launch sizes in the trace (not measured)"
    return " ".join(f"{k}[{lo}-{hi}]={us / 1e3:.3f}ms/{n}" for (k, lo, hi), (n, us) in sorted(bins.items()))


def profiled(torch, label: str, run) -> None:
    """Where one run's time goes: device time by kernel from torch.profiler,
    the union of device-busy intervals, the idle share of the device span
    (first kernel start to last kernel end), and the host's dispatch time
    (``run()`` returning) beside the wall time (the card done).  ``run``
    returns a string of its own counters to print."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        info = run()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        tr = ev.time_range
        spans.append((tr.start, tr.end))
        m = re.search(r"(\w+)_kernel\b", ev.name)
        name = m.group(1) if m and m.group(1) in KERNELS else "other"
        n, us = by.get(name, (0, 0.0))
        by[name] = (n + 1, us + tr.elapsed_us())
    if not spans:
        print(f"{label} profile: no device events recorded (wall_ms={wall_ms:.3f}); device time not measured")
        return
    spans.sort()
    busy, (cs, ce) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > ce:
            busy, cs, ce = busy + (ce - cs), s0, e0
        else:
            ce = max(ce, e0)
    busy += ce - cs
    span = max(e for _, e in spans) - spans[0][0]
    parts = " ".join(f"{k}={v[1] / 1e3:.3f}ms/{v[0]}" for k, v in sorted(by.items()))
    print(f"{label} profile (profiler on): {info} wall_ms={wall_ms:.3f} host_dispatch_ms={host_ms:.3f} "
          f"device_span_ms={span / 1e3:.3f} device_busy_ms={busy / 1e3:.3f} "
          f"idle_share_of_span={1 - busy / span:.3f} by_kernel: {parts}")
    trace = ROOT / "build" / "traces" / f"{re.sub(r'[^0-9A-Za-z]+', '_', label).strip('_')}.json"
    print(f"{label} device time by CTAs per launch: {by_launch_size(prof, trace)}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:6]
    print(f"{label} host ops by self time (profiler on): "
          + " ".join(f"{e.key}={e.self_cpu_time_total / 1e3:.3f}ms/{e.count}" for e in host))


def replay_breakdown(torch, label: str, submit) -> None:
    """``profiled`` over one replay drain: ``submit`` puts a structurally
    repeated drain's roots on a fresh dispatcher."""
    from repro_torch.core import Dispatcher

    d = Dispatcher(graph="g2p")
    submit(d)

    def run():
        d.run()
        return f"memo_hits={d.stats['memo_hits']}"

    profiled(torch, f"{label} replay", run)


def drain_checked(torch, tl, label: str, submit, want: tuple, want_launches: dict, error, tol: float,
                  flops: float):
    """Drain one g2p program between zeroed and read kernel counters; check
    its structural counters, its kernel launches and its error."""
    from repro_torch.core import Dispatcher

    d = Dispatcher(graph="g2p")
    datas = submit(d)
    torch.cuda.synchronize()
    tl.reset_launches()
    t0 = time.perf_counter()
    leaves = d.run()
    t_host = time.perf_counter() - t0
    d.executor.sync()  # the drain's launch list, still in flight
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in tl.LAUNCHES.items() if v}
    err = error(*datas)
    st = d.executor.stats
    print(f"{label} drain: leaves={leaves} groups={st['groups']} prefusion={st['groups_prefusion']} "
          f"slots={st['slots']} compiles={st.get('compiles', 0)} launches={st['launches']} "
          f"memo_hits={d.stats['memo_hits']} kernel_launches={counts} wall_s={wall:.4f} "
          f"host_dispatch_s={t_host:.4f} gflops={flops / wall / 1e9:.1f} max_abs_err_vs_f64={err:.3e}")
    if err > tol:
        raise AssertionError(f"{label} drain error {err:.3e} > {tol}")
    got = (leaves, st["groups"], st["groups_prefusion"], st["slots"], st.get("compiles", 0),
           st["launches"], d.stats["memo_hits"])
    if got != want:
        raise AssertionError(f"{label} counters {got} != {want}")
    if counts != want_launches:
        raise AssertionError(f"{label} kernel launches {counts} != {want_launches}")
    return counts


def main_path(torch, tl) -> dict:
    """Phase 3: the Cholesky g2p drain twice (first drain, memo replay), then g2/g1."""
    from repro_torch.core import GData, spd_matrix
    from repro_torch.core.data import from_grid
    from repro_torch.core.executors import clear_compile_cache, drain_memo_stats
    from repro_torch.linalg import run_cholesky, utp_cholesky

    a = spd_matrix(N, seed=0)
    ref = torch.linalg.cholesky(a.double())
    clear_compile_cache()
    launches = {k: 0 for k in tl.LAUNCHES}

    def submit(d):
        A = GData(a.shape, partitions=((P, P),), value=a)
        utp_cholesky(d, A)
        return (A,)

    def error(A):
        return (torch.tril(from_grid(A.grid)).double() - ref).abs().max().item()

    for drain in ("first", "replay"):
        first = drain == "first"
        want = (5984, 124, 124, 94, int(first), 1, int(not first))
        counts = drain_checked(torch, tl, f"g2p {drain:6s}", submit, want, EXPECTED_LAUNCHES, error, 2e-4,
                               N**3 / 3)
        for k, v in counts.items():
            launches[k] += v
    print(f"drain memo: {drain_memo_stats()}")
    replay_breakdown(torch, "cholesky", submit)
    replay_ms = cuda_ms(lambda: run_cholesky(a, graph="g2p", partitions=((P, P),)), 3, warmup=1)
    lib_ms = cuda_ms(lambda: torch.linalg.cholesky(a), 10)
    print(f"g2p run_cholesky (memo replay, incl. ingest and de-grid) ms={replay_ms:.3f}; "
          f"library torch.linalg.cholesky ms={lib_ms:.3f}")

    t0 = time.perf_counter()
    L2 = run_cholesky(a, graph="g2", partitions=((P, P),))
    torch.cuda.synchronize()
    t_g2 = time.perf_counter() - t0
    e2 = (L2.double() - ref).abs().max().item()
    g2_ms = cuda_ms(lambda: run_cholesky(a, graph="g2", partitions=((P, P),)), 3, warmup=1)
    print(f"g2  n={N}: first wall_s={t_g2:.4f} replay ms={g2_ms:.3f} max_abs_err_vs_f64={e2:.3e}")
    if e2 > 2e-4:
        raise AssertionError(f"g2 error {e2:.3e} > 2e-4")
    a1 = spd_matrix(256, seed=256)
    L1 = run_cholesky(a1, graph="g1", partitions=((4, 4),))
    e1 = (L1.double() - torch.linalg.cholesky(a1.double())).abs().max().item()
    print(f"g1  n=256: max_abs_err_vs_f64={e1:.3e}")
    if e1 > 2e-4:
        raise AssertionError(f"g1 error {e1:.3e} > 2e-4")
    return launches


def lu_main_path(torch, tl) -> dict:
    """Phase 4: run_lu's and run_lu_solve's g2p drains (the first drain and a
    memo replay; the vector RHS once), a profiled replay, g2 and g1."""
    import numpy as np

    from repro_torch.core import GData, dd_matrix
    from repro_torch.core.data import from_grid
    from repro_torch.kernels.ref import fp32_matmul
    from repro_torch.linalg import run_inv, run_lu, run_lu_solve, utp_getrf, utp_lu_solve

    a = dd_matrix(N, seed=0)
    bm = torch.from_numpy(np.random.default_rng(0).standard_normal((N, RHS)).astype(np.float32)).cuda()
    bv = bm[:, 0].contiguous()
    a64 = a.double()
    ref_lu = torch.linalg.lu_factor_ex(a64, pivot=False).LU  # float64 reference only
    ref_xm = torch.linalg.solve(a64, bm.double())
    ref_xv = torch.linalg.solve(a64, bv.double()[:, None])
    launches = {k: 0 for k in tl.LAUNCHES}

    def lu_submit(d):
        A = GData(a.shape, partitions=((P, P),), value=a)
        utp_getrf(d, A)
        return (A,)

    def solve_submit(rhs, parts):
        def submit(d):
            A = GData(a.shape, partitions=((P, P),), value=a)
            B = GData(tuple(rhs.shape), partitions=parts, value=rhs)
            utp_lu_solve(d, A, B)
            return (B,)

        return submit

    def grid_error(ref):
        return lambda X: (from_grid(X.grid).double() - ref).abs().max().item()

    lu_launches = {"getrf": 32, "trsml": 31, "trsmu": 31, "gemmnn": 31}
    solve_launches = {"getrf": 32, "trsml": 32, "trsmu": 31, "trsmul": 32, "gemmnn": 527}
    vec_launches = {"getrf": 32, "trsml": 63, "trsmu": 31, "trsmul": 32, "gemmnn": 558}
    matrix = solve_submit(bm, ((P, RHS_P),))
    runs = [
        ("g2p run_lu first ", lu_submit, (11440, 125, 125, 94, 1, 1, 0), lu_launches, grid_error(ref_lu), 2e-4,
         2 * N**3 / 3),
        ("g2p run_lu replay", lu_submit, (11440, 125, 125, 94, 0, 1, 1), lu_launches, grid_error(ref_lu), 2e-4,
         2 * N**3 / 3),
        (f"g2p lu_solve b=({N},{RHS}) first ", matrix, (15664, 654, 716, 623, 1, 1, 0), solve_launches,
         grid_error(ref_xm), 1e-3, 2 * N**3 / 3 + 2 * N * N * RHS),
        (f"g2p lu_solve b=({N},{RHS}) replay", matrix, (15664, 654, 716, 623, 0, 1, 1), solve_launches,
         grid_error(ref_xm), 1e-3, 2 * N**3 / 3 + 2 * N * N * RHS),
        (f"g2p lu_solve b=({N},) first", solve_submit(bv[:, None], ((P, 1),)), (12496, 716, 716, 623, 1, 1, 0),
         vec_launches, grid_error(ref_xv), 1e-3, 2 * N**3 / 3 + 2 * N * N),
    ]
    for label, submit, want, want_launches, error, tol, flops in runs:
        counts = drain_checked(torch, tl, label, submit, want, want_launches, error, tol, flops)
        for k, v in counts.items():
            launches[k] += v
    replay_breakdown(torch, f"lu_solve b=({N},{RHS})", matrix)

    lu_ms = cuda_ms(lambda: run_lu(a, graph="g2p", partitions=((P, P),)), 3, warmup=1)
    solve_ms = cuda_ms(lambda: run_lu_solve(a, bm, graph="g2p", partitions=((P, P),),
                                            b_partitions=((P, RHS_P),)), 3, warmup=1)
    sl = torch.linalg.solve_triangular

    def library_solve():
        lu = torch.linalg.lu_factor_ex(a, pivot=False).LU
        return sl(lu, sl(lu, bm, upper=False, left=True, unitriangular=True), upper=True, left=True)

    with fp32_matmul():
        lib_lu_ms = cuda_ms(lambda: torch.linalg.lu_factor_ex(a, pivot=False), 10)
        lib_solve_ms = cuda_ms(library_solve, 10)
        e_lib = (library_solve().double() - ref_xm).abs().max().item()
    print(f"g2p run_lu (memo replay, incl. ingest and unpack) ms={lu_ms:.3f}; library lu_factor_ex(pivot=False) "
          f"ms={lib_lu_ms:.3f}")
    print(f"g2p run_lu_solve b=({N},{RHS}) (memo replay, incl. ingest and de-grid) ms={solve_ms:.3f}; library "
          f"lu_factor_ex(pivot=False) + 2 solve_triangular ms={lib_solve_ms:.3f} (its max_abs_err_vs_f64={e_lib:.3e})")

    t0 = time.perf_counter()
    x2 = run_lu_solve(a, bm, graph="g2", partitions=((P, P),), b_partitions=((P, RHS_P),))
    torch.cuda.synchronize()
    t_g2 = time.perf_counter() - t0
    e2 = (x2.double() - ref_xm).abs().max().item()
    print(f"g2  lu_solve b=({N},{RHS}): first wall_s={t_g2:.4f} max_abs_err_vs_f64={e2:.3e}")
    if e2 > 1e-3:
        raise AssertionError(f"g2 lu_solve error {e2:.3e} > 1e-3")
    a1 = dd_matrix(256, seed=256)
    inv = run_inv(a1, graph="g1", partitions=((4, 4),))
    e1 = (inv.double() @ a1.double() - torch.eye(256, dtype=torch.float64, device=a1.device)).abs().max().item()
    print(f"g1  run_inv n=256: max_abs_err of inv @ a vs I={e1:.3e}")
    if e1 > 1e-4:
        raise AssertionError(f"g1 run_inv error {e1:.3e} > 1e-4")
    return launches


# --------------------------------------------------------------------------
# Phase 5: serving
# --------------------------------------------------------------------------
def serving_path(torch, tl) -> dict:
    """Phase 5: ``BatchServer(graph="g2p", max_batch=64)`` answers SERVED
    requests a tick (three signature buckets, one stacked launch list
    each): tick 1 captures, ticks 2-4 (fresh inputs) replay with every
    stacked-launch count zeroed before the tick and read after; then a
    profiled repeat tick, the same tick on g2, the same solves as
    sequential ``run_lu_solve`` replays and as one batched library call,
    and the fault rounds.  Returns the stacked launches of ticks 2-4."""
    import numpy as np

    from repro_torch.core import dd_matrix, spd_matrix
    from repro_torch.errors import InflightError, NumericalError
    from repro_torch.kernels.ref import fp32_matmul
    from repro_torch.linalg import run_lu_solve
    from repro_torch.serve import BatchServer
    from repro_torch.testing import faults

    kind_of = {"lu_solve": "lu_solve", "getrf": "lu", "potrf": "cholesky"}
    parts = ((SP, SP),)

    class Observed(BatchServer):
        """A BatchServer that keeps each chunk drain's template counters."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.drained = []

        def _drain_chunk(self, chunk):
            d, h = super()._drain_chunk(chunk)
            st = d.executor.stats
            self.drained.append((kind_of[chunk[0].op.name], len(chunk),
                                 (h.leaves, st["groups"], st["groups_prefusion"], st["slots"])))
            return d, h

    rng = np.random.default_rng(5)

    def requests(tick: int):
        """One tick's requests as host tensors, as callers send them."""
        base = 1000 * tick
        return {
            "lu_solve": [(dd_matrix(SN, seed=base + i, device="cpu"),
                          torch.from_numpy(rng.standard_normal(SN).astype(np.float32)))
                         for i in range(SERVED["lu_solve"])],
            "lu": [dd_matrix(SN, seed=base + 100 + i, device="cpu") for i in range(SERVED["lu"])],
            "cholesky": [spd_matrix(SN, seed=base + 200 + i, device="cpu") for i in range(SERVED["cholesky"])],
        }

    def submit(srv, reqs):
        return {
            "lu_solve": [srv.lu_solve(a, b, partitions=parts) for a, b in reqs.get("lu_solve", ())],
            "lu": [srv.lu(a, partitions=parts) for a in reqs.get("lu", ())],
            "cholesky": [srv.cholesky(a, partitions=parts) for a in reqs.get("cholesky", ())],
        }

    def backward(residual, scale, n: int) -> float:
        """Largest componentwise backward error |residual| / scale in units
        of fp32's unit roundoff u; raises above n / (1 - n u), the bound of a
        blocked LU or Cholesky in fp32 with conventional products
        (|LU - A| <= gamma_n |L||U|, Higham, Accuracy and Stability of
        Numerical Algorithms, Thms 9.3 and 10.3).  On these near-diagonal
        inputs the absolute bounds alone would pass a factor that skipped
        a trailing update; this one would not."""
        u = 2.0**-24
        ratio = (residual.abs() / scale.clamp_min(1e-300)).max().item() / u
        if not ratio <= n / (1 - n * u):
            raise AssertionError(f"componentwise backward error {ratio:.1f} u exceeds gamma_{n} = {n} u")
        return ratio

    def errors(reqs, futs, skip=()):
        """Max abs error of each kind's results against float64 references
        (pivot-free LU factor, Cholesky factor, solution), and for the
        factors their componentwise backward error (``backward``)."""
        out = {}
        if reqs.get("lu_solve"):
            keep = [i for i in range(len(reqs["lu_solve"])) if i not in skip]
            a = torch.stack([reqs["lu_solve"][i][0] for i in keep]).cuda().double()
            b = torch.stack([reqs["lu_solve"][i][1] for i in keep]).cuda().double()
            ref = torch.linalg.solve(a, b[..., None])[..., 0]
            x = torch.stack([futs["lu_solve"][i].result() for i in keep]).double()
            out["lu_solve"] = (x - ref).abs().max().item()
        if reqs.get("lu"):
            a = torch.stack(reqs["lu"]).cuda().double()
            ref = torch.linalg.lu_factor_ex(a, pivot=False).LU
            lo, up = (torch.stack(f).double() for f in zip(*(f.result() for f in futs["lu"])))
            out["lu"] = (torch.tril(lo, -1) + up - ref).abs().max().item()
            out["lu_backward_u"] = backward(lo @ up - a, lo.abs() @ up.abs(), SN)
        if reqs.get("cholesky"):
            a = torch.stack(reqs["cholesky"]).cuda().double()
            ref = torch.linalg.cholesky(a)
            lo = torch.stack([f.result() for f in futs["cholesky"]]).double()
            out["cholesky"] = (lo - ref).abs().max().item()
            out["cholesky_backward_u"] = backward(lo @ lo.mT - a, lo.abs() @ lo.abs().mT, SN + 1)
        for kind, e in out.items():
            if kind.endswith("_backward_u"):
                continue
            if e > (1e-3 if kind == "lu_solve" else 2e-4):
                raise AssertionError(f"served {kind} error {e:.3e} exceeds its bound")
        return out

    def tick(srv, label: str, reqs):
        """Submit (ingest through pinned memory), wait for the copies, then
        one tick between zeroed and read launch counts: the tick's host
        wall time, the card done, the event span on the stream."""
        t0 = time.perf_counter()
        futs = submit(srv, reqs)
        submit_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        tl.reset_launches()
        srv.drained.clear()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        rep = srv.tick()
        tick_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        done_ms = (time.perf_counter() - t0) * 1e3
        stacked = dict(tl.STACKED_LAUNCHES)
        unstacked = {k: v for k, v in tl.LAUNCHES.items() if v}
        print(f"{label}: requests={rep.requests} resolved={rep.resolved} failed={rep.failed} buckets={rep.buckets} "
              f"launches={rep.launches} compiles={rep.compiles} stacked_drains={rep.stacked_drains} "
              f"memo_hits={rep.memo_hits} bisected={rep.bisected} host_idle_us={rep.host_idle_us:.1f} "
              f"submit_ms={submit_ms:.3f} tick_wall_ms={tick_ms:.3f} card_done_ms={done_ms:.3f} "
              f"event_span_ms={start.elapsed_time(end):.3f} stacked_launches={stacked} "
              f"unstacked_launches={unstacked}")
        return rep, futs, stacked

    srv = Observed(graph="g2p", max_batch=LANES)
    reqs = requests(1)
    rep, futs, _ = tick(srv, "serve g2p tick 1 (capture)", reqs)
    if (rep.compiles, rep.launches, rep.stacked_drains, rep.resolved) != (3, 3, 3, sum(SERVED.values())):
        raise AssertionError(f"capture tick counters {rep}")
    launches = {k: 0 for k in KERNELS}
    for t in (2, 3, 4):
        reqs = requests(t)
        rep, futs, stacked = tick(srv, f"serve g2p tick {t} (replay)", reqs)
        got = (rep.compiles, rep.launches, rep.stacked_drains, rep.resolved, rep.failed, rep.host_idle_us)
        if got != (0, 3, 3, sum(SERVED.values()), 0, 0):
            raise AssertionError(f"tick {t}: (compiles, launches, stacked_drains, resolved, failed, "
                                 f"host_idle_us) = {got}")
        missing = [k for k in KERNELS if not stacked[k]]
        if missing:
            raise AssertionError(f"tick {t}: no stacked launch of {missing}")
        for k in KERNELS:
            launches[k] += stacked[k]
        counters = {kind: c for kind, _, c in srv.drained}
        if counters != TEMPLATES or sorted(n for _, n, _ in srv.drained) != sorted(SERVED.values()):
            raise AssertionError(f"tick {t}: bucket templates {srv.drained} != {TEMPLATES}")
        errs = errors(reqs, futs)
        print(f"serve g2p tick {t}: templates (leaves, groups, prefusion, slots) {counters}; "
              f"max_abs_err_vs_f64 and backward error in units of fp32 roundoff (_backward_u) "
              + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))

    reqs = requests(5)
    futs = submit(srv, reqs)

    def profiled_tick():
        rep = srv.tick()
        return (f"launches={rep.launches} compiles={rep.compiles} stacked_drains={rep.stacked_drains} "
                f"resolved={rep.resolved}")

    profiled(torch, "serve g2p repeat tick", profiled_tick)
    errors(reqs, futs)

    g2 = Observed(graph="g2", max_batch=LANES)
    tick(g2, "serve g2 tick 1 (capture)", requests(6))
    reqs = requests(7)
    rep, futs, _ = tick(g2, "serve g2 tick 2 (replay, library leaves)", reqs)
    errors(reqs, futs)

    solve = [(a.cuda(), b.cuda()) for a, b in requests(8)["lu_solve"]]
    run_lu_solve(*solve[0], graph="g2p", partitions=parts)  # capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a, b in solve:
        run_lu_solve(a, b, graph="g2p", partitions=parts)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    A = torch.stack([a for a, _ in solve])
    Bm = torch.stack([b for _, b in solve])[..., None]
    sl = torch.linalg.solve_triangular

    def library():
        lu = torch.linalg.lu_factor_ex(A, pivot=False).LU
        return sl(lu, sl(lu, Bm, upper=False, left=True, unitriangular=True), upper=True, left=True)

    with fp32_matmul():
        lib_ms = cuda_ms(library, 5)
    print(f"{LANES} sequential g2p run_lu_solve memo replays (device inputs) ms={seq_ms:.3f}; library "
          f"lu_factor_ex(pivot=False) + 2 solve_triangular on ({LANES}, {SN}, {SN}) ms={lib_ms:.3f}")

    # fault rounds: check_finite on, no retries; an expected error on a
    # future is a result, and is asserted
    fsrv = Observed(graph="g2p", max_batch=LANES, check_finite=True, max_retries=0)
    reqs = {"lu_solve": requests(9)["lu_solve"]}
    a_bad = reqs["lu_solve"][3][0].clone()
    a_bad[0, 0] = float("nan")
    reqs["lu_solve"][3] = (a_bad, reqs["lu_solve"][3][1])
    rep, futs, _ = tick(fsrv, "serve fault round 1 (NaN in request 3)", reqs)
    if not isinstance(futs["lu_solve"][3].exception(), NumericalError) or (rep.resolved, rep.failed) != (63, 1):
        raise AssertionError(f"NaN round: {futs['lu_solve'][3].exception()!r} resolved={rep.resolved}")
    e1 = errors(reqs, futs, skip={3})
    reqs = {"lu_solve": requests(10)["lu_solve"]}
    futs = submit(fsrv, reqs)
    target = futs["lu_solve"][5].rid
    with faults.inject("drain.inflight", RuntimeError("injected in-flight failure"),
                       when=lambda ctx: target in ctx.get("rids", ()), times=None):
        reps = [fsrv.tick()]
        while fsrv.pending() and len(reps) < 4:
            reps.append(fsrv.tick())
    bisected = sum(r.bisected for r in reps)
    err = futs["lu_solve"][5].exception()
    if not isinstance(err, InflightError) or bisected == 0 or fsrv.pending():
        raise AssertionError(f"in-flight round: {err!r} bisected={bisected} pending={fsrv.pending()}")
    e2 = errors(reqs, futs, skip={5})
    print(f"serve fault round 1: request 3 failed with NumericalError, 63 resolved, max_abs_err={e1['lu_solve']:.3e}; "
          f"round 2: drain.inflight on request 5 -> {type(err).__name__}, bisected={bisected}, ticks={len(reps)}, "
          f"resolved={sum(r.resolved for r in reps)} max_abs_err={e2['lu_solve']:.3e}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.kernels import tile_linalg as tl

    if set(KERNELS) != set(tl.LAUNCHES):
        raise AssertionError(f"chip_smoke checks {KERNELS}, the port has {sorted(tl.LAUNCHES)}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    reports = _build.build(["tile_linalg"])
    print(f"kernel build s={time.perf_counter() - t0:.2f} (built: {sorted(reports) or 'cached'})")
    for log in reports.values():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())

    rng = np.random.default_rng(0)
    errs = kernel_checks(torch, tl, rng)
    stacked_errs = stacked_checks(torch, tl, rng)
    times = kernel_timings(torch, tl)
    stacked_times = stacked_timings(torch, tl, rng)
    launches = main_path(torch, tl)
    for k, v in lu_main_path(torch, tl).items():
        launches[k] += v
    stacked_launches = serving_path(torch, tl)

    kernels = []
    for name in KERNELS:
        t = times[name]
        if launches[name] == 0:
            raise AssertionError(f"{name} was launched no time on its main path")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": max(errs[name], t["err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "tasks": t["tasks"],
        })
    for name in KERNELS:
        t = stacked_times[name]
        if stacked_launches[name] == 0:
            raise AssertionError(f"{name}_stacked was launched no time on the serving path")
        kernels.append({
            "name": f"{name}_stacked", "route": "cuda", "source": SOURCE, "replaces": STACKED_REPLACES,
            "launches": stacked_launches[name], "max_abs_err": max(stacked_errs[name], t["err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "tasks": t["tasks"], "lanes": LANES,
            "unstacked_launches_ms": t["unstacked_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
