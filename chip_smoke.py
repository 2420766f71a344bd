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
   and in the batched form.  Then each is timed at the main path's shapes
   (the largest group of that kernel in the n = 4096, 32 x 32 plan of
   Cholesky, of LU, or for TRSMUL of the matrix-RHS LU solve, on the
   resident grids) beside its plain version, one PyTorch library call
   computing the same group, and the least time the card could take (its
   bound).
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
    "potrf": f"{_TL}:181 batched_potrf; :408 make_grid_fused (grid_potrf :444)",
    "trsm": f"{_TL}:201 batched_trsm; :408 make_grid_fused (grid_trsm :445)",
    "syrk": f"{_TL}:223 batched_syrk; :408 make_grid_fused (grid_syrk :446)",
    "gemm": f"{_TL}:242 batched_gemm; :408 make_grid_fused (grid_gemm :447)",
    "getrf": f"{_TL}:265 batched_getrf; :408 make_grid_fused (grid_getrf :448)",
    "trsml": f"{_TL}:282 batched_trsml; :408 make_grid_fused (grid_trsml :449)",
    "trsmu": f"{_TL}:302 batched_trsmu; :408 make_grid_fused (grid_trsmu :450)",
    "trsmul": f"{_TL}:321 batched_trsmul; :408 make_grid_fused (grid_trsmul :451)",
    "gemmnn": f"{_TL}:340 batched_gemmnn; :408 make_grid_fused (grid_gemmnn :452)",
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


def grid_case(tl, name: str, rng, b: int, bc: int, nr: int = 6, nc: int = 7, n: int = 12):
    """Random non-square grids, one per distinct tile shape (arguments of one
    shape address one grid, as in a single-root drain); distinct write
    blocks, the written grid's read blocks drawn from the rest."""
    import numpy as np

    shapes = tl.tile_shapes(name, b, bc)
    w = tl.GRID_FUSED[name][1]
    grid_of, grids = {}, []
    for s in shapes:
        if s not in grid_of:
            grid_of[s] = len(grids)
            grids.append(rng.standard_normal((nr, nc) + s).astype(np.float32) * 0.3)
    blocks = rng.permutation(nr * nc)
    writes, rest = blocks[:n], blocks[n:]
    flat = []
    for a, s in enumerate(shapes):
        same = grid_of[s] == grid_of[shapes[w]]
        flat.append(writes if a == w else rng.choice(rest if same else np.arange(nr * nc), n))
    blk = np.unique(flat[0])
    tiles = special_tiles(name, rng, len(blk), b)
    if tiles is not None:
        grids[grid_of[shapes[0]]].reshape(-1, b, b)[blk] = tiles
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


# --------------------------------------------------------------------------
# Phases 3 and 4: the main paths
# --------------------------------------------------------------------------
TASK_BINS = (1, 4, 16, 64, 256, 1024, 4096)  # upper edges of the tasks-per-launch bins


def by_launch_size(prof, path: Path) -> str:
    """Device time of each kernel split by its launches' CTA counts (tasks
    per launch, binned), read from the profiler's trace written to ``path``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    bins = {}
    for ev in trace.get("traceEvents", []) if isinstance(trace, dict) else trace:
        grid = ev.get("args", {}).get("grid") if ev.get("cat") == "kernel" else None
        m = re.search(r"(\w+)_kernel\b", ev.get("name", ""))
        if grid is None or not m or m.group(1) not in KERNELS:
            continue
        tasks = grid[0]
        hi = next((e for e in TASK_BINS if tasks <= e), tasks)
        lo = max((e + 1 for e in TASK_BINS if e < hi), default=1)
        key = (m.group(1), lo, hi)
        n, us = bins.get(key, (0, 0.0))
        bins[key] = (n + 1, us + ev["dur"])
    if not bins:
        return "no kernel launch sizes in the trace (not measured)"
    return " ".join(f"{k}[{lo}-{hi}]={us / 1e3:.3f}ms/{n}" for (k, lo, hi), (n, us) in sorted(bins.items()))


def replay_breakdown(torch, label: str, submit) -> None:
    """Where one replay drain's time goes: device time by kernel from
    torch.profiler, the union of device-busy intervals, and the idle share
    of the device span (first kernel start to last kernel end).  ``submit``
    puts a structurally repeated drain's roots on a fresh dispatcher."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Dispatcher

    d = Dispatcher(graph="g2p")
    submit(d)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        d.run()
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
        print(f"{label} replay profile: no device events recorded (wall_ms={wall_ms:.3f}); "
              "device time not measured")
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
    print(f"{label} replay profile (profiler on): memo_hits={d.stats['memo_hits']} wall_ms={wall_ms:.3f} "
          f"device_span_ms={span / 1e3:.3f} device_busy_ms={busy / 1e3:.3f} "
          f"idle_share_of_span={1 - busy / span:.3f} by_kernel: {parts}")
    trace = ROOT / "build" / "traces" / f"{re.sub(r'[^0-9A-Za-z]+', '_', label).strip('_')}.json"
    print(f"{label} replay device time by tasks per launch: {by_launch_size(prof, trace)}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:6]
    print(f"{label} replay host ops by self time (profiler on): "
          + " ".join(f"{e.key}={e.self_cpu_time_total / 1e3:.3f}ms/{e.count}" for e in host))


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
    d.executor.epoch.wait()  # the drain's launch list, still in flight
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
    times = kernel_timings(torch, tl)
    launches = main_path(torch, tl)
    for k, v in lu_main_path(torch, tl).items():
        launches[k] += v

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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
