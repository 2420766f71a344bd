#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase catches its own):

1. Environment: torch/CUDA versions, the card's name and power limit, and
   the build of the hand-written kernels from ``src/repro_torch/kernels/csrc``.
2. Kernels: each of the four Cholesky tile kernels (POTRF, TRSM, SYRK, GEMM)
   is held against its plain PyTorch version on the card at b = 8 ... 128,
   in the fused-grid form (random distinct write blocks on a random
   non-square grid, all arguments in one grid) and in the batched form.
   Then each is timed at the main path's shapes (the largest group of that
   kernel in the n = 4096, 32 x 32 plan, on the resident grid) beside its
   plain version, one PyTorch library call computing the same group, and
   the least time the card could take (its bound).
3. Main path: blocked Cholesky of a 4096 x 4096 fp32 SPD matrix on graph g2p
   with 32 x 32 partitions (128 x 128 tiles), drained twice (first drain,
   then a drain-memo replay), checked against float64 ``torch.linalg.cholesky``
   and the structural counters; kernel launch counters are zeroed right
   before each drain and read right after.  Then g2 at the same size and g1
   at n = 256 through ``run_cholesky``.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository beside it, the script fails before printing it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, P = 4096, 32  # main path: n x n fp32, P x P partitions -> 128 x 128 tiles
TILES = (8, 16, 32, 64, 128)
# the reference tests' tolerances (tests/test_kernels.py), atol = rtol
TOL = {"potrf": 2e-4, "trsm": 2e-3, "syrk": 1e-4, "gemm": 1e-4}
ARITY = {"potrf": 1, "trsm": 2, "syrk": 2, "gemm": 3}
WRITE_ARG = {"potrf": 0, "trsm": 1, "syrk": 1, "gemm": 2}
REPLACES = {
    "potrf": "src/repro/kernels/tile_linalg.py:181 batched_potrf; :408 make_grid_fused (grid_potrf :444)",
    "trsm": "src/repro/kernels/tile_linalg.py:201 batched_trsm; :408 make_grid_fused (grid_trsm :445)",
    "syrk": "src/repro/kernels/tile_linalg.py:223 batched_syrk; :408 make_grid_fused (grid_syrk :446)",
    "gemm": "src/repro/kernels/tile_linalg.py:242 batched_gemm; :408 make_grid_fused (grid_gemm :447)",
}
SOURCE = "src/repro_torch/kernels/csrc/tile_linalg.cu"
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


def kernel_checks(torch, tl, rng) -> dict:
    """Phase 2a: every kernel against its plain version, both forms."""
    import numpy as np

    err = {k: 0.0 for k in ARITY}
    nr, nc, n = 6, 7, 12
    for b in TILES:
        for name, arity in ARITY.items():
            w = WRITE_ARG[name]
            grid = rng.standard_normal((nr, nc, b, b)).astype(np.float32) * 0.3
            blocks = rng.permutation(nr * nc)
            writes, rest = blocks[:n], blocks[n:]
            flat = [rng.choice(rest, n) for _ in range(arity)]
            flat[w] = writes
            if name == "potrf":
                grid.reshape(-1, b, b)[writes] = spd_tiles(rng, n, b)
            if name == "trsm":
                ls = np.unique(flat[0])
                grid.reshape(-1, b, b)[ls] = lower_with_junk(rng, len(ls), b)
            idxs = [torch.tensor(np.stack([f // nc, f % nc], 1), dtype=torch.int32, device="cuda") for f in flat]
            g = torch.from_numpy(grid).cuda()
            gk, gp = g.clone(), g.clone()
            getattr(tl, f"grid_{name}")(idxs, [gk] * arity)
            getattr(tl, f"grid_{name}_plain")(idxs, [gp] * arity)
            torch.cuda.synchronize()
            e_grid = close(gk, gp, TOL[name])
            # batched form on (n, b, b) stacks
            if name == "potrf":
                stacks = [spd_tiles(rng, n, b)]
            elif name == "trsm":
                stacks = [lower_with_junk(rng, n, b), rng.standard_normal((n, b, b)).astype(np.float32) * 0.3]
            else:
                stacks = [rng.standard_normal((n, b, b)).astype(np.float32) * 0.3 for _ in range(arity)]
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
            print(f"check {name:5s} b={b:3d}: grid max_abs_err={e_grid:.3e} batched max_abs_err={e_bat:.3e} (tol {TOL[name]})")
    return err


def main_path_groups():
    """The n = 4096, 32 x 32 plan's groups, planned without executing."""
    from repro_torch.core import DepTracker, GData, GTask
    from repro_torch.core.executors import plan_schedule
    from repro_torch.linalg import POTRF

    A = GData((N, N), partitions=((P, P),), value=None, device="cuda")
    A.materialize()
    root = GTask(POTRF, None, [A.root_view()])
    children = []
    POTRF.split(root, children.append)
    tracker = DepTracker()
    for t in children:
        tracker.add(t)
    return list(plan_schedule(tracker.waves(), tracker.dag()).groups())


def bound(name: str, g, b: int):
    """Least time (ms) for one group: distinct input blocks read once, the
    written blocks written once, against the kernel's FLOPs at fp32 peak."""
    reads = set()
    for a, ix in enumerate(g.idxs):
        reads |= {(int(r), int(c)) for r, c in ix}
    n = g.size
    nbytes = (len(reads) + n) * b * b * 4
    flops = n * {"potrf": b**3 / 3, "trsm": b**3, "syrk": 2 * b**3, "gemm": 2 * b**3}[name]
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_timings(torch, tl, groups) -> dict:
    """Phase 2b: each kernel at the main path's shapes (its largest group),
    every timed call on the same fresh grid: the written blocks are put
    back before each call, untimed."""
    from repro_torch.core import spd_matrix
    from repro_torch.core.data import to_grid
    from repro_torch.kernels.ref import fp32_matmul

    grid = to_grid(spd_matrix(N, seed=1), N // P, N // P)
    b = N // P
    out = {}
    for name, arity in ARITY.items():
        g = max((g for g in groups if g.op.name == name), key=lambda g: g.size)
        idxs = [torch.from_numpy(ix).cuda() for ix in g.idxs]
        wr, wc = idxs[WRITE_ARG[name]].long().unbind(1)
        fresh = grid[wr, wc]
        gk, gp = grid.clone(), grid.clone()
        kern = lambda: getattr(tl, f"grid_{name}")(idxs, [gk] * arity)
        plain = lambda: getattr(tl, f"grid_{name}_plain")(idxs, [gp] * arity)
        kern()
        plain()
        torch.cuda.synchronize()
        err = close(gk, gp, TOL[name])
        stacks = [grid[ix[:, 0], ix[:, 1]] for ix in idxs]
        if name == "potrf":
            lib = lambda: torch.linalg.cholesky(stacks[0])
        elif name == "trsm":
            lstack = torch.linalg.cholesky(stacks[0])
            lib = lambda: torch.linalg.solve_triangular(lstack.mT, stacks[1], upper=True, left=False)
        elif name == "syrk":
            lib = lambda: torch.baddbmm(stacks[1], stacks[0], stacks[0].mT, alpha=-1)
        else:
            lib = lambda: torch.baddbmm(stacks[2], stacks[0], stacks[1].mT, alpha=-1)
        ms = cuda_ms_fresh(kern, lambda: gk.index_put_((wr, wc), fresh), 20)
        plain_ms = cuda_ms_fresh(plain, lambda: gp.index_put_((wr, wc), fresh), 3)
        with fp32_matmul():
            lib_ms = cuda_ms(lib, 20)  # out of place: its inputs stay fresh
        bound_ms, bound_by = bound(name, g, b)
        out[name] = dict(tasks=g.size, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"time  {name:5s} b={b} tasks={g.size:3d}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) max_abs_err={err:.3e}")
    return out


def replay_breakdown(torch, a) -> None:
    """Where one replay drain's time goes: device time by kernel from
    torch.profiler, the union of device-busy intervals, and the idle share
    of the device span (first kernel start to last kernel end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Dispatcher, GData
    from repro_torch.linalg import utp_cholesky

    d = Dispatcher(graph="g2p")
    A = GData(a.shape, partitions=((P, P),), value=a)
    utp_cholesky(d, A)
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
        name = next((k for k in ARITY if f"{k}_kernel" in ev.name), "other")
        n, us = by.get(name, (0, 0.0))
        by[name] = (n + 1, us + tr.elapsed_us())
    if not spans:
        print(f"replay profile: no device events recorded (wall_ms={wall_ms:.3f}); device time not measured")
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
    print(f"replay profile (profiler on): wall_ms={wall_ms:.3f} device_span_ms={span / 1e3:.3f} "
          f"device_busy_ms={busy / 1e3:.3f} idle_share_of_span={1 - busy / span:.3f} by_kernel: {parts}")


def main_path(torch, tl) -> dict:
    """Phase 3: the g2p drain twice (first drain, memo replay), then g2/g1."""
    from repro_torch.core import Dispatcher, GData, spd_matrix
    from repro_torch.core.data import from_grid
    from repro_torch.core.executors import clear_compile_cache, drain_memo_stats
    from repro_torch.linalg import run_cholesky, utp_cholesky

    a = spd_matrix(N, seed=0)
    ref = torch.linalg.cholesky(a.double())
    clear_compile_cache()
    launches = {k: 0 for k in tl.LAUNCHES}
    for drain in ("first", "replay"):
        d = Dispatcher(graph="g2p")
        A = GData(a.shape, partitions=((P, P),), value=a)
        utp_cholesky(d, A)
        torch.cuda.synchronize()
        tl.reset_launches()
        t0 = time.perf_counter()
        leaves = d.run()
        t_host = time.perf_counter() - t0
        d.executor.epoch.wait()  # the drain's launch list, still in flight
        wall = time.perf_counter() - t0
        counts = dict(tl.LAUNCHES)
        L = torch.tril(from_grid(A.grid))
        err = (L.double() - ref).abs().max().item()
        st = d.executor.stats
        print(f"g2p {drain:6s} drain: leaves={leaves} groups={st['groups']} prefusion={st['groups_prefusion']} "
              f"slots={st['slots']} compiles={st.get('compiles', 0)} launches={st['launches']} "
              f"memo_hits={d.stats['memo_hits']} kernel_launches={counts} wall_s={wall:.4f} "
              f"host_dispatch_s={t_host:.4f} gflops={N**3 / 3 / wall / 1e9:.1f} max_abs_err_vs_f64={err:.3e}")
        if err > 2e-4:
            raise AssertionError(f"g2p {drain} drain error {err:.3e} > 2e-4")
        want = (5984, 124, 124, 94, 1 if drain == "first" else 0, 1, 1 if drain == "replay" else 0)
        got = (leaves, st["groups"], st["groups_prefusion"], st["slots"], st.get("compiles", 0),
               st["launches"], d.stats["memo_hits"])
        if got != want:
            raise AssertionError(f"g2p {drain} counters {got} != {want}")
        if counts != EXPECTED_LAUNCHES:
            raise AssertionError(f"kernel launches {counts} != {EXPECTED_LAUNCHES} per drain")
        for k in launches:
            launches[k] += counts[k]
    print(f"drain memo: {drain_memo_stats()}")
    replay_breakdown(torch, a)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.kernels import tile_linalg as tl

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
    groups = main_path_groups()
    times = kernel_timings(torch, tl, groups)
    launches = main_path(torch, tl)

    kernels = []
    for name in ARITY:
        t = times[name]
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
