"""Groups of several segments on the fused grid path (B5, the grid-fused
tile form, for groups the planner fused across roots), on the CPU.

On the ``cuda`` backend every group of the nine tile operations calls the
operation's fused grid kernel with all of its segments, each its own grids:
one in-place launch on the card (a segment table per argument, at most
``tl.MAX_SEGMENTS`` segments a launch), where the JAX package gathers the
group's blocks, runs the batched kernel and scatters back.  Here the plain
version runs.  Checked: the plain multi-segment form equals the gather ->
batched leaf -> scatter form bit for bit for each operation, unstacked and
stacked; ``build_program`` routes every group of the matrix-RHS LU-solve
plan to the fused path on ``cuda`` and to the gather path on ``torch``; no
task of a multi-segment group writes a block another task of it reads or
writes; the solve, the inverse, ``run_lu_many`` and the stacked matrix-b
solve on ``CudaExecutor`` match the JAX package's on the same numpy inputs
within tests/test_lu.py's tolerances, through multi-segment fused calls
whose drains equal the gather path's bit for bit; and the segment packer
covers every task once, in order."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.linalg as jlin
import repro_torch.core as tcore
from repro_torch.core.data import to_grid
from repro_torch.core.executors import build_program, clear_compile_cache, plan_schedule
from repro_torch.kernels import _build
from repro_torch.kernels import tile_linalg as tl
from repro_torch.linalg import LUSOLVE, ops, run_inv, run_lu_many, run_lu_solve, run_lu_solve_batched

NAMES = list(tl.GRID_FUSED)
WIDE = ("trsml", "trsmu", "trsmul", "gemmnn")
LANES, NR = 3, 3


def _spd(rng, n, b):
    m = rng.standard_normal((n, b, b)).astype(np.float32) / np.float32(np.sqrt(b))
    return m @ m.transpose(0, 2, 1) + 2.0 * np.eye(b, dtype=np.float32)


def _dd(rng, n, b):
    a = rng.standard_normal((n, b, b)).astype(np.float32)
    a /= np.abs(a).sum(axis=1, keepdims=True) * 1.5
    a[:, np.arange(b), np.arange(b)] = 1.0 + rng.uniform(0.0, 1.0, (n, b)).astype(np.float32)
    return a


FACTOR = {"potrf": _spd, "getrf": _dd, "trsm": _dd, "trsml": _dd, "trsmu": _dd, "trsmul": _dd}


def _segments_case(name, nseg, lanes, seed):
    """``nseg`` segments of 2, 3, 4 tasks, each over grids of its own (nc =
    3, 4, 5 block columns; arguments of one tile shape share a grid, as one
    root's blocks do); each segment's write blocks distinct, its reads of
    the written grid drawn from the other blocks; the factor argument's
    blocks well conditioned.  Returns (index tensors, segments)."""
    rng = np.random.default_rng(seed)
    b, bc = 8, 3
    shapes = tl.tile_shapes(name, b, bc if name in WIDE else b)
    w = tl.GRID_FUSED[name][1]
    lead = () if lanes is None else (lanes,)
    idxs, segments = [[] for _ in shapes], []
    for k in range(nseg):
        nc, size = 3 + k, 2 + k
        grid_of = {}
        for s in shapes:
            if s not in grid_of:
                grid_of[s] = torch.from_numpy(rng.standard_normal(lead + (NR, nc) + s).astype(np.float32) * 0.3)
        make = FACTOR.get(name)
        if make is not None:
            g0 = grid_of[shapes[0]]
            for lane in range(1 if lanes is None else lanes):
                tiles = torch.from_numpy(make(rng, NR * nc, b)).view(NR, nc, b, b)
                (g0 if lanes is None else g0[lane]).copy_(tiles)
        blocks = rng.permutation(NR * nc)
        writes, rest = blocks[:size], blocks[size:]
        for a, s in enumerate(shapes):
            same = grid_of[s] is grid_of[shapes[w]]
            flat = writes if a == w else rng.choice(rest if same else np.arange(NR * nc), size)
            idxs[a].append(np.stack([flat // nc, flat % nc], 1))
        segments.append((tuple(grid_of[s] for s in shapes), size))
    return [torch.from_numpy(np.concatenate(ix).astype(np.int32)) for ix in idxs], segments


def _clone(segments):
    """Copies of the segments' grids, a grid shared by two arguments still
    shared."""
    copies = {}
    return [(tuple(copies.setdefault(id(g), g.clone()) for g in grids), size) for grids, size in segments]


def _gather_form(name, idxs, segments):
    """The launch list's gather path (``build_program``, kind "gather"):
    each argument's blocks gathered segment by segment and joined, the
    batched leaf on the joined stack, the result scattered back into each
    segment's written grid."""
    w = tl.GRID_FUSED[name][1]
    stacked = segments[0][0][0].dim() == 5
    stacks = []
    for a, ix in enumerate(idxs):
        parts, off = [], 0
        for grids, size in segments:
            i = ix[off : off + size]
            parts.append(grids[a][i[:, 0], i[:, 1]] if not stacked else grids[a][:, i[:, 0], i[:, 1]])
            off += size
        stack = torch.cat(parts, dim=1 if stacked else 0)
        stacks.append(stack.flatten(0, 1) if stacked else stack)
    out = getattr(tl, f"batched_{name}")(*stacks)
    n = idxs[0].shape[0]
    if stacked:
        out = out.reshape(-1, n, *out.shape[1:])
    off = 0
    for grids, size in segments:
        i = idxs[w][off : off + size]
        if stacked:
            grids[w][:, i[:, 0], i[:, 1]] = out[:, off : off + size]
        else:
            grids[w].index_put_((i[:, 0], i[:, 1]), out[off : off + size])
        off += size


def _all_grids(segments):
    seen = {}
    for grids, _ in segments:
        for g in grids:
            seen.setdefault(id(g), g)
    return list(seen.values())


@pytest.mark.parametrize("lanes", [None, LANES], ids=["unstacked", "stacked"])
@pytest.mark.parametrize("nseg", [2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_plain_multi_segment_form_equals_the_gather_form(name, nseg, lanes):
    """Whole grids compared bit for bit, unwritten blocks included."""
    idxs, segments = _segments_case(name, nseg, lanes, seed=100 * NAMES.index(name) + 10 * nseg + (lanes or 0))
    fused, gather = _clone(segments), _clone(segments)
    launches = [dict(c) for c in tl.COUNTERS]
    out = getattr(tl, f"grid_{name}")(idxs, fused)
    assert out is fused[0][0][tl.GRID_FUSED[name][1]]
    assert [dict(c) for c in tl.COUNTERS] == launches  # the plain version counts no launch
    _gather_form(name, idxs, gather)
    before, got, want = _all_grids(segments), _all_grids(fused), _all_grids(gather)
    changed = False
    for g0, g1, g2 in zip(before, got, want):
        torch.testing.assert_close(g1, g2, rtol=0, atol=0, equal_nan=True)
        changed |= not torch.equal(g1, g0)
    assert changed


@pytest.mark.parametrize("lanes", [None, LANES], ids=["unstacked", "stacked"])
def test_one_segment_either_call_form(lanes):
    """A list of one (grids, size) segment and the plain grids are the same
    call."""
    idxs, segments = _segments_case("gemmnn", 1, lanes, seed=5)
    a, b = _clone(segments), _clone(segments)
    tl.grid_gemmnn(idxs, a)
    tl.grid_gemmnn(idxs, b[0][0])
    assert all(torch.equal(x, y) for x, y in zip(_all_grids(a), _all_grids(b)))


def test_segments_must_share_tiles_and_cover_the_indices():
    idxs, segments = _segments_case("gemmnn", 2, None, seed=6)
    (grids, size), second = segments
    with pytest.raises(ValueError, match="tasks for"):
        tl.grid_gemmnn(idxs, [(grids, size + 1), second])
    wide = tuple(torch.zeros(NR, 4, r, c + 1) for r, c in (g.shape[-2:] for g in grids))
    with pytest.raises(ValueError, match="contract|disagree"):
        tl.grid_gemmnn(idxs, [(grids, size), (wide, second[1])])


# --------------------------------------------------------------------------
# The plan: routing and hazards
# --------------------------------------------------------------------------
def _plan(n=128, p=32, rhs_cols=16, roots=1, pc=None):
    """The leaf plan of ``roots`` LUSOLVE roots of (n, n) over p x p and b
    (n, rhs_cols) in p x pc blocks (pc = min(rhs_cols, 4) by default; one
    root: the matrix-RHS solve's plan, 32 x 32 as on the card, with 4 x 4
    tiles), one drain."""
    tracker, children = tcore.DepTracker(), []
    for r in range(roots):
        A = tcore.GData((n, n), partitions=((p, p),), value=tcore.dd_matrix(n, seed=r, device="cpu"), device="cpu")
        rhs = np.random.default_rng(r).standard_normal((n, rhs_cols)).astype(np.float32)
        B = tcore.GData((n, rhs_cols), partitions=((p, pc or min(rhs_cols, 4)),), value=rhs, device="cpu")
        LUSOLVE.split(tcore.GTask(LUSOLVE, None, [A.root_view(), B.root_view()]), children.append)
    for t in children:
        tracker.add(t)
    return plan_schedule(tracker.waves(), tracker.dag())


def _grids(plan):
    return [to_grid(plan.datas[d].value, *blk) for d, blk in zip(plan.roots_order, plan.blocks)]


def _route_counts(monkeypatch):
    """Counts every fused call (by its segment count) and every batched-leaf
    call of the launch lists built from now on."""
    calls = {"fused": [], "gather": 0}
    for name, (fn, w) in list(tl.GRID_FUSED.items()):
        def fused(idxs, segments, fn=fn):
            calls["fused"].append(len(segments))
            return fn(idxs, segments)

        monkeypatch.setitem(tl.GRID_FUSED, name, (fused, w))
    leaf = ops._TileOp.batched_leaf_fn

    def batched(self, backend):
        fn = leaf(self, backend)

        def call(*stacks):
            calls["gather"] += 1
            return fn(*stacks)

        return call

    monkeypatch.setattr(ops._TileOp, "batched_leaf_fn", batched)
    return calls


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_build_program_routes_every_lusolve_group(monkeypatch, backend):
    """The matrix-RHS solve plan (654 groups, 62 of them over two segments):
    on ``cuda`` every group is one fused call and none gathers; on ``torch``
    (library leaves) every group gathers."""
    calls = _route_counts(monkeypatch)
    plan = _plan()
    assert (plan.n_groups, sum(len(g.segments) > 1 for g in plan.groups())) == (654, 62)
    build_program(plan, backend)(_grids(plan), plan.flat_idxs)
    if backend == "cuda":
        assert len(calls["fused"]) == plan.n_groups and calls["gather"] == 0
        assert sorted(calls["fused"]) == sorted(len(g.segments) for g in plan.groups())
    else:
        assert calls == {"fused": [], "gather": plan.n_groups}


@pytest.mark.parametrize("roots,rhs_cols", [(1, 16), (3, 16), (10, 1)])
def test_multi_segment_groups_have_no_hazard(roots, rhs_cols):
    """No task of a multi-segment group writes a block that another task of
    the group reads or writes, in any segment: the in-place launch needs no
    copy before its write (one matrix-RHS solve; three solves in one drain,
    one segment per root and slot tuple; ten vector solves, more segments
    than one launch takes)."""
    plan = _plan(n=32, p=8, rhs_cols=rhs_cols, roots=roots)
    most, multi = 0, 0
    for g in plan.groups():
        if len(g.segments) < 2:
            continue
        multi += 1
        most = max(most, len(g.segments))
        (w,) = g.write_pos
        writes, reads, off = [], [], 0
        for slots_, size in g.segments:
            for t in range(off, off + size):
                blk = [(slots_[a], *map(int, g.idxs[a][t])) for a in range(len(slots_))]
                writes.append(blk[w])
                reads.append({x for a, x in enumerate(blk) if a != w})
            off += size
        assert len(set(writes)) == len(writes), g.op.name
        for t, x in enumerate(writes):
            assert all(x not in r for u, r in enumerate(reads) if u != t), g.op.name
    assert multi > 0
    if roots == 10:
        assert most > tl.MAX_SEGMENTS


# --------------------------------------------------------------------------
# Whole drains on CudaExecutor (g2p) against the JAX package
# --------------------------------------------------------------------------
def _dd_np(n, seed):
    a = tcore.dd_matrix(n, seed=seed, device="cpu")
    assert np.array_equal(a.numpy(), np.asarray(jcore.dd_matrix(n, seed=seed)))
    return a.numpy()


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def _gathering(monkeypatch):
    """From now on, fused calls of several segments run the gather form
    instead (the launch list as the reference builds it)."""
    for name, (fn, w) in list(tl.GRID_FUSED.items()):
        def fused(idxs, segments, fn=fn, name=name):
            if len(segments) > 1:
                _gather_form(name, idxs, segments)
                return segments[0][0][tl.GRID_FUSED[name][1]]
            return fn(idxs, segments)

        monkeypatch.setitem(tl.GRID_FUSED, name, (fused, w))


N, PARTS = 48, ((3, 3),)
MANY = 3


def _port(kind):
    a, b = _dd_np(N, seed=1), _rand(2, (N, 16))
    if kind == "solve":
        return [run_lu_solve(a, b, graph="g2p", partitions=PARTS, b_partitions=((3, 1),), device="cpu")]
    if kind == "inv":
        return [run_inv(a, graph="g2p", partitions=PARTS, device="cpu")]
    mats = [_dd_np(N, seed=10 + s) for s in range(MANY)]
    if kind == "many":
        return [x for L, U in run_lu_many(mats, graph="g2p", partitions=PARTS, device="cpu") for x in (L, U)]
    rhss = [_rand(20 + s, (N, 16)) for s in range(MANY)]
    return run_lu_solve_batched(mats, rhss, graph="g2p", partitions=PARTS, b_partitions=((3, 1),), device="cpu")


def _reference(kind):
    a, b = jnp.asarray(_dd_np(N, seed=1)), jnp.asarray(_rand(2, (N, 16)))
    if kind == "solve":
        return [jlin.run_lu_solve(a, b, graph="g2p", partitions=PARTS, b_partitions=((3, 1),))]
    if kind == "inv":
        return [jlin.run_inv(a, graph="g2p", partitions=PARTS)]
    mats = [jnp.asarray(_dd_np(N, seed=10 + s)) for s in range(MANY)]
    if kind == "many":
        return [x for LU in jlin.run_lu_many(mats, graph="g2p", partitions=PARTS) for x in LU]
    rhss = [jnp.asarray(_rand(20 + s, (N, 16))) for s in range(MANY)]
    return jlin.run_lu_solve_batched(mats, rhss, graph="g2p", partitions=PARTS, b_partitions=((3, 1),))


@pytest.mark.parametrize("kind,atol", [("solve", 1e-4), ("inv", 1e-4), ("many", 1e-5), ("batched", 1e-4)])
def test_drains_match_the_reference_through_multi_segment_calls(monkeypatch, kind, atol):
    """Matrix-RHS solve, inverse, three LUs in one drain (a segment per
    root) and three stacked matrix-b solves: within tests/test_lu.py's
    tolerances of the JAX package, and bit for bit the same drain with the
    multi-segment groups gathered, as the reference runs them."""
    calls = _route_counts(monkeypatch)
    clear_compile_cache()
    got = _port(kind)
    assert calls["gather"] == 0 and max(calls["fused"]) > 1
    for x, want in zip(got, _reference(kind), strict=True):
        _close(x, want, atol)
    monkeypatch.undo()
    _gathering(monkeypatch)
    clear_compile_cache()
    for x, y in zip(got, _port(kind), strict=True):
        assert torch.equal(x, y)
    clear_compile_cache()


# --------------------------------------------------------------------------
# chip_smoke.py's pins of the launches over several segments
# --------------------------------------------------------------------------
def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _segmented(plan):
    out = {}
    for g in plan.groups():
        if len(g.segments) > 1:
            out[g.op.name] = out.get(g.op.name, 0) + 1
    return out


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_chip_smoke_segmented_pins(mesh, monkeypatch):
    """Phase 4's and 4c's launches over several segments a drain, the same
    at any tile size: the matrix-RHS solve's plan at 32 x 32 (b in 32 x 4),
    the stacked matrix-b solve's template at 8 x 8 (b in 8 x 1), and one g4
    LU solve (4b's partitions, n = 64) counted where the card's wrapper
    counts them, one a fused call over several segments."""
    cs = _chip_smoke()
    assert _segmented(_plan()) == cs.SOLVE_SEGMENTED
    assert _segmented(_plan(n=64, p=8, rhs_cols=8, pc=1)) == cs.STACKED_SOLVE_SEGMENTED
    calls = _route_counts(monkeypatch)
    seen = {}
    for name, (fn, w) in list(tl.GRID_FUSED.items()):
        def fused(idxs, segments, fn=fn, name=name):
            if len(segments) > 1:
                seen[name] = seen.get(name, 0) + 1
            return fn(idxs, segments)

        monkeypatch.setitem(tl.GRID_FUSED, name, (fused, w))
    clear_compile_cache()
    n = 64
    a, b = _dd_np(n, seed=0), _rand(0, (n, n * cs.RHS // cs.N))
    x = run_lu_solve(a, b, graph="g4", partitions=cs.DIST_P, b_partitions=cs.DIST_B_P, mesh=mesh)
    clear_compile_cache()
    np.testing.assert_allclose(a.astype(np.float64) @ x.numpy(), b, atol=1e-4)
    assert seen == cs.DIST_SEGMENTED["lu_solve"] and calls["gather"] == 0


# --------------------------------------------------------------------------
# The segment packer
# --------------------------------------------------------------------------
def test_pack_segments_covers_every_task_once_in_order():
    src = (_build.CSRC / "tile_lu_sm90.cu").read_text()
    assert int(re.search(r"constexpr int kMaxSeg = (\d+);", src).group(1)) == tl.MAX_SEGMENTS
    rng = np.random.default_rng(0)
    cases = [[5], [3, 0, 4], [1] * tl.MAX_SEGMENTS, [2] * (tl.MAX_SEGMENTS + 1), [0, 0]]
    cases += [list(rng.integers(0, 5, rng.integers(1, 40))) for _ in range(50)]
    for sizes in cases:
        launches = tl.pack_segments(sizes)
        total = 0
        order = []
        for first, count, members in launches:
            assert first == total and 1 <= len(members) <= tl.MAX_SEGMENTS
            start = 0
            for k, at in members:
                assert at == start and sizes[k] > 0
                start += sizes[k]
                order.append(k)
            assert count == start
            total += count
        assert total == sum(sizes)
        assert order == [k for k, s in enumerate(sizes) if s > 0]
        # the fewest launches: every launch but the last is full
        assert all(len(m) == tl.MAX_SEGMENTS for _, _, m in launches[:-1])
