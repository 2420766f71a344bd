"""The port's distributed graphs over two and four gloo ranks on the CPU.

Each job starts its ranks as separate processes (this file run as a script,
``--rank R --world W``) that meet through a ``file://`` init method under
the test's temporary directory, drain every case of ``CASES`` on a
``(W, 1)`` ``DeviceMesh`` (four ranks also ``MESH2D_CASES`` on a (2, 2)
one) and write their results and counters to a file.
A job has its own time limit (``JOB_TIMEOUT_S``) and fails, killing its
ranks, instead of hanging.  World size 1 is the reference: at world sizes 2
and 4 every rank holds only its own blocks (a ``DTensor`` result whose
``to_local()`` has the owned shape), its ``full_tensor()`` equals world size
1's bit for bit with the same counters, the owned tasks of the ranks add up
to the plan's tasks, and what each rank sends, receives and holds equals a
count made here by walking the plan's tasks (``_walk``), independent of the
executor's own exchange lists.
"""

import argparse
import itertools
import math
import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

JOB_TIMEOUT_S = 120
TWO = ((2, 2), (2, 2))
FLAT = ((4, 4),)
COUNTERS = ("tasks", "launches", "groups", "groups_prefusion", "slots", "compiles")
# name: (graph, kind, n, partitions, b partitions, seed)
CASES = {
    "cholesky_g3": ("g3", "cholesky", 64, TWO, None, 7),
    "cholesky_g4": ("g4", "cholesky", 64, TWO, None, 7),
    "cholesky_g4_replay": ("g4", "cholesky", 64, TWO, None, 8),
    "lu_g3": ("g3", "lu", 64, TWO, None, 7),
    "lu_solve_g3flat": ("g3flat", "lu_solve", 64, FLAT, ((4, 2),), 14),
    "lu_solve_g3flat_replay": ("g3flat", "lu_solve", 64, FLAT, ((4, 2),), 15),
    "fallback_g3flat": ("g3flat", "cholesky", 48, ((3, 3),), None, 5),
}
REPLAYS = {"cholesky_g4_replay": "cholesky_g4", "lu_solve_g3flat_replay": "lu_solve_g3flat"}
# on a (2, 2) mesh at world size 4 (a (1, 1) mesh at world size 1): blocks
# owned along both axes, and rows owned along "data" with "model" replicated
MESH2D_CASES = {
    "cholesky_2d": ("g3flat_2d", "cholesky", 64, FLAT, None, 7),
    "lu_solve_2d": ("g3flat_2d", "lu_solve", 64, FLAT, ((4, 2),), 14),
    "cholesky_rows": ("g3flat", "cholesky", 64, FLAT, None, 7),
}
# the leaf plans of a case are those of the local graph with its split depth
LEVELS = {"g3": 2, "g4": 2, "g3flat": 1, "g3flat_2d": 1}
AXES = {"g3flat_2d": ("data", "model")}


def _whole(v):
    """A result as numpy: a DTensor gathered (every rank calls this)."""
    from torch.distributed.tensor import DTensor

    return (v.full_tensor() if isinstance(v, DTensor) else v).numpy()


def _by_coordinates(v):
    """A DTensor gathered by mesh coordinates.  On a mesh whose ranks are not
    ascending along a dim, ``full_tensor()`` places each part by its rank in
    that dim's process group (ascending global ranks), not by its mesh
    coordinate, so the reversed mesh's result is put together here."""
    from repro_torch.core.data import Split

    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (Split.of_dtensor(v).offset, v.to_local().numpy()))
    out = np.empty(tuple(v.shape), dtype=parts[0][1].dtype)
    for (r0, c0), local in parts:
        out[r0 : r0 + local.shape[0], c0 : c0 + local.shape[1]] = local
    return out


def _local_shape(v):
    from torch.distributed.tensor import DTensor

    return tuple(v.to_local().shape) if isinstance(v, DTensor) else None


def _roots(kind, n, parts, b_parts, seed):
    import repro_torch.core as tcore

    make = tcore.spd_matrix if kind == "cholesky" else tcore.dd_matrix
    A = tcore.GData((n, n), partitions=parts, value=make(n, seed=seed, device="cpu"), device="cpu")
    if kind != "lu_solve":
        return A, None
    b = np.random.default_rng(seed).standard_normal((n, 32)).astype(np.float32)
    return A, tcore.GData(b.shape, partitions=b_parts, value=b, device="cpu")


def _submit(d, kind, A, B):
    import repro_torch.linalg as tlin

    if kind == "cholesky":
        tlin.utp_cholesky(d, A)
    elif kind == "lu":
        tlin.utp_getrf(d, A)
    else:
        tlin.utp_lu_solve(d, A, B)


def _drain(mesh, graph, kind, n, parts, b_parts, seed, whole=_whole):
    import repro_torch.core as tcore

    if graph == "g3flat_2d":
        graph = tcore.TaskFlowGraph(graph, split_levels=1, leaf_executor="wave", distributed=True,
                                    shard_axes=AXES["g3flat_2d"])
    d = tcore.Dispatcher(graph=graph, mesh=mesh)
    A, B = _roots(kind, n, parts, b_parts, seed)
    _submit(d, kind, A, B)
    leaves = d.run()
    v = (A if B is None else B).value
    return {"result": whole(v), "local_shape": _local_shape(v), "leaves": leaves,
            "executor": dict(d.executor.stats), "dispatcher": dict(d.stats), "key": d.executor.memo_key_extra()}


def _gathers(mesh):
    """A root split by an LU drain (g3flat, 4 x 4 blocks), then run whole:
    by a list over one 64 x 64 block (its grid does not split), and by the
    per-group fallback (a schedule of two block shapes); the named error for
    a block of another rank, and this rank's own block read in place."""
    import repro_torch.core as tcore
    from repro_torch.core.data import SplitError
    from repro_torch.linalg import GETRF

    out = {}
    whole = tcore.TaskFlowGraph("g3flat_whole", split_levels=0, leaf_executor="wave", distributed=True)
    for name, views in (("gather_plan", lambda A: [A.root_view()]),
                        ("gather_fallback", lambda A: [A.root_view(), A(3, 3)])):
        A, _ = _roots("lu", 64, FLAT, None, 11)
        d0 = tcore.Dispatcher(graph="g3flat", mesh=mesh)
        _submit(d0, "lu", A, None)
        d0.run()
        split = A.is_split
        d = tcore.Dispatcher(graph=whole, mesh=mesh)
        for v in views(A):
            d.submit_task(tcore.GTask(GETRF, None, [v]))
        leaves = d.run()
        out[name] = {"result": _whole(A.value), "split_before": split, "leaves": leaves,
                     "executor": dict(d.executor.stats)}
    A, _ = _roots("lu", 64, FLAT, None, 11)
    d = tcore.Dispatcher(graph="g3flat", mesh=mesh)
    _submit(d, "lu", A, None)
    d.run()
    errors = {}
    for r in range(4):
        try:
            errors[r] = A(r, r).get().clone().numpy()
        except SplitError as e:
            errors[r] = str(e)
    out["blocks"] = {"got": errors, "result": _whole(A.value)}
    return out


def _rank_main(rank: int, world: int, init: str, out: str) -> None:
    """One rank of a job: every case of CASES on the (world, 1) mesh, the
    gathers, then the entry point and, at world size 2, a mesh over the
    ranks in reverse order; MESH2D_CASES on a (2, 2) mesh (world size 4) or
    a (1, 1) one (world size 1)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    import repro_torch.core as tcore
    import repro_torch.linalg as tlin

    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=JOB_TIMEOUT_S))
    try:
        res = {}
        if world in (1, 4):
            shape = (2, 2) if world == 4 else (1, 1)
            mesh2d = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            res.update({name: _drain(mesh2d, *case) for name, case in MESH2D_CASES.items()})
        mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
        res.update({name: _drain(mesh, *case) for name, case in CASES.items()})
        res.update(_gathers(mesh))
        a = tcore.spd_matrix(64, seed=7, device="cpu")
        L = tlin.run_cholesky(a, graph="g3", partitions=TWO, mesh=mesh)
        res["run_cholesky"] = {"result": _whole(L), "local_shape": _local_shape(L)}
        a = tcore.dd_matrix(64, seed=7, device="cpu")
        L, U = tlin.run_lu(a, graph="g3", partitions=TWO, mesh=mesh)
        res["run_lu"] = {"result": np.stack([_whole(L), _whole(U)]), "local_shape": _local_shape(U)}
        b = torch.from_numpy(np.random.default_rng(7).standard_normal(64).astype(np.float32))
        x = tlin.run_lu_solve(a, b, graph="g3flat", partitions=FLAT, mesh=mesh, check_finite=True)
        res["run_lu_solve"] = {"result": _whole(x), "local_shape": _local_shape(x)}
        if world == 2:
            rev = DeviceMesh("cpu", torch.tensor([[1], [0]]), mesh_dim_names=("data", "model"))
            res["reversed"] = _drain(rev, *CASES["cholesky_g4"], whole=_by_coordinates)
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _job(world: int, tmp: Path):
    """Run ``world`` ranks to their end within JOB_TIMEOUT_S; their results."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH", "")]))
    outs = [tmp / f"rank{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--world", str(world),
                               "--init", str(tmp / "init"), "--out", str(outs[r])],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + JOB_TIMEOUT_S
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"world size {world}: the ranks did not finish within {JOB_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"world size {world}, rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [pickle.loads(o.read_bytes()) for o in outs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {w: _job(w, tmp_path_factory.mktemp(f"world{w}")) for w in (1, 2, 4)}


@pytest.fixture(scope="module")
def plans():
    """Each case's leaf plans, as the local graph of its split depth plans
    them (the distributed graphs plan alike; only who runs what differs)."""
    import repro_torch.core as tcore
    from repro_torch.core.executors import clear_compile_cache
    from repro_torch.core.executors.jit_wave import WaveExecutor

    out = {}
    run_program = WaveExecutor._run_program
    with pytest.MonkeyPatch.context() as mp:
        for name, (graph, kind, n, parts, b_parts, seed) in {**CASES, **MESH2D_CASES}.items():
            seen = []
            mp.setattr(WaveExecutor, "_run_program", lambda self, plan, stack=None: (
                seen.append(plan), run_program(self, plan, stack))[1])
            clear_compile_cache()
            d = tcore.Dispatcher(graph=tcore.TaskFlowGraph("local", LEVELS[graph], "wave"))
            A, B = _roots(kind, n, parts, b_parts, seed)
            _submit(d, kind, A, B)
            d.run()
            out[name] = seen
    clear_compile_cache()
    return out


def _walk(plans, mesh_shape, axes, pos):
    """What mesh position ``pos`` sends, receives and holds over ``plans``,
    counted by walking every task in issue order: a task runs on the
    positions owning every block it writes; a position running a task reads
    a block it does not own from the owner that shares its coordinate on the
    axes the root is not split over, once per version of the block a plan
    holds.  Returns (bytes sent, bytes received, resident bytes, collectives
    issued, blocks moved between all positions, bytes of split roots the
    tasks write)."""
    names = ("data", "model")
    coords = list(itertools.product(*[range(s) for s in mesh_shape]))
    sent = received = resident = collectives = moved = written_bytes = 0
    store = {}  # data id -> blocks this position holds for it
    for plan in plans:
        roots = [plan.datas[d] for d in plan.roots_order]

        def split(r):
            out = {}
            for k, ax in enumerate(axes):
                size = mesh_shape[names.index(ax)] if ax is not None else 1
                grid = roots[r].shape[k] // plan.blocks[r][k]
                if size > 1 and grid % size == 0:
                    out[k] = (names.index(ax), size, grid)
            return out

        splits = [split(r) for r in range(len(roots))]
        if not any(splits):
            continue

        def owns(p, r, b):
            return all(coords[p][ai] == b[k] * size // grid for k, (ai, size, grid) in splits[r].items())

        def source(p, r, b):
            c = list(coords[p])
            for k, (ai, size, grid) in splits[r].items():
                c[ai] = b[k] * size // grid
            return coords.index(tuple(c))

        nbytes = [plan.blocks[r][0] * plan.blocks[r][1] * roots[r].dtype.itemsize for r in range(len(roots))]
        version, held, points, got = {}, {}, set(), {r: set() for r in range(len(roots))}
        for s, slot in enumerate(plan.slots):
            writes = []
            for g in slot:
                off = 0
                for slots_, size in g.segments:
                    for m in range(off, off + size):
                        args = [(slots_[a], tuple(int(x) for x in g.idxs[a][m])) for a in range(len(slots_))]
                        w = [args[a] for a in g.write_pos]
                        runners = [p for p in range(len(coords)) if all(owns(p, r, b) for r, b in w)]
                        for p, (r, b) in itertools.product(runners, args):
                            v = version.get((r, b), -1)
                            if not owns(p, r, b) and held.get((p, r, b)) != v:
                                held[(p, r, b)] = v
                                points.add(v)
                                moved += 1
                                sent += nbytes[r] * (source(p, r, b) == pos)
                                if p == pos:
                                    received += nbytes[r]
                                    got[r].add(b)
                        writes += w
                    off += size
            for r, b in writes:
                version[(r, b)] = s
                written_bytes += nbytes[r] * bool(splits[r])
        collectives += len(points)
        for r, root in enumerate(roots):
            grid = roots[r].shape[0] // plan.blocks[r][0] * (roots[r].shape[1] // plan.blocks[r][1])
            owned = grid // math.prod(size for _, size, _ in splits[r].values())
            store[root.id] = max(store.get(root.id, 0), owned + len(got[r]) if splits[r] else grid)
        resident = max(resident, sum(store[root.id] * nbytes[r] for r, root in enumerate(roots)))
    return sent, received, resident, collectives, moved, written_bytes


def _counters(res):
    return {k: res["executor"].get(k, 0) for k in COUNTERS}


def _check_ranks(runs, world, name, owners=1):
    (one,) = runs[1]
    tasks = one[name]["executor"]["tasks"]
    owned = []
    for res in runs[world]:
        got = res[name]
        np.testing.assert_array_equal(got["result"], one[name]["result"])
        assert _counters(got) == _counters(one[name])
        assert got["leaves"] == one[name]["leaves"] == tasks
        # every rank takes part in each collective (the rank of Cholesky's
        # last rows sends nothing: no other rank reads its blocks)
        assert got["executor"]["exchanges"] > 0
        owned.append(got["executor"]["owned_tasks"])
    assert sum(res[name]["executor"]["exchanged_bytes"] for res in runs[world]) > 0
    assert sum(owned) == owners * tasks
    assert one[name]["executor"]["owned_tasks"] == tasks
    assert one[name]["executor"].get("exchanges", 0) == 0
    assert one[name]["local_shape"] is None
    return owned


@pytest.mark.parametrize("name", ["cholesky_g3", "cholesky_g4", "lu_g3", "lu_solve_g3flat"])
def test_each_rank_matches_world_size_one(runs, name):
    owned = _check_ranks(runs, 2, name)
    assert all(o > 0 for o in owned)
    n, m = runs[1][0][name]["result"].shape
    for res in runs[2]:
        assert res[name]["local_shape"] == (n // 2, m)


@pytest.mark.parametrize("name", ["cholesky_g3", "cholesky_g4", "lu_g3", "lu_solve_g3flat"])
def test_four_ranks_match_world_size_one(runs, name):
    """On a (4, 1) mesh each rank holds one of the four block rows."""
    _check_ranks(runs, 4, name)
    n, m = runs[1][0][name]["result"].shape
    for res in runs[4]:
        assert res[name]["local_shape"] == (n // 4, m)


CASES_AT = [(w, name) for w in (2, 4) for name in CASES if name != "fallback_g3flat"]
CASES_AT += [(4, name) for name in MESH2D_CASES]


@pytest.mark.parametrize("world,name", CASES_AT)
def test_traffic_and_storage_match_a_count_over_the_plan(runs, plans, world, name):
    """Each rank's ``exchanged_bytes``, ``received_bytes`` and
    ``resident_bytes`` and the collectives it issued equal ``_walk``'s count
    over the case's plans; what moves is less than what the ranks write
    (each rank took every written block in the all-reduce this replaced)."""
    graph = {**CASES, **MESH2D_CASES}[name][0]
    mesh_shape = (2, 2) if name in MESH2D_CASES else (world, 1)
    axes = AXES.get(graph, ("data", None))
    for pos, res in enumerate(runs[world]):
        ex = res[name]["executor"]
        sent, received, resident, collectives, moved, written = _walk(plans[name], mesh_shape, axes, pos)
        assert (ex["exchanged_bytes"], ex["received_bytes"], ex["resident_bytes"], ex["exchanges"]) == (
            sent, received, resident, collectives)
        assert ex["exchanged_bytes"] < written
    assert sum(r[name]["executor"]["exchanged_bytes"] for r in runs[world]) == sum(
        r[name]["executor"]["received_bytes"] for r in runs[world])


def test_replication_fallback_exchanges_nothing(runs):
    """n = 48 in 3 x 3 blocks: 3 block rows do not divide over 2 ranks, so
    the grid is replicated, every rank computes every task and nothing is
    exchanged."""
    (one,) = runs[1]
    for res in runs[2]:
        got = res["fallback_g3flat"]
        np.testing.assert_array_equal(got["result"], one["fallback_g3flat"]["result"])
        assert got["executor"]["owned_tasks"] == got["executor"]["tasks"] == 10
        assert got["executor"].get("exchanged_bytes", 0) == 0 and got["executor"].get("exchanges", 0) == 0
        assert got["local_shape"] is None


@pytest.mark.parametrize("name", sorted(REPLAYS))
def test_second_drain_replays_from_the_memo(runs, name):
    (one,) = runs[1]
    first = REPLAYS[name]
    for world in (2, 4):
        for res in runs[world]:
            got = res[name]
            assert got["dispatcher"]["memo_hits"] == 1 and got["dispatcher"]["memo_misses"] == 0
            assert res[first]["dispatcher"]["memo_misses"] == 1
            assert got["executor"].get("compiles", 0) == 0
            np.testing.assert_array_equal(got["result"], one[name]["result"])
            assert not np.array_equal(got["result"], res[first]["result"])
            for k in ("owned_tasks", "exchanges", "exchanged_bytes", "received_bytes", "resident_bytes"):
                assert got["executor"][k] == res[first]["executor"][k]


def test_entry_point_returns_the_whole_result_on_every_rank(runs):
    """``run_cholesky`` returns the split factor: each rank's part is its
    rows, and ``full_tensor()`` is world size 1's factor on every rank."""
    (one,) = runs[1]
    assert one["run_cholesky"]["result"].shape == (64, 64) and one["run_cholesky"]["local_shape"] is None
    for world in (2, 4):
        for res in runs[world]:
            np.testing.assert_array_equal(res["run_cholesky"]["result"], one["run_cholesky"]["result"])
            assert res["run_cholesky"]["local_shape"] == (64 // world, 64)


@pytest.mark.parametrize("name,shape", [("run_lu", (64,)), ("run_lu_solve", ())])
def test_lu_entry_points_return_split_results(runs, name, shape):
    """``run_lu``'s L and U and a vector ``run_lu_solve``'s x (with
    ``check_finite``, agreed over the mesh) stay split by rows; whole, they
    are world size 1's bit for bit."""
    (one,) = runs[1]
    assert one[name]["local_shape"] is None
    for world in (2, 4):
        for res in runs[world]:
            np.testing.assert_array_equal(res[name]["result"], one[name]["result"])
            assert res[name]["local_shape"] == (64 // world, *shape)


def test_meshes_over_other_ranks_key_apart(runs):
    """A (2, 1) mesh over ranks (1, 0) has the default mesh's shape but other
    ranks own the rows: its memo key differs, each rank owns what the other
    rank owned on the default mesh, and the result is the same."""
    (one,) = runs[1]
    r0, r1 = runs[2]
    for res, other in ((r0, r1), (r1, r0)):
        rev = res["reversed"]
        assert rev["key"] != res["cholesky_g4"]["key"]
        assert rev["dispatcher"]["memo_misses"] == 1
        assert rev["executor"]["owned_tasks"] == other["cholesky_g4"]["executor"]["owned_tasks"]
        for k in ("exchanged_bytes", "received_bytes", "resident_bytes"):
            assert rev["executor"][k] == other["cholesky_g4"]["executor"][k]
        np.testing.assert_array_equal(rev["result"], one["cholesky_g4"]["result"])


@pytest.mark.parametrize("name", ["gather_plan", "gather_fallback"])
def test_a_split_root_runs_whole_only_after_a_counted_gather(runs, name):
    """A split root that a list needs whole (its grid does not split, or the
    schedule falls back to per-group launches) is gathered by one
    all_gather that every rank issues, counted; then every rank runs every
    task, with world size 1's result."""
    (one,) = runs[1]
    assert one[name]["executor"].get("exchanges", 0) == 0 and not one[name]["split_before"]
    for world in (2, 4):
        for res in runs[world]:
            got = res[name]
            assert got["split_before"]
            np.testing.assert_array_equal(got["result"], one[name]["result"])
            ex = got["executor"]
            assert ex["exchanges"] == 1 and ex["owned_tasks"] == ex["tasks"] == got["leaves"]
            assert ex["exchanged_bytes"] == ex["received_bytes"] == 64 * 64 * 4 // world * (world - 1)


def test_a_block_of_another_rank_raises_a_named_error(runs):
    """``GView.get`` reads this rank's own blocks in place; a block another
    rank owns raises ``SplitError`` naming the root, never a stale or zero
    block."""
    (one,) = runs[1]
    whole = one["blocks"]["result"]
    for world in (2, 4):
        for rank, res in enumerate(runs[world]):
            for r, got in res["blocks"]["got"].items():
                if r * world // 4 == rank:
                    np.testing.assert_array_equal(got, whole[16 * r : 16 * r + 16, 16 * r : 16 * r + 16])
                else:
                    assert "lies on another rank" in got and got.startswith("gdata")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of a test job")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    _rank_main(args.rank, args.world, args.init, args.out)


@pytest.mark.parametrize("name,owners", [("cholesky_2d", 1), ("lu_solve_2d", 1), ("cholesky_rows", 2)])
def test_two_axis_mesh_matches_world_size_one(runs, name, owners):
    """Four ranks on a (2, 2) mesh.  Split on both axes (shard_axes
    ("data", "model")), each block has one owner and each rank holds its
    quarter; split on "data" only, the two ranks of a "model" row own the
    same rows, and a block moves between ranks of one "model" column.
    Every rank's result is world size 1's either way.  (Cholesky writes no
    block above the diagonal, so the rank owning the upper-right quadrant
    computes nothing.)"""
    owned = _check_ranks(runs, 4, name, owners)
    assert sum(o > 0 for o in owned) >= 3
    n, m = runs[1][0][name]["result"].shape
    for res in runs[4]:
        assert res[name]["local_shape"] == ((n // 2, m) if name == "cholesky_rows" else (n // 2, m // 2))
