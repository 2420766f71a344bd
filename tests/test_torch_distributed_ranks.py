"""The port's distributed graphs over two and four gloo ranks on the CPU.

Each job starts its ranks as separate processes (this file run as a script,
``--rank R --world W``) that meet through a ``file://`` init method under
the test's temporary directory, drain every case of ``CASES`` on a
``(W, 1)`` ``DeviceMesh`` (four ranks: ``MESH2D_CASES`` on a (2, 2) one)
and write their results and counters to a file.
A job has its own time limit (``JOB_TIMEOUT_S``) and fails, killing its
ranks, instead of hanging.  World size 1 is the reference: at world size 2
every rank must return its result bit for bit, with the same counters, the
owned tasks of the two ranks adding up to the plan's tasks and the exchange
in use (or, under replication fallback, unused).
"""

import argparse
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


def _drain(mesh, graph, kind, n, parts, b_parts, seed):
    import repro_torch.core as tcore
    import repro_torch.linalg as tlin

    if graph == "g3flat_2d":
        graph = tcore.TaskFlowGraph(graph, split_levels=1, leaf_executor="wave", distributed=True,
                                    shard_axes=("data", "model"))
    d = tcore.Dispatcher(graph=graph, mesh=mesh)
    make = tcore.spd_matrix if kind == "cholesky" else tcore.dd_matrix
    A = tcore.GData((n, n), partitions=parts, value=make(n, seed=seed, device="cpu"), device="cpu")
    if kind == "cholesky":
        tlin.utp_cholesky(d, A)
    elif kind == "lu":
        tlin.utp_getrf(d, A)
    else:
        b = np.random.default_rng(seed).standard_normal((n, 32)).astype(np.float32)
        B = tcore.GData(b.shape, partitions=b_parts, value=b, device="cpu")
        tlin.utp_lu_solve(d, A, B)
        A = B
    leaves = d.run()
    return {"result": A.value.numpy(), "leaves": leaves, "executor": dict(d.executor.stats),
            "dispatcher": dict(d.stats), "key": d.executor.memo_key_extra()}


def _rank_main(rank: int, world: int, init: str, out: str) -> None:
    """One rank of a job: every case of CASES on the (world, 1) mesh, then
    the entry point and, at world size 2, a mesh over the ranks in reverse
    order (world sizes 1 and 2); MESH2D_CASES on a (2, 2) mesh (world size
    4) or a (1, 1) one (world size 1)."""
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
        if world == 4:
            with open(out, "wb") as f:
                pickle.dump(res, f)
            return
        mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
        res.update({name: _drain(mesh, *case) for name, case in CASES.items()})
        a = tcore.spd_matrix(64, seed=7, device="cpu")
        res["run_cholesky"] = tlin.run_cholesky(a, graph="g3", partitions=TWO, mesh=mesh).numpy()
        if world == 2:
            rev = DeviceMesh("cpu", torch.tensor([[1], [0]]), mesh_dim_names=("data", "model"))
            res["reversed"] = _drain(rev, *CASES["cholesky_g4"])
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


def _counters(res):
    return {k: res["executor"].get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize("name", ["cholesky_g3", "cholesky_g4", "lu_g3", "lu_solve_g3flat"])
def test_each_rank_matches_world_size_one(runs, name):
    (one,) = runs[1]
    tasks = one[name]["executor"]["tasks"]
    owned = []
    for res in runs[2]:
        got = res[name]
        np.testing.assert_array_equal(got["result"], one[name]["result"])
        assert _counters(got) == _counters(one[name])
        assert got["leaves"] == one[name]["leaves"] == tasks
        assert got["executor"]["exchanges"] > 0 and got["executor"]["exchanged_bytes"] > 0
        owned.append(got["executor"]["owned_tasks"])
    assert all(o > 0 for o in owned) and sum(owned) == tasks
    assert one[name]["executor"]["owned_tasks"] == tasks
    assert one[name]["executor"].get("exchanges", 0) == 0


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


@pytest.mark.parametrize("name", sorted(REPLAYS))
def test_second_drain_replays_from_the_memo(runs, name):
    (one,) = runs[1]
    first = REPLAYS[name]
    for res in runs[2]:
        got = res[name]
        assert got["dispatcher"]["memo_hits"] == 1 and got["dispatcher"]["memo_misses"] == 0
        assert res[first]["dispatcher"]["memo_misses"] == 1
        assert got["executor"].get("compiles", 0) == 0
        np.testing.assert_array_equal(got["result"], one[name]["result"])
        assert not np.array_equal(got["result"], res[first]["result"])
        assert got["executor"]["owned_tasks"] == res[first]["executor"]["owned_tasks"]


def test_entry_point_returns_the_whole_result_on_every_rank(runs):
    (one,) = runs[1]
    for res in runs[2]:
        np.testing.assert_array_equal(res["run_cholesky"], one["run_cholesky"])
    assert one["run_cholesky"].shape == (64, 64)


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
        np.testing.assert_array_equal(rev["result"], one["cholesky_g4"]["result"])


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
    ("data", "model")), each block has one owner and the exchange reduces
    one axis after the other; split on "data" only, the two ranks of a
    "model" row own the same rows and each "model" column exchanges on its
    own.  Every rank's result is world size 1's either way.  (Cholesky
    writes no block above the diagonal, so the rank owning the upper-right
    quadrant computes nothing.)"""
    (one,) = runs[1]
    tasks = one[name]["executor"]["tasks"]
    owned = []
    for res in runs[4]:
        got = res[name]
        np.testing.assert_array_equal(got["result"], one[name]["result"])
        assert _counters(got) == _counters(one[name])
        assert got["executor"]["exchanges"] > 0
        owned.append(got["executor"]["owned_tasks"])
    assert sum(o > 0 for o in owned) >= 3 and sum(owned) == owners * tasks
