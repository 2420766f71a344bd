"""Each rank's captured programs over a mesh of two and four gloo ranks on
the CPU: the distributed drains' owned launch lists (``OwnedCapture``) and
the prefill and decode plans (``CapturedCall`` over a mesh).

Each job starts its ranks as separate processes (this file run as a script,
``--rank R --world W``) that meet through a ``file://`` init method under
the test's temporary directory; the jobs of world sizes 1, 2 and 4 run side
by side, each under ``JOB_TIMEOUT_S``.  On the CPU the captured forms run
their lists and steps eagerly over the same static storage the card's
graphs replay, so these tests reach the copy-in, the hand-back, the
aliasing rule and the cross-rank check of the collectives.

- Drains: g4 and g3flat Cholesky and the g4 LU solve at n = 128 in
  (4, 4) then (8, 8) blocks (b in (4, 4) then (8, 1)), on (W, 1) and on
  (2, 2): a first drain, then two memo replays on fresh seeds.  Each result,
  assembled by mesh coordinates, equals world size 1's bit for bit; the
  counters equal world size 1's and the JAX package's local graph of the
  same plan (two-level ``split_levels=2`` for g4, the one-level g2 for
  g3flat); what each rank sends, receives and holds equals
  ``test_torch_distributed_ranks._walk``'s count over the plans; and the
  root's static store is the same tensor after every drain.
- Aliasing: the first drain's handle, read only after the second drain of
  the same key, still holds its own result.
- The cross-rank check: every rank's collective sequence for each list is
  the same; a list given another sequence on rank 1 raises ``CaptureError``
  naming rank 1 on every rank, instead of hanging.
- Plans: the reduced starcoder2-7b and granite prefill and decode plans on
  (1, W) and (W, 1) (granite at a capacity of every token: on (W, 1) each
  data shard's tokens route with capacity sized on the shard, the
  reference's ``_moe_ep``, which drops other tokens than one device
  where the capacity drops any): ``jitted()`` is not eager; every rank issues the same
  collectives on every call (recorded here by wrapping
  ``torch.distributed``'s functions), the first call of each plan adds
  the check's one ``all_gather_object``; the logits stay within
  ``TP_SERVE_TOL`` of world size 1.
"""

import argparse
import dataclasses
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

JOB_TIMEOUT_S = 240
N, RHS = 128, 16
LEVELS, B_LEVELS = ((4, 4), (8, 8)), ((4, 4), (8, 1))
# name: (graph, kind); each drained on seeds SEEDS, the first drain then two memo replays
DRAINS = {"cholesky_g4": ("g4", "cholesky"), "cholesky_g3flat": ("g3flat", "cholesky"),
          "lu_solve_g4": ("g4", "lu_solve")}
SEEDS = (0, 1, 2)
COUNTERS = ("tasks", "launches", "groups", "groups_prefusion", "slots", "compiles")
# the leaf plans of a drain are those of the local graph with its split depth
SPLIT_LEVELS = {"g4": 2, "g3flat": 1}
# the plans: reduced configurations, batch, prompt, cache length
SERVE = {"starcoder2-7b": "starcoder2-7b", "granite": "granite-moe-1b-a400m"}
B, S = 4, 8
TP_SERVE_TOL = dict(rtol=1e-4, atol=5e-5)  # tests/test_torch_tp.py's
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
               "all_gather_object")
ROOT = Path(__file__).resolve().parents[1]


def _meshes(world: int):
    """The drains' meshes at a world size: (W, 1), and (2, 2) at four."""
    return [(world, 1)] + ([(2, 2)] if world == 4 else [])


def _plan_meshes(world: int):
    return list(dict.fromkeys([(1, world), (world, 1)]))


def _roots(kind, seed):
    import repro_torch.core as tcore

    make = tcore.spd_matrix if kind == "cholesky" else tcore.dd_matrix
    A = tcore.GData((N, N), partitions=LEVELS, value=make(N, seed=seed, device="cpu"), device="cpu")
    if kind == "cholesky":
        return A, None
    b = np.random.default_rng(seed).standard_normal((N, RHS)).astype(np.float32)
    return A, tcore.GData(b.shape, partitions=B_LEVELS, value=b, device="cpu")


def _submit(d, kind, A, b):
    import repro_torch.linalg as tlin

    if kind == "cholesky":
        tlin.utp_cholesky(d, A)
    else:
        tlin.utp_lu_solve(d, A, b)


def _by_coordinates(v):
    """A result as numpy: a DTensor put together by mesh coordinates (every
    rank calls this), a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.data import Split

    if not isinstance(v, DTensor):
        return v.numpy()
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (Split.of_dtensor(v).offset, v.to_local().numpy()))
    out = np.empty(tuple(v.shape), dtype=parts[0][1].dtype)
    for (r0, c0), local in parts:
        out[r0 : r0 + local.shape[0], c0 : c0 + local.shape[1]] = local
    return out


def _drains(mesh, graph, kind):
    """A first drain and two memo replays; the first drain's handle is read
    only after the second drain (the aliasing rule)."""
    import repro_torch.core as tcore

    out, first = [], None
    for i, seed in enumerate(SEEDS):
        d = tcore.Dispatcher(graph=graph, mesh=mesh)
        A, b = _roots(kind, seed)
        _submit(d, kind, A, b)
        leaves = d.run()
        root = A if b is None else b
        rec = {"leaves": leaves, "executor": dict(d.executor.stats), "dispatcher": dict(d.stats),
               "store": None if root.split is None else root.split.store.data_ptr()}
        if i == 0:
            first = root
        else:
            rec["result"] = _by_coordinates(root.value)
        out.append(rec)
        if i == 1:
            out[0]["result"] = _by_coordinates(first.value)
    return out


def _mismatch(mesh):
    """A drain whose lists hold one more collective on rank 1 than on the
    others: the error each rank raises (None if none)."""
    import repro_torch.core as tcore
    from repro_torch.core.executors import CaptureError, clear_compile_cache
    from repro_torch.core.executors.sharded import OwnedProgram

    init = OwnedProgram.__init__

    def more(self, *a, **kw):
        init(self, *a, **kw)
        self.sequence.append((len(self.steps), "all_to_all_single", "torch.float32"))

    clear_compile_cache()
    if dist.get_rank() == 1:
        OwnedProgram.__init__ = more
    try:
        d = tcore.Dispatcher(graph="g3flat", mesh=mesh)
        A, _ = _roots("cholesky", 3)
        _submit(d, "cholesky", A, None)
        d.run()
    except CaptureError as e:
        return str(e)
    finally:
        OwnedProgram.__init__ = init
        clear_compile_cache()
    return None


class _Recorder:
    """The collectives ``torch.distributed``'s functions are called for,
    in order: (function, dtype, group size)."""

    def __init__(self, mp):
        self.calls = []
        for name in COLLECTIVES:
            fn = getattr(dist, name)
            mp.setattr(dist, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            t = next((a for a in args if torch.is_tensor(a)), None)
            group = kw.get("group")
            size = dist.get_world_size(group) if group is not None else dist.get_world_size()
            self.calls.append((name, None if t is None else str(t.dtype), size))
            return fn(*args, **kw)

        return call

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def _serve(mesh, arch):
    """The reduced ``arch``'s prefill of S tokens into a cache of 2 S, then
    three decode steps: logits whole, the plans' flags and each call's
    collectives."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    cfg = ARCHS[arch].reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    params = {k: v.detach() for k, v in build_model(cfg, device="cpu").train_params().items()}
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32))
    pre = st.make_prefill_step(cfg, mesh, ShapeConfig("p", 2 * S, B, "prefill"), device="cpu")
    dec = st.make_decode_step(cfg, mesh, ShapeConfig("d", 2 * S, B, "decode"), device="cpu")
    place = st.place_params if mesh.size() > 1 else (lambda t, s: t)
    P = place(params, pre.in_shardings[0])
    cache = place(tree_map(lambda c: torch.zeros(c.shape, dtype=c.dtype), st.cache_specs(cfg, B, 2 * S)),
                  pre.in_shardings[2])
    prefill, step = pre.jitted(), dec.jitted()
    out = {"eager": (hasattr(prefill, "eager"), hasattr(step, "eager")),
           "grouped": (prefill.group is not None, step.group is not None),
           "logits": [], "calls": []}
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)
        logits, cache = prefill(P, place({"tokens": toks}, pre.in_shardings[1]), cache)
        out["calls"].append(rec.take())
        for pos in (S, S + 1, S + 2):
            whole = _whole(logits)
            rec.take()
            out["logits"].append(whole)
            tok = torch.from_numpy(whole).argmax(-1, keepdim=True).to(torch.int32)
            logits, cache = step(P, cache, place({"tokens": tok}, dec.in_shardings[2]),
                                 torch.tensor(pos, dtype=torch.int32))
            out["calls"].append(rec.take())
    out["logits"].append(_whole(logits))
    out["sequences"] = (prefill.sequence, step.sequence)
    return out


def _whole(x):
    from torch.distributed.tensor import DTensor

    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().float().numpy()


def _rank_main(rank: int, world: int, init: str, out: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.executors import sharded

    torch.set_num_threads(1)  # the jobs' ranks share the worker's cores
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=JOB_TIMEOUT_S))
    t0 = time.perf_counter()
    try:
        res = {"drains": {}, "plans": {}, "agreed": []}
        agree = sharded.agree

        def recorded(sequence, group, name, device):
            res["agreed"].append((name, list(sequence)))
            return agree(sequence, group, name, device)

        sharded.agree = recorded
        for shape in _meshes(world):
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            for name, (graph, kind) in DRAINS.items():
                res["drains"][(shape, name)] = _drains(mesh, graph, kind)
        sharded.agree = agree
        if world > 1:
            res["mismatch"] = _mismatch(init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model")))
        for shape in _plan_meshes(world):
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            for name, arch in SERVE.items():
                res["plans"][(shape, name)] = _serve(mesh, arch)
        res["seconds"] = time.perf_counter() - t0
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _start(world: int, tmp: Path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    outs = [tmp / f"rank{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--world", str(world),
                               "--init", str(tmp / "init"), "--out", str(outs[r])],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, outs


def _finish(world: int, procs, outs):
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


def _local_plans():
    """Each drain's leaf plans, as the local graph of its split depth plans
    them, and its counters on the JAX package's local graph of that plan."""
    import repro.core as jcore
    import repro.linalg as jlin
    import repro_torch.core as tcore
    from repro.core.executors import clear_compile_cache as jclear
    from repro.core.graph import TaskFlowGraph as JGraph
    from repro_torch.core.executors import clear_compile_cache
    from repro_torch.core.executors.jit_wave import WaveExecutor

    plans, jax = {}, {}
    run_program = WaveExecutor._run_program
    with pytest.MonkeyPatch.context() as mp:
        for name, (graph, kind) in DRAINS.items():
            seen = []
            mp.setattr(WaveExecutor, "_run_program", lambda self, plan, stack=None: (
                seen.append(plan), run_program(self, plan, stack))[1])
            clear_compile_cache()
            d = tcore.Dispatcher(graph=tcore.TaskFlowGraph("local", SPLIT_LEVELS[graph], "wave"))
            A, b = _roots(kind, SEEDS[0])
            _submit(d, kind, A, b)
            d.run()
            plans[name] = seen
    clear_compile_cache()
    for name, (graph, kind) in DRAINS.items():
        jclear()
        jgraph = jcore.get_graph("g2") if graph == "g3flat" else JGraph("local-g4", split_levels=2,
                                                                         leaf_executor="jit_wave")
        d = jcore.Dispatcher(graph=jgraph)
        A, b = _roots(kind, SEEDS[0])
        jA = jcore.GData(A.shape, partitions=LEVELS, dtype=np.float32, value=A.value.numpy())
        jb = None if b is None else jcore.GData(b.shape, partitions=B_LEVELS, dtype=np.float32,
                                                value=b.value.numpy())
        if kind == "cholesky":
            jlin.utp_cholesky(d, jA)
        else:
            jlin.utp_lu_solve(d, jA, jb)
        d.run()
        jax[name] = {k: d.executor.stats.get(k, 0) for k in COUNTERS}
    jclear()
    return plans, jax


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's ranks, and (computed here while they run) the local
    plans and the JAX package's counters."""
    jobs = {w: _start(w, tmp_path_factory.mktemp(f"world{w}")) for w in (1, 2, 4)}
    try:
        local = _local_plans()
    finally:
        done = {w: _finish(w, *jobs[w]) for w in jobs}
    return done, local


def _one(runs, name):
    (one,) = runs[0][1]
    return one["drains"][((1, 1), name)]


CELLS = [(w, shape, name) for w in (2, 4) for shape in _meshes(w) for name in DRAINS]


@pytest.mark.parametrize("world,shape,name", CELLS)
def test_captured_drains_match_world_size_one(runs, world, shape, name):
    """Every drain's result is world size 1's bit for bit on every rank,
    with its counters; the replays are memo hits that compile nothing."""
    one = _one(runs, name)
    for res in runs[0][world]:
        got = res["drains"][(shape, name)]
        for g, o in zip(got, one):
            np.testing.assert_array_equal(g["result"], o["result"])
            assert {k: g["executor"].get(k, 0) for k in COUNTERS} == {k: o["executor"].get(k, 0) for k in COUNTERS}
            assert g["leaves"] == o["leaves"] == o["executor"]["tasks"]
        assert [g["dispatcher"]["memo_hits"] for g in got] == [0, 1, 1]
        assert got[0]["executor"]["compiles"] > 0 and got[1]["executor"].get("compiles", 0) == 0
        assert all(g["executor"]["exchanges"] > 0 for g in got)


@pytest.mark.parametrize("name", sorted(DRAINS))
def test_counters_equal_the_jax_local_graph(runs, name):
    """The first drain's counters at world size 1 and over four ranks equal
    the JAX package's local graph of the same plan (the reference's one
    SPMD program counts the whole plan)."""
    _, jax = runs[1]
    one = _one(runs, name)[0]["executor"]
    assert {k: one.get(k, 0) for k in COUNTERS} == jax[name]
    for res in runs[0][4]:
        got = res["drains"][((4, 1), name)][0]["executor"]
        assert {k: got.get(k, 0) for k in COUNTERS} == jax[name]


@pytest.mark.parametrize("world,shape,name", CELLS)
def test_bytes_equal_a_count_over_the_plan(runs, world, shape, name):
    """What each rank sends, receives and holds, and the collectives it
    issues, equal ``_walk``'s count over the case's plans on every drain."""
    from test_torch_distributed_ranks import _walk

    plans, _ = runs[1]
    axes = ("data", None)
    for pos, res in enumerate(runs[0][world]):
        sent, received, resident, collectives, _, _ = _walk(plans[name], shape, axes, pos)
        for g in res["drains"][(shape, name)]:
            ex = g["executor"]
            assert (ex["exchanged_bytes"], ex["received_bytes"], ex["resident_bytes"], ex["exchanges"]) == (
                sent, received, resident, collectives)


@pytest.mark.parametrize("world,shape,name", CELLS)
def test_static_store_is_kept_and_earlier_handles_keep_their_bytes(runs, world, shape, name):
    """The root's store after every drain is the same static tensor (a
    replay copies into it, never reallocates); the first drain's handle,
    read after the second drain overwrote that store, still holds the first
    drain's result (``OwnedCapture._release`` gave it a copy)."""
    one = _one(runs, name)
    for res in runs[0][world]:
        got = res["drains"][(shape, name)]
        assert got[0]["store"] is not None
        assert got[0]["store"] == got[1]["store"] == got[2]["store"]
        np.testing.assert_array_equal(got[0]["result"], one[0]["result"])
        assert not np.array_equal(got[0]["result"], got[1]["result"])


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_checks_the_same_collectives(runs, world):
    """Before each capture every rank holds the same collective sequence for
    the list: per exchange point its ``all_to_all_single``, dtype and
    group, named alike on every rank."""
    agreed = [res["agreed"] for res in runs[0][world]]
    assert agreed[0] and all(a == agreed[0] for a in agreed)
    everyone = (world, tuple(range(world)))  # the mesh's group: every rank
    assert any(seq for _, seq in agreed[0])  # a list that moves no block issues none
    for name, seq in agreed[0]:
        assert name.startswith("launch list ")
        assert all(op == "all_to_all_single" and dtype == "torch.float32" and group == everyone
                   for _, op, dtype, group in seq)
        points = [p for p, *_ in seq]
        assert points == sorted(points)


@pytest.mark.parametrize("world", [2, 4])
def test_a_rank_with_other_collectives_raises_a_named_error(runs, world):
    """One more collective on rank 1 than on the others: every rank raises
    ``CaptureError`` naming the list and rank 1, and the job ends (no rank
    waits on a collective the others never issue)."""
    for res in runs[0][world]:
        msg = res["mismatch"]
        assert msg is not None and msg.startswith("launch list ")
        assert "rank 1 issues another collective sequence than rank 0" in msg


PLAN_CELLS = [(w, shape, name) for w in (2, 4) for shape in _plan_meshes(w) for name in SERVE]


@pytest.mark.parametrize("world,shape,name", PLAN_CELLS)
def test_serving_plans_over_a_mesh_are_captured_forms(runs, world, shape, name):
    """The prefill and decode plans' ``jitted()`` over a mesh is not eager
    and checks its collectives; every rank issues the same collectives on
    every call (the first call of each plan adds the check's one
    ``all_gather_object``); the logits stay within ``TP_SERVE_TOL`` of
    world size 1."""
    (one,) = runs[0][1]
    want = one["plans"][((1, 1), name)]
    assert want["eager"] == (False, False) and want["grouped"] == (False, False)
    ranks = [res["plans"][(shape, name)] for res in runs[0][world]]
    for got in ranks:
        assert got["eager"] == (False, False) and got["grouped"] == (True, True)
        for g, w in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(g, w, **TP_SERVE_TOL)
        calls = got["calls"]
        checks = [sum(c[0] == "all_gather_object" for c in call) for call in calls]
        assert checks == [1, 1, 0, 0]
        steps = [[c for c in call if c[0] != "all_gather_object"] for call in calls]
        assert steps[1] == steps[2] == steps[3] and steps[1]
        assert steps[0]
        assert got["calls"] == ranks[0]["calls"]
        # the check compared what the program recorded, the same on every rank
        assert got["sequences"] == ranks[0]["sequences"]
        assert len(got["sequences"][1]) == len(steps[1])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of a test job")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    _rank_main(args.rank, args.world, args.init, args.out)
