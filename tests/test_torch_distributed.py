"""The port's distributed graphs g3/g4/g3flat at world size 1 on the CPU.

A world-size-1 gloo group (from a ``FileStore`` under the test's temporary
directory, destroyed when the module's tests are done) carries a
``DeviceMesh`` of shape (1, 1) with axes ("data", "model"), as the JAX
package's tests use ``jax.make_mesh((1, 1), ("data", "model"))``.

- Mirrors of the reference's distributed tests (tests/test_cholesky.py,
  tests/test_lu.py, tests/test_wave_program.py) at their tolerances:
  2e-4 Cholesky, 1e-5 LU and triangular solves, 1e-4 LU solve.
- The JAX package's own g3/g4 tests cannot run on this JAX version (its
  ``to_grid`` reshape of a sharded array raises ``ShardingTypeError``), so
  g3 and g4 are also held against the JAX package's LOCAL two-level graph at
  the same partitions (``TaskFlowGraph(..., split_levels=2, leaf_executor=
  "jit_wave" | "pallas")``): results within 1e-6 (Cholesky) and 1e-5 (LU),
  counters exactly equal.  g3flat is held the same way against the JAX
  package's one-level g2.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from scipy.linalg import lu as scipy_lu
from scipy.linalg import solve_triangular
from torch.distributed.device_mesh import init_device_mesh

import repro.core as jcore
import repro.linalg as jlin
import repro_torch.core as tcore
import repro_torch.linalg as tlin
from repro.core.executors import clear_compile_cache as jclear
from repro.core.graph import TaskFlowGraph as JGraph
from repro_torch.core.executors import ShardExecutor, clear_compile_cache, row_sharding

COUNTERS = ("tasks", "launches", "groups", "groups_prefusion", "slots", "compiles")
JAX_LEAF = {"g3": "jit_wave", "g4": "pallas"}
TWO = ((2, 2), (2, 2))
FLAT = ((4, 4),)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _parts(graph):
    return TWO if graph in ("g3", "g4") else FLAT


def _jax_graph(graph):
    """The JAX package's local graph with the same plan as ``graph``."""
    if graph == "g3flat":
        return jcore.get_graph("g2")
    return JGraph(f"local-{graph}", split_levels=2, leaf_executor=JAX_LEAF[graph])


def _drain(pkg, dispatcher, kind, arrays, parts, b_parts=None):
    """Submit one ``kind`` root on ``arrays`` through ``pkg``'s utp layer,
    drain, and return (result as numpy, executor counters)."""
    core, lin = (jcore, jlin) if pkg == "jax" else (tcore, tlin)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    datas = [core.GData(x.shape, partitions=p, dtype=np.float32 if pkg == "jax" else torch.float32,
                        value=x, **kw)
             for x, p in zip(arrays, (parts, b_parts or parts))]
    if kind == "cholesky":
        lin.utp_cholesky(dispatcher, datas[0])
    elif kind == "lu":
        lin.utp_getrf(dispatcher, datas[0])
    elif kind == "solve":
        lin.utp_solve(dispatcher, datas[0], datas[1], lower=True)
    else:
        lin.utp_lu_solve(dispatcher, datas[0], datas[1])
    dispatcher.run()
    out = np.asarray(datas[-1].value)
    if kind == "cholesky":
        out = np.tril(out)
    return out, {k: dispatcher.executor.stats.get(k, 0) for k in COUNTERS}


def _against_jax(mesh, graph, kind, arrays, parts, b_parts=None, tol=1e-6):
    """The port's drain on ``graph`` over ``mesh`` vs the JAX package's local
    graph of the same plan: counters equal, results within ``tol``."""
    clear_compile_cache()
    jclear()
    got, st = _drain("torch", tcore.Dispatcher(graph=graph, mesh=mesh), kind, arrays, parts, b_parts)
    want, jst = _drain("jax", jcore.Dispatcher(graph=_jax_graph(graph)), kind, arrays, parts, b_parts)
    assert st == jst
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return got, st


def _rhs(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("graph", ["g3", "g4", "g3flat"])
def test_cholesky_distributed_graphs(mesh, graph):
    a = tcore.spd_matrix(64, seed=7, device="cpu").numpy()
    L = tlin.run_cholesky(a, graph=graph, partitions=_parts(graph), mesh=mesh)
    assert L.device.type == "cpu"
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(a.astype(np.float64)), rtol=2e-4, atol=2e-4)
    got, st = _against_jax(mesh, graph, "cholesky", [a], _parts(graph))
    np.testing.assert_array_equal(got, L.numpy())
    assert st["tasks"] == (22 if graph in ("g3", "g4") else 20)


def test_hierarchical_two_level_matches_flat(mesh):
    """DuctTeip-over-SuperGlue hierarchy == flat (paper C5 vs C6 semantics)."""
    a = tcore.spd_matrix(64, seed=9, device="cpu")
    flat = tlin.run_cholesky(a, graph="g2", partitions=FLAT, device="cpu")
    hier = tlin.run_cholesky(a, graph="g3", partitions=TWO, mesh=mesh)
    torch.testing.assert_close(flat, hier, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("graph", ["g3", "g4", "g3flat"])
def test_lu_distributed_graphs(mesh, graph):
    a = tcore.dd_matrix(64, seed=7, device="cpu").numpy()
    L, U = tlin.run_lu(a, graph=graph, partitions=_parts(graph), mesh=mesh)
    p, l_ref, u_ref = scipy_lu(a)
    np.testing.assert_array_equal(p, np.eye(64))
    np.testing.assert_allclose(L.numpy(), l_ref, atol=1e-5)
    np.testing.assert_allclose(U.numpy(), u_ref, atol=1e-5)
    packed, _ = _against_jax(mesh, graph, "lu", [a], _parts(graph), tol=1e-5)
    np.testing.assert_array_equal(np.triu(packed), U.numpy())


def test_lu_hierarchical_matches_flat(mesh):
    a = tcore.dd_matrix(64, seed=9, device="cpu")
    Lf, Uf = tlin.run_lu(a, graph="g2", partitions=FLAT, device="cpu")
    Lh, Uh = tlin.run_lu(a, graph="g3", partitions=TWO, mesh=mesh)
    torch.testing.assert_close(Lf, Lh, rtol=0, atol=1e-5)
    torch.testing.assert_close(Uf, Uh, rtol=0, atol=1e-5)


@pytest.mark.parametrize("graph", ["g3", "g4"])
def test_solve_distributed(mesh, graph):
    a = tcore.dd_matrix(64, seed=6, device="cpu").numpy()
    b = _rhs(2, (64, 32))
    b_parts = ((2, 2), (2, 1))
    x = tlin.run_solve(a, b, lower=True, graph=graph, partitions=TWO, b_partitions=b_parts, mesh=mesh)
    want = solve_triangular(a, b, lower=True, unit_diagonal=True)
    np.testing.assert_allclose(x.numpy(), want, atol=1e-5)
    got, _ = _against_jax(mesh, graph, "solve", [a, b], TWO, b_parts, tol=1e-5)
    np.testing.assert_array_equal(got, x.numpy())


@pytest.mark.parametrize("graph", ["g3", "g4", "g3flat"])
def test_lu_solve_distributed_graphs(mesh, graph):
    a = tcore.dd_matrix(64, seed=14, device="cpu").numpy()
    b = _rhs(6, (64, 64))
    x = tlin.run_lu_solve(a, b, graph=graph, partitions=_parts(graph), mesh=mesh)
    want = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(x.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(a.astype(np.float64) @ x.numpy(), b, atol=1e-4)
    got, st = _against_jax(mesh, graph, "lu_solve", [a, b], _parts(graph), tol=1e-5)
    np.testing.assert_array_equal(got, x.numpy())


@pytest.mark.parametrize("graph", ["g3", "g4"])
def test_lu_solve_matrix_rhs_counters(mesh, graph):
    """The composed solve with a narrower b at two levels: the same 70 tasks,
    8 launches, 28 groups (33 before fusion) and 24 slots as the JAX
    package's local two-level graph."""
    a = tcore.dd_matrix(64, seed=14, device="cpu").numpy()
    b = _rhs(6, (64, 32))
    _, st = _against_jax(mesh, graph, "lu_solve", [a, b], TWO, ((2, 2), (2, 1)), tol=1e-5)
    assert (st["tasks"], st["launches"], st["groups"], st["groups_prefusion"], st["slots"]) == (70, 8, 28, 33, 24)


@pytest.mark.parametrize("graph", ["g3"])
@pytest.mark.parametrize("n", [32, 64])
def test_grid_resident_matches_inline_reference(mesh, graph, n):
    a = tcore.spd_matrix(n, seed=n + 1, device="cpu")
    ref = tlin.run_cholesky(a, graph="g1", partitions=FLAT, device="cpu")
    got = tlin.run_cholesky(a, graph=graph, partitions=TWO, mesh=mesh)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)


def test_run_inv_and_many_on_a_mesh(mesh):
    a = tcore.dd_matrix(64, seed=3, device="cpu")
    inv = tlin.run_inv(a, graph="g4", partitions=TWO, mesh=mesh)
    torch.testing.assert_close(inv.double() @ a.double(), torch.eye(64, dtype=torch.float64), rtol=0, atol=1e-4)
    mats = [tcore.dd_matrix(32, seed=s, device="cpu") for s in (1, 2, 3)]
    # a distributed graph never stacks: the batched form drains by segment fusion
    for (L, U), (Lm, Um) in zip(tlin.run_lu_batched(mats, graph="g3", partitions=TWO, mesh=mesh),
                                tlin.run_lu_many(mats, graph="g2", partitions=FLAT, device="cpu")):
        torch.testing.assert_close(L, Lm, rtol=0, atol=1e-5)
        torch.testing.assert_close(U, Um, rtol=0, atol=1e-5)


def test_world_size_one_replays_the_local_list(mesh):
    """At world size 1 no collective is issued: the local executor's launch
    list runs, owned_tasks counts every task, and a second drain of the same
    shape on another seed replays it from the drain memo."""
    clear_compile_cache()
    outs = []
    for seed in (7, 8):
        d = tcore.Dispatcher(graph="g4", mesh=mesh)
        a = tcore.spd_matrix(64, seed=seed, device="cpu").numpy()
        got, st = _drain("torch", d, "cholesky", [a], TWO)
        outs.append((got, d))
        np.testing.assert_allclose(got, np.linalg.cholesky(a.astype(np.float64)), rtol=2e-4, atol=2e-4)
        ex = d.executor.stats
        assert ex["owned_tasks"] == ex["tasks"] == 22
        assert ex.get("exchanges", 0) == 0 and ex.get("exchanged_bytes", 0) == 0
    assert outs[0][1].stats["memo_misses"] == 1 and outs[1][1].stats["memo_hits"] == 1
    assert outs[1][1].executor.stats.get("compiles", 0) == 0


@pytest.mark.parametrize("graph", ["g3", "g4", "g3flat"])
def test_distributed_graph_without_mesh_raises(graph):
    with pytest.raises(ValueError, match=f"graph {graph} is distributed but mesh is None"):
        tcore.Dispatcher(graph=graph)
    with pytest.raises(ValueError, match="distributed but mesh is None"):
        tlin.run_cholesky(np.eye(8, dtype=np.float32), graph=graph, partitions=((2, 2),), device="cpu")


def test_device_contradicting_the_mesh_raises(mesh):
    with pytest.raises(ValueError, match="contradicts the mesh"):
        tlin.run_cholesky(np.eye(8, dtype=np.float32), graph="g3flat", partitions=((2, 2),), mesh=mesh,
                          device="cuda")


def test_memo_key_extra_names_the_shard_axes(mesh):
    keys = {axes: ShardExecutor(mesh, shard_axes=axes).memo_key_extra()
            for axes in (("data", None), (None, "data"), ("data", "model"))}
    assert len(set(keys.values())) == 3
    assert ShardExecutor(mesh).memo_key_extra() == keys[("data", None)]
    assert ShardExecutor(mesh, backend="cuda").memo_key_extra() != keys[("data", None)]
    with pytest.raises(ValueError, match="does not have"):
        ShardExecutor(mesh, shard_axes=("rows", None))


def test_row_sharding_falls_back_to_replication(mesh):
    A = tcore.GData((48, 64), partitions=((3, 4),), device="cpu")
    pl = row_sharding(mesh, A, ("data", None))
    assert (pl.spec, pl.sizes, pl.dims) == (("data", None), (1, 1), (48, 64))
    assert not pl.distributed
    assert pl.owned(np.array([[0, 0], [2, 3]]), {"data": 0, "model": 0}).all()


def test_graph_describe():
    assert tcore.get_graph("g1").describe() == "program -> D -> CB(torch)"
    assert tcore.get_graph("g2p").describe() == "program -> D -> SG(wave) -> GB(cuda)"
    assert tcore.get_graph("g3").describe() == "program -> D -> DT(shard) -> SG(wave) -> CB(torch)"
    assert tcore.get_graph("g4").describe() == "program -> D -> DT(shard) -> SG(wave) -> GB(cuda)"
    assert tcore.get_graph("g3flat").describe() == "program -> D -> DT(shard) -> SG(wave) -> CB(torch)"
    for name, g in tcore.GRAPHS.items():
        assert g.shard_axes == jcore.get_graph(name).shard_axes


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("plan", ["cholesky", "run_lu", "lu_solve", "cholesky_flat"])
def test_chip_smoke_distributed_plans(mesh, monkeypatch, plan):
    """chip_smoke.py's phase 4b pins each plan's counters and one g4 drain's
    tile-kernel launches at n = 4096; they are the same at any tile size, so
    the n = 64 plan of the same partitions (leaves 2 x 2) must show them.
    Launches are counted where the card's wrappers count them: one a
    non-empty fused grid group, one a batched call."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import tile_linalg as tl

    cs = _chip_smoke()
    counts = {}
    for name, (fn, write_arg) in list(tl.GRID_FUSED.items()):
        def fused(idxs, grids, fn=fn, name=name):
            if idxs[0].shape[0]:
                counts[name] = counts.get(name, 0) + 1
            return fn(idxs, grids)

        monkeypatch.setitem(tl.GRID_FUSED, name, (fused, write_arg))
    for name in cs.KERNELS:
        def batched(*args, fn=getattr(kops, f"batched_{name}"), name=name):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args)

        monkeypatch.setattr(kops, f"batched_{name}", batched)
    n = 64
    kind = "cholesky" if plan == "cholesky_flat" else plan
    parts = ((n // 2, n // 2),) if plan == "cholesky_flat" else cs.DIST_P
    make = tcore.spd_matrix if kind == "cholesky" else tcore.dd_matrix
    a = make(n, seed=0, device="cpu").numpy()
    arrays, b_parts = [a], None
    if kind == "lu_solve":  # b (N, RHS) = (n, n / 8), as (4096, 512)
        arrays.append(_rhs(0, (n, n * cs.RHS // cs.N)))
        b_parts = cs.DIST_B_P
    graph = "g3flat" if plan == "cholesky_flat" else "g4"
    clear_compile_cache()
    d = tcore.Dispatcher(graph=graph, mesh=mesh)
    _drain("torch", d, {"run_lu": "lu"}.get(kind, kind), arrays, parts, b_parts)
    st = d.executor.stats
    got = (st["tasks"], st["groups"], st["groups_prefusion"], st["slots"], st["compiles"], st["launches"])
    assert got == cs.DIST_PLANS[plan]
    assert counts == ({} if graph == "g3flat" else cs.DIST_LAUNCHES[kind])


def test_batch_server_on_a_mesh(mesh):
    """``BatchServer(graph=..., mesh=...)`` as in the JAX package: requests
    go on the mesh's device and drain unstacked (segment fusion), with the
    results of the same requests served on g2."""
    from repro_torch.serve import BatchServer

    a = [tcore.dd_matrix(32, seed=s, device="cpu") for s in range(3)]
    b = [torch.from_numpy(_rhs(s, (32,))) for s in range(3)]
    spd = tcore.spd_matrix(32, seed=4, device="cpu")
    out = {}
    for graph, kw in (("g3", {"mesh": mesh}), ("g2", {"device": "cpu"})):
        srv = BatchServer(graph=graph, **kw)
        assert srv.device.type == "cpu"
        parts = TWO if graph == "g3" else FLAT
        futs = [srv.lu_solve(x, y, partitions=parts) for x, y in zip(a, b)]
        futs.append(srv.cholesky(spd, partitions=parts))
        rep = srv.tick()
        assert rep.resolved == 4
        assert rep.stacked_drains == (0 if graph == "g3" else 1)
        out[graph] = [f.result() for f in futs]
    for got, want in zip(out["g3"], out["g2"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
