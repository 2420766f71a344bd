"""The port's task layer against the JAX package's on the CPU: the same
Cholesky task streams give identical versioning (waves, edges, heights),
identical plans (groups, prefusion groups, slots, block indices), the same
program/launch counters and drain-memo behaviour, and GData never aliases
a tensor its caller holds."""

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.executors import plan_schedule as jplan
from repro.linalg.ops import POTRF as JPOTRF
import repro_torch.core as tcore
from repro_torch.analysis import verifier_stats
from repro_torch.core.data import from_grid, to_grid
from repro_torch.core.executors import (
    clear_compile_cache,
    drain_memo_stats,
    group_wave,
    plan_schedule as tplan,
)
from repro_torch.core.executors.jit_wave import DrainMemo
from repro_torch.linalg import POTRF as TPOTRF, utp_cholesky


def _leaf_scope(core, potrf, n, p):
    """Split one root POTRF over a p x p partition, as the dispatcher does
    at level 0, and version the children."""
    A = core.GData((n, n), partitions=((p, p),), value=np.eye(n, dtype=np.float32),
                   **({"device": "cpu"} if core is tcore else {}))
    root = core.GTask(potrf, None, [A.root_view()])
    children = []
    potrf.split(root, children.append)
    tracker = core.DepTracker()
    for t in children:
        tracker.add(t)
    return children, tracker


def _sig(t):
    return (t.op.name, tuple(v.block_index() for v in t.args), tuple(m.value for m in t.modes))


@pytest.mark.parametrize("p", [2, 4, 8])
def test_versioning_matches_reference(p):
    jt, jtr = _leaf_scope(jcore, JPOTRF, 8 * p, p)
    tt, ttr = _leaf_scope(tcore, TPOTRF, 8 * p, p)
    assert [_sig(t) for t in tt] == [_sig(t) for t in jt]
    jpos = {t.id: i for i, t in enumerate(jt)}
    tpos = {t.id: i for i, t in enumerate(tt)}
    jedges = {(jpos[a], jpos[b]) for a, bs in jtr.edges.items() for b in bs}
    tedges = {(tpos[a], tpos[b]) for a, bs in ttr.edges.items() for b in bs}
    assert tedges == jedges
    assert [[tpos[t.id] for t in w] for w in ttr.waves()] == [
        [jpos[t.id] for t in w] for w in jtr.waves()
    ]
    jh, th = jtr.dag().heights(), ttr.dag().heights()
    assert {tpos[k]: v for k, v in th.items()} == {jpos[k]: v for k, v in jh.items()}


@pytest.mark.parametrize("p", [2, 4, 8])
def test_plan_matches_reference(p):
    _, jtr = _leaf_scope(jcore, JPOTRF, 8 * p, p)
    _, ttr = _leaf_scope(tcore, TPOTRF, 8 * p, p)
    jp = jplan(jtr.waves(), jtr.dag())
    tp = tplan(ttr.waves(), ttr.dag())
    assert (tp.n_groups, tp.n_groups_prefusion, tp.n_slots) == (
        jp.n_groups, jp.n_groups_prefusion, jp.n_slots
    )
    assert [[(g.op.name, g.segments, g.write_pos, g.height) for g in s] for s in tp.slots] == [
        [(g.op.name, g.segments, g.write_pos, g.height) for g in s] for s in jp.slots
    ]
    assert tp.flat_idxs.dtype == torch.int32
    np.testing.assert_array_equal(tp.flat_idxs.numpy(), np.asarray(jp.flat_idxs))
    assert [_sig(t) for t in tp.tasks] == [_sig(t) for t in jp.tasks]


def test_plan_at_the_main_path_partition():
    """32 x 32 partitions (the card's main path, here with 4 x 4 tiles):
    5984 leaf tasks in 124 fused groups over 94 issue slots."""
    tasks, tr = _leaf_scope(tcore, TPOTRF, 128, 32)
    plan = tplan(tr.waves(), tr.dag())
    assert (len(tasks), plan.n_groups, plan.n_groups_prefusion, plan.n_slots) == (5984, 124, 124, 94)
    sizes = {}
    for g in plan.groups():
        sizes.setdefault(g.op.name, []).append(g.size)
    assert {k: len(v) for k, v in sizes.items()} == {"potrf": 32, "trsm": 31, "syrk": 31, "gemm": 30}
    assert max(sizes["gemm"]) == 465


def _drain(graph, a, parts=((4, 4),), **kw):
    d = tcore.Dispatcher(graph=graph, **kw)
    A = tcore.GData(a.shape, partitions=parts, value=a, device="cpu")
    utp_cholesky(d, A)
    n = d.run()
    return d, A, n


@pytest.mark.parametrize("graph", ["g2", "g2p"])
def test_one_program_per_drain_and_memo_replay(graph):
    clear_compile_cache()
    hits = drain_memo_stats()["hits"]
    a = tcore.spd_matrix(64, seed=13, device="cpu")
    d1, A1, n1 = _drain(graph, a)
    assert n1 == 20
    st = d1.executor.stats
    assert (st["compiles"], st["launches"], st["groups"], st["groups_prefusion"], st["slots"]) == (1, 1, 12, 12, 10)
    assert d1.stats["memo_misses"] == 1 and d1.stats["memo_hits"] == 0
    assert A1.in_grid_epoch
    d2, A2, n2 = _drain(graph, a)
    assert n2 == 20
    assert d2.executor.stats["launches"] == 1
    assert d2.executor.stats.get("compiles", 0) == 0
    assert d2.stats["memo_hits"] == 1
    assert drain_memo_stats()["hits"] == hits + 1
    torch.testing.assert_close(A1.value, A2.value, rtol=0, atol=0)


@pytest.mark.parametrize("graph", ["g2", "g2p"])
def test_counters_match_reference(graph):
    """Compiles/launches/groups/slots per drain and memo hits equal the JAX
    package's for the same program."""
    from repro.core.executors import clear_compile_cache as jclear
    from repro.linalg.cholesky import utp_cholesky as jutp

    a = jcore.spd_matrix(64, seed=5)
    got, want = [], []
    clear_compile_cache()
    jclear()
    for _ in range(2):
        d, _, n = _drain(graph, torch.from_numpy(np.array(a)))
        got.append((n, dict(d.executor.stats), d.stats["memo_hits"], d.stats["split"]))
        jd = jcore.Dispatcher(graph=graph)
        jutp(jd, jcore.GData(a.shape, partitions=((4, 4),), dtype=a.dtype, value=a))
        jn = jd.run()
        keys = ("compiles", "launches", "groups", "groups_prefusion", "slots", "tasks")
        want.append((jn, {k: jd.executor.stats[k] for k in keys if k in jd.executor.stats},
                     jd.stats["memo_hits"], jd.stats["split"]))
    for g, w in zip(got, want):
        assert (g[0], {k: g[1][k] for k in w[1] if k in g[1]}, g[2], g[3]) == w
        assert set(w[1]) <= set(g[1])


def test_verify_mode_proves_the_plan():
    clear_compile_cache()
    before = verifier_stats()["verified"] + verifier_stats()["cache_hits"]
    a = tcore.spd_matrix(64, seed=3, device="cpu")
    d, A, _ = _drain("g2p", a, verify=True)
    assert d.stats["verified_scopes"] == 2  # root scope and leaf scope
    assert d.executor.stats["verified_plans"] == 1
    assert verifier_stats()["verified"] + verifier_stats()["cache_hits"] == before + 1
    L = torch.tril(A.value)
    torch.testing.assert_close(L @ L.T, a, rtol=2e-4, atol=2e-4)


def test_verify_env_default(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY", "1")
    assert tcore.Dispatcher("g2").verify
    monkeypatch.setenv("REPRO_VERIFY", "0")
    assert not tcore.Dispatcher("g2").verify


# --------------------------------------------------------------------------
# Storage ownership: in-place kernels must never write a caller's tensor
# --------------------------------------------------------------------------
def test_gdata_copies_on_ingest_and_degrid():
    a = tcore.spd_matrix(32, seed=1, device="cpu")
    a0 = a.clone()
    A = tcore.GData(a.shape, partitions=((4, 1),), value=a, device="cpu")
    held = A.value
    assert held.data_ptr() != a.data_ptr()
    g = A.enter_grid(8, 32)  # nc == 1: the grid-major layout equals the root's
    g.zero_()  # what an in-place kernel does to the resident grid
    assert torch.equal(a, a0) and torch.equal(held, a0)
    g4 = torch.arange(2 * 1 * 4 * 8, dtype=torch.float32).reshape(2, 1, 4, 8)
    r = from_grid(g4)
    assert r.data_ptr() != g4.data_ptr() and torch.equal(to_grid(r, 4, 8), g4)
    assert to_grid(r, 4, 8).data_ptr() != r.data_ptr()


@pytest.mark.parametrize("graph", ["g1", "g2", "g2p"])
def test_value_read_before_redrain_is_not_mutated(graph):
    """A tensor read through ``.value`` stays as read, though the next drain
    factors the same GData again in place."""
    clear_compile_cache()
    a = tcore.spd_matrix(32, seed=2, device="cpu")
    d = tcore.Dispatcher(graph=graph)
    A = tcore.GData(a.shape, partitions=((2, 2),), value=a, device="cpu")
    held = A.value
    utp_cholesky(d, A)
    d.run()
    once = A.value
    assert torch.equal(held, a)
    once0 = once.clone()
    utp_cholesky(d, A)
    d.run()
    assert torch.equal(once, once0)
    assert not torch.equal(A.value, once0)  # the second drain did run


def test_fallback_per_group_path_pads_and_matches(monkeypatch):
    """A schedule that is not grid-uniform runs group by group, each group
    at its exact size (no padding), and still factors correctly without
    writing the tensor its caller holds."""
    from repro_torch.core.executors import WaveExecutor, jit_wave

    clear_compile_cache()
    a = tcore.spd_matrix(32, seed=4, device="cpu")
    A = tcore.GData(a.shape, partitions=((4, 4),), value=a, device="cpu")
    held = A.value
    root = tcore.GTask(TPOTRF, None, [A.root_view()])
    kids = []
    TPOTRF.split(root, kids.append)
    tracker = tcore.DepTracker()
    for t in kids:
        tracker.add(t)
    waves = tracker.waves()
    # as plan_schedule answers for a schedule that is not grid-uniform
    monkeypatch.setattr(jit_wave, "plan_schedule", lambda waves, dag=None: None)
    ex = WaveExecutor()
    sizes = []
    group_fn = ex._group_fn

    def spy(op, rep, roots_order):
        fn = group_fn(op, rep, roots_order)
        return lambda roots, idxs: (sizes.append(len(idxs[0])), fn(roots, idxs))

    ex._group_fn = spy
    n = ex.execute_schedule(waves, tracker.dag())
    assert n == 20 and ex.stats["tasks"] == 20
    assert ex.stats["launches"] == sum(len(group_wave(w)) for w in waves)
    assert sizes == [len(g) for w in waves for g in group_wave(w).values()]
    assert 3 in sizes  # a size a power-of-two pad would have changed
    assert ex.epoch.label == "group" and ex.epoch.is_ready()
    assert torch.equal(held, a)
    L = torch.tril(A.value)
    torch.testing.assert_close(L, torch.linalg.cholesky(a), rtol=2e-4, atol=2e-4)


def test_plan_schedule_falls_back_on_nonuniform_blocks():
    class W(tcore.Operation):
        name = "w_nonuniform_torch"

        def default_modes(self, n):
            return [tcore.Access.READWRITE]

    A = tcore.GData((8, 8), partitions=((2, 2), (2, 2)), value=np.eye(8, dtype=np.float32), device="cpu")
    t_big = tcore.GTask(W(), None, [A(0, 0)])
    t_small = tcore.GTask(W(), None, [A(1, 1)(0, 0)])
    assert tplan([[t_big], [t_small]]) is None
    B = tcore.GData((8, 8), partitions=((2, 2),), device="cpu")
    assert tplan([[tcore.GTask(W(), None, [B(0, 0)])]]) is None


def test_default_batched_leaf_is_vmap():
    class Scale(tcore.Operation):
        name = "scale_torch"

        def leaf_fn(self, backend):
            return lambda x: 2 * x

    x = torch.randn(3, 4, 4)
    torch.testing.assert_close(Scale().batched_leaf_fn("torch")(x), 2 * x)


def test_graph_table_and_undistributed_executors():
    import repro.core.graph as jgraph

    assert set(tcore.GRAPHS) == set(jgraph.GRAPHS)
    for name, g in tcore.GRAPHS.items():
        jg = jgraph.GRAPHS[name]
        assert (g.split_levels, g.distributed) == (jg.split_levels, jg.distributed)
    assert tcore.Dispatcher("g2p").executor.backend == "cuda"
    assert tcore.Dispatcher("g2").executor.backend == "torch"
    assert tcore.Dispatcher("g1").executor.backend == "torch"
    for name in ("g3", "g4", "g3flat"):
        with pytest.raises(NotImplementedError, match="A10"):
            tcore.Dispatcher(graph=name)
    with pytest.raises(KeyError):
        tcore.get_graph("g9")


def test_inflight_epoch_on_cpu_is_complete():
    ep = tcore.InFlightEpoch(torch.device("cpu"), "x")
    assert ep.event is None and ep.is_ready() and ep.wait() >= 0.0
    clear_compile_cache()
    a = tcore.spd_matrix(32, seed=6, device="cpu")
    for label in ("program", "replay"):
        d, _, _ = _drain("g2p", a)
        assert d.executor.epoch.label == label
        assert d.executor.epoch.is_ready() and d.executor.epoch.event is None


def test_drain_memo_lru_bounds():
    m = DrainMemo(capacity=2)
    for k in "abc":
        m[k] = k
    assert len(m) == 2 and "a" not in m and m.evictions == 1
    assert m.get("b") == "b" and m.get("z") is None
    assert (m.hits, m.misses) == (1, 1)
    m["d"] = "d"  # "b" was used last, so "c" goes
    assert "b" in m and "c" not in m and m.evictions == 2
    assert m.stats() == {"entries": 2, "capacity": 2, "hits": 1, "misses": 1, "evictions": 2}


def test_paper_facade_runs_a_drain():
    d = tcore.utp_initialize("g2")
    a = tcore.spd_matrix(32, seed=8, device="cpu")
    A = tcore.GData(a.shape, partitions=((2, 2),), value=a, device="cpu")
    utp_cholesky(tcore.dispatcher(), A)
    assert tcore.utp_finalize() == 4 and tcore.dispatcher() is d
    assert tcore.utp_get_parameters(["64", "2", "x", "4"]) == (64, 2, 4)
    with pytest.raises(ValueError):
        tcore.utp_get_parameters(["-4"])
