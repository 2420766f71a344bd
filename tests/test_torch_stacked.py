"""Stacked drains in the port against the JAX package on the CPU
(counterpart of tests/test_stacked_drain.py, DESIGN.md §7).

The same numpy inputs go through ``repro`` and ``repro_torch``: stacked
lanes on ``GData``, stacking detection (homogeneous streams stack;
heterogeneous, data-sharing, mixed-geometry and opted-out streams keep
segment fusion), one launch and one build per stacked drain, the
bucket-keyed memo, the build sweep over N = 1..16, the composed LU solve,
the bystander lane and the repeat-drain grid reuse, the value-dependent
abort, the LRU drain memo, and the served buckets' template counters.
Results agree within the JAX tests' tolerances and every structural
counter is equal.
"""

import types

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.executors.jit_wave as jjw
import repro.linalg as jlin
import repro_torch.core as tcore
import repro_torch.core.executors.jit_wave as tjw
import repro_torch.linalg as tlin
from repro.core.executors import clear_compile_cache as jclear
from repro.errors import ScheduleVerificationError as JSVE
from repro.testing import faults as jfaults
from repro_torch.core.data import StackedEpoch, from_grid, to_grid
from repro_torch.core.executors import clear_compile_cache as tclear
from repro_torch.errors import ScheduleVerificationError
from repro_torch.testing import faults as tfaults

J = types.SimpleNamespace(core=jcore, lin=jlin, jw=jjw, clear=jclear, kw={}, wave="jit_wave")
T = types.SimpleNamespace(core=tcore, lin=tlin, jw=tjw, clear=tclear, kw={"device": "cpu"}, wave="wave")


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    jfaults.reset()
    tfaults.reset()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _dd(n, seed):
    return _np(jcore.dd_matrix(n, seed=seed))


def _spd(n, seed):
    return _np(jcore.spd_matrix(n, seed=seed))


def _gdata(pkg, m, parts):
    return pkg.core.GData(m.shape, partitions=parts, value=m, **pkg.kw)


def _stacked_lu_drain(pkg, mats, p, graph="g2", **dkw):
    d = pkg.core.Dispatcher(graph=graph, **dkw)
    roots = []
    for m in mats:
        A = _gdata(pkg, m, ((p, p),))
        pkg.lin.utp_getrf(d, A)
        roots.append(A)
    n = d.run()
    return d, roots, n


def _counters(d, leaves=None):
    st = d.executor.stats
    return dict(
        leaves=leaves,
        stacked=d.stats["stacked_drains"],
        hits=d.stats["memo_hits"],
        misses=d.stats["memo_misses"],
        split=d.stats["split"],
        launches=st.get("launches", 0),
        compiles=st.get("compiles", 0),
        groups=st.get("groups", 0),
        prefusion=st.get("groups_prefusion", 0),
        slots=st.get("slots", 0),
    )


def _both(fn):
    """Run ``fn(pkg)`` for the JAX package then the port, each on fresh caches."""
    out = []
    for pkg in (J, T):
        pkg.clear()
        out.append(fn(pkg))
    return out


# --------------------------------------------------------------------------
# GData stacked-epoch lanes
# --------------------------------------------------------------------------
class TestStackedEpochLanes:
    def _epoch(self, vals, br=4, bc=4):
        grid = torch.stack([to_grid(torch.from_numpy(v), br, bc) for v in vals])
        return StackedEpoch(grid, (br, bc))

    def test_value_reads_lane(self):
        vals = [np.arange(64, dtype=np.float32).reshape(8, 8) + 100 * i for i in range(3)]
        ep = self._epoch(vals)
        datas = [tcore.GData((8, 8), device="cpu") for _ in range(3)]
        for i, d in enumerate(datas):
            d.adopt_lane(ep, i)
            assert d.has_value and not d.in_grid_epoch
        assert ep.holders == 3
        for i, d in enumerate(datas):
            np.testing.assert_array_equal(d.value.numpy(), vals[i])
            assert d.lane is None  # resolved
        assert ep.holders == 0

    def test_enter_grid_slices_lane_without_roundtrip(self):
        vals = [np.full((8, 8), float(i), dtype=np.float32) for i in range(2)]
        ep = self._epoch(vals)
        d = tcore.GData((8, 8), device="cpu")
        d.adopt_lane(ep, 1)
        g = d.enter_grid(4, 4)
        assert d.in_grid_epoch and d.grid_block == (4, 4)
        np.testing.assert_array_equal(from_grid(g).numpy(), vals[1])
        # a copy, not a view of the shared epoch: an in-place drain of this
        # datum must not write into its former lane
        g.add_(1.0)
        np.testing.assert_array_equal(from_grid(ep.grid[1]).numpy(), vals[1])

    def test_enter_grid_other_block_flushes_through_value(self):
        vals = [np.arange(64, dtype=np.float32).reshape(8, 8)]
        ep = self._epoch(vals)
        d = tcore.GData((8, 8), device="cpu")
        d.adopt_lane(ep, 0)
        g = d.enter_grid(2, 2)
        np.testing.assert_array_equal(from_grid(g).numpy(), vals[0])

    def test_value_write_drops_lane(self):
        ep = self._epoch([np.zeros((8, 8), dtype=np.float32)])
        d = tcore.GData((8, 8), device="cpu")
        d.adopt_lane(ep, 0)
        d.value = torch.ones((8, 8))
        assert d.lane is None and ep.holders == 0
        np.testing.assert_array_equal(d.value.numpy(), np.ones((8, 8)))

    def test_adopt_lane_shape_mismatch_raises(self):
        ep = self._epoch([np.zeros((8, 8), dtype=np.float32)])
        d = tcore.GData((16, 16), device="cpu")
        with pytest.raises(ValueError, match="stacked lane shape"):
            d.adopt_lane(ep, 0)


# --------------------------------------------------------------------------
# Stacked drains: detection, one launch/build, numerics
# --------------------------------------------------------------------------
@pytest.mark.parametrize("graph", ["g2", "g2p"])
def test_stacked_lu_one_launch_one_compile(graph):
    n, p, N = 64, 4, 3
    mats = [_dd(n, s) for s in range(N)]
    (jd, jroots, jn), (td, troots, tn) = _both(lambda pkg: _stacked_lu_drain(pkg, mats, p, graph))
    assert _counters(td, tn) == _counters(jd, jn)
    assert td.stats["stacked_drains"] == 1 and tn == 30
    assert td.executor.stats["launches"] == 1 and td.executor.stats["compiles"] == 1
    for jA, tA in zip(jroots, troots):
        np.testing.assert_allclose(tA.value.numpy(), np.asarray(jA.value), rtol=1e-6, atol=1e-6)


def test_stacked_memo_key_is_bucket_not_n():
    """N=3 and N=4 share the pow2 bucket 4: after an N=4 capture, an N=3
    drain is a pure replay with no build and no re-splitting."""
    n, p = 64, 4
    mats4 = [_dd(n, s) for s in range(4)]
    mats3 = [_dd(n, 10 + s) for s in range(3)]

    def run(pkg):
        d4, _, l4 = _stacked_lu_drain(pkg, mats4, p)
        d3, roots3, l3 = _stacked_lu_drain(pkg, mats3, p)
        return _counters(d4, l4), _counters(d3, l3), [_np(A.value) for A in roots3]

    (j4, j3, jv), (t4, t3, tv) = _both(run)
    assert (t4, t3) == (j4, j3)
    assert t4["compiles"] == 1 and t4["misses"] == 1
    assert t3["hits"] == 1 and t3["compiles"] == 0 and t3["launches"] == 1 and t3["split"] == t4["split"]
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_stacked_compile_sweep_is_olog_n():
    """Batch sizes 1..16 bucket to {1 (unstacked), 2, 4, 8, 16}: exactly
    log2(16) + 1 = 5 built lists across the whole sweep, as in JAX."""
    n, p = 32, 2

    def sweep(pkg):
        builds = []
        for N in range(1, 17):
            mats = [_dd(n, N * 16 + s) for s in range(N)]
            d, roots, _ = _stacked_lu_drain(pkg, mats, p)
            builds.append(d.executor.stats.get("compiles", 0))
            for A, m in zip(roots, mats):
                packed = _np(A.value)
                l = np.tril(packed, -1) + np.eye(n)
                np.testing.assert_allclose(l @ np.triu(packed), m, rtol=2e-4, atol=2e-4)
        return builds

    jb, tb = _both(sweep)
    assert tb == jb and sum(tb) == 5


def test_stacked_composed_lu_solve():
    n, p, N = 64, 4, 3
    rng = np.random.default_rng(3)
    mats = [_dd(n, 40 + s) for s in range(N)]
    rhss = [rng.standard_normal((n, 8)).astype(np.float32) for _ in range(N)]
    kw = dict(partitions=((p, p),), b_partitions=((p, 1),))
    jx, tx = _both(lambda pkg: pkg.lin.run_lu_solve_batched(mats, rhss, **kw, **pkg.kw))
    singles = [tlin.run_lu_solve(a, b, **kw, device="cpu") for a, b in zip(mats, rhss)]
    for x, j, s in zip(tx, jx, singles):
        np.testing.assert_allclose(x.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(x.numpy(), s.numpy(), rtol=1e-5, atol=1e-5)


def test_run_lu_batched_replays_and_matches():
    n, p = 64, 4
    mats = [_dd(n, 60 + s) for s in range(4)]
    mats2 = [_dd(n, 70 + s) for s in range(4)]
    tclear()
    outs = tlin.run_lu_batched(mats, partitions=((p, p),), device="cpu")
    before = tjw.drain_memo_stats()["hits"]
    outs2 = tlin.run_lu_batched(mats2, partitions=((p, p),), device="cpu")  # memo replay
    assert tjw.drain_memo_stats()["hits"] == before + 1
    jouts = jlin.run_lu_batched(mats + mats2, partitions=((p, p),))
    for (l, u), (jl, ju), m in zip(outs + outs2, jouts, mats + mats2):
        np.testing.assert_allclose((l @ u).numpy(), m, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)


def test_redraining_subset_of_stacked_members_keeps_bystander_lane_valid():
    """After a stacked N=4 drain, re-draining only 3 of the members must not
    run in place on the shared epoch grid (the 4th member still holds a
    lane of it): the holders count on StackedEpoch guards this."""
    tclear()
    n, p = 32, 2
    mats = [_dd(n, 90 + s) for s in range(4)]
    d, roots, _ = _stacked_lu_drain(T, mats, p)
    ep = roots[0].lane[0]
    assert d.stats["stacked_drains"] == 1 and ep.holders == 4
    d2 = tcore.Dispatcher(graph="g2")
    for A in roots[:3]:
        tlin.utp_getrf(d2, A)
    d2.run()
    assert d2.stats["stacked_drains"] == 1
    assert roots[0].lane[0] is not ep and roots[0].lane[0].grid.data_ptr() != ep.grid.data_ptr()
    # the bystander's lane must still read its ORIGINAL factor
    packed = roots[3].value.numpy()
    l = np.tril(packed, -1) + np.eye(n)
    np.testing.assert_allclose(l @ np.triu(packed), mats[3], rtol=2e-4, atol=2e-4)


def test_repeat_drain_on_same_members_reuses_epoch_grid():
    """The repeat-drain fast path: draining the SAME member set again finds
    them as lanes 0..N-1 of one epoch (sole holders) and runs the next list
    in place on that grid.  The second factor runs on the first's output."""
    n, p = 32, 2
    mats = [_dd(n, 95 + s) for s in range(2)]

    def run(pkg):
        _, roots, _ = _stacked_lu_drain(pkg, mats, p)
        ptr = roots[0].lane[0].grid.data_ptr() if pkg is T else None
        d2 = pkg.core.Dispatcher(graph="g2")
        for A in roots:
            pkg.lin.utp_getrf(d2, A)
        d2.run()
        if pkg is T:
            assert roots[0].lane[0].grid.data_ptr() == ptr  # reused in place
        return _counters(d2), [_np(A.value) for A in roots]

    (jc, jv), (tc, tv) = _both(run)
    assert tc == jc and tc["stacked"] == 1 and tc["compiles"] == 0
    for A, m, j in zip(tv, mats, jv):
        np.testing.assert_allclose(A, j, rtol=1e-5, atol=1e-5)
        ref1 = tlin.run_lu(m, partitions=((p, p),), device="cpu")
        ref_packed = torch.tril(ref1[0], -1) + ref1[1]
        ref2 = tlin.run_lu(ref_packed, partitions=((p, p),), device="cpu")
        np.testing.assert_allclose(np.tril(A, -1) + np.eye(n), ref2[0].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.triu(A), ref2[1].numpy(), rtol=1e-5, atol=1e-5)


def test_lane_alias_fault_caught_by_v5():
    """``plan.alias_lane`` aliases lane 1 to lane 0's data; with
    verification on, V5 rejects the stacked drain in both packages."""
    mats = [_dd(32, s) for s in range(3)]
    for pkg, faults, err in ((J, jfaults, JSVE), (T, tfaults, ScheduleVerificationError)):
        pkg.clear()
        with faults.inject("plan.alias_lane"), pytest.raises(err, match="lane_alias"):
            _stacked_lu_drain(pkg, mats, 2, verify=True)


# --------------------------------------------------------------------------
# Fallback contract: when streams do NOT stack
# --------------------------------------------------------------------------
def test_heterogeneous_stream_keeps_segment_fusion():
    n, p = 64, 4
    a, b = _dd(n, 81), _spd(n, 82)

    def run(pkg):
        d = pkg.core.Dispatcher(graph="g2")
        pkg.lin.utp_getrf(d, _gdata(pkg, a, ((p, p),)))
        pkg.lin.utp_cholesky(d, _gdata(pkg, b, ((p, p),)))
        return _counters(d, d.run())

    jc, tc = _both(run)
    assert tc == jc and tc["stacked"] == 0 and tc["launches"] == 1


def test_shared_data_roots_do_not_stack():
    """Two GETRF roots on the SAME datum are a dependent chain, not a batch."""
    m = _dd(64, 83)

    def run(pkg):
        d = pkg.core.Dispatcher(graph="g2")
        X = _gdata(pkg, m, ((4, 4),))
        pkg.lin.utp_getrf(d, X)
        pkg.lin.utp_getrf(d, X)
        return _counters(d, d.run()), _np(X.value)

    (jc, jv), (tc, tv) = _both(run)
    assert tc == jc and tc["stacked"] == 0
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)


def test_mixed_geometry_stream_does_not_stack():
    def run(pkg):
        d = pkg.core.Dispatcher(graph="g2")
        for n in (64, 32):
            pkg.lin.utp_getrf(d, _gdata(pkg, _dd(n, 84), ((4, 4),)))
        return _counters(d, d.run())

    jc, tc = _both(run)
    assert tc == jc and tc["stacked"] == 0


def test_stack_roots_opt_out_pins_segment_fusion():
    mats = [_dd(64, s) for s in (85, 86)]
    jc, tc = _both(lambda pkg: _counters(_stacked_lu_drain(pkg, mats, 4, stack_roots=False)[0]))
    assert tc == jc and tc["stacked"] == 0 and tc["launches"] == 1
    assert tc["prefusion"] == 2 * tc["groups"]


def _value_dependent_ops(core):
    """A memoizable root whose expansion SPLITS a non-memoizable op, in one
    package's Operation algebra."""

    class Inner(core.Operation):
        name = f"stk_inner_vd_{core.__name__.split('.')[0]}"
        memoizable = False

        def default_modes(self, n):
            return [core.Access.READWRITE]

        def leaf_fn(self, backend):
            return lambda b: b + 1.0

        def split(self, task, submit):
            A = task.args[0]
            for i in range(A.row_part_num()):
                for j in range(A.col_part_num()):
                    submit(core.GTask(inner, task, [A(i, j)]))

    class Outer(Inner):
        name = f"stk_outer_{core.__name__.split('.')[0]}"
        memoizable = True

    inner = Inner()
    return Outer()


def test_value_dependent_split_below_root_aborts_stacking():
    def run(pkg):
        outer = _value_dependent_ops(pkg.core)
        graph = pkg.core.TaskFlowGraph("g2deep", split_levels=2, leaf_executor=pkg.wave)
        d = pkg.core.Dispatcher(graph=graph)
        roots = []
        for _ in range(2):
            A = _gdata(pkg, np.zeros((8, 8), dtype=np.float32), ((2, 2), (2, 2)))
            d.submit_task(pkg.core.GTask(outer, None, [A.root_view()]))
            roots.append(A)
        n = d.run()
        return _counters(d, n), [_np(A.value) for A in roots]

    (jc, jv), (tc, tv) = _both(run)
    assert tc == jc and tc["stacked"] == 0  # aborted, not stacked
    for v in tv + jv:
        np.testing.assert_array_equal(v, np.ones((8, 8), dtype=np.float32))


# --------------------------------------------------------------------------
# Drain memo: counters, LRU, capacity, discard, shed
# --------------------------------------------------------------------------
def test_dispatcher_memo_counters_on_unstacked_drains():
    a = _spd(32, 5)

    def run(pkg):
        out = []
        for _ in range(2):
            d = pkg.core.Dispatcher(graph="g2")
            pkg.lin.utp_cholesky(d, _gdata(pkg, a, ((4, 4),)))
            d.run()
            out.append(_counters(d))
        return out

    jc, tc = _both(run)
    assert tc == jc
    assert (tc[0]["misses"], tc[0]["hits"], tc[1]["misses"], tc[1]["hits"]) == (1, 0, 0, 1)


def _chol_drain(pkg, p, n=32):
    d = pkg.core.Dispatcher(graph="g2")
    pkg.lin.utp_cholesky(d, _gdata(pkg, _spd(n, p), ((p, p),)))
    d.run()
    return d


def test_drain_memo_lru_eviction_and_recapture():
    def run(pkg):
        memo = pkg.jw._DRAIN_MEMO
        old = memo.capacity
        try:
            pkg.jw.set_drain_memo_capacity(2)
            ev0 = memo.evictions
            for p in (2, 4, 8):
                _chol_drain(pkg, p)
            trace = [len(memo), memo.evictions - ev0]
            d = _chol_drain(pkg, 2)  # evicted structure: miss + re-capture
            trace += [d.stats["memo_misses"], d.stats["memo_hits"], len(memo)]
            d = _chol_drain(pkg, 2)  # memoized again
            st = pkg.jw.drain_memo_stats()
            return trace + [d.stats["memo_hits"], st["capacity"], st["entries"], memo.evictions - ev0]
        finally:
            pkg.jw.set_drain_memo_capacity(old)
            pkg.clear()

    jt, tt = _both(run)
    assert tt == jt == [2, 1, 1, 0, 2, 1, 2, 2, 2]


def test_set_drain_memo_capacity_validates():
    with pytest.raises(ValueError):
        tjw.set_drain_memo_capacity(0)


def test_drain_memo_capacity_shrink_evicts_immediately():
    def run(pkg):
        memo = pkg.jw._DRAIN_MEMO
        old = memo.capacity
        try:
            pkg.jw.set_drain_memo_capacity(8)
            for p in (2, 4, 8):
                _chol_drain(pkg, p)
            sizes = [len(memo)]
            pkg.jw.set_drain_memo_capacity(1)
            return sizes + [len(memo)]
        finally:
            pkg.jw.set_drain_memo_capacity(old)
            pkg.clear()

    jt, tt = _both(run)
    assert tt == jt == [3, 1]


def test_drain_memo_discard_and_shed():
    def run(pkg):
        m = pkg.jw.DrainMemo(capacity=8)
        for k in "abcde":
            m[k] = k
        m.discard("b")
        m.discard("zz")  # absent: no-op
        shed = m.shed(0.5) if pkg is J else m.shed()  # the port sheds half, always
        return shed, [k for k in "abcde" if k in m], m.stats()

    jt, tt = _both(run)
    assert tt == jt
    assert tt[0] == 2 and tt[1] == ["d", "e"]
    assert tt[2]["invalidations"] == 1 and tt[2]["pressure_sheds"] == 2


def test_drain_memo_pressure_sheds_global_lru_tail():
    def run(pkg):
        for p in (2, 4, 8, 16):
            _chol_drain(pkg, p, n=64)
        shed = pkg.jw.drain_memo_pressure(0.5) if pkg is J else pkg.jw.drain_memo_pressure()
        return shed, pkg.jw.drain_memo_stats()["entries"], pkg.jw.drain_memo_stats()["pressure_sheds"]

    jt, tt = _both(run)
    assert tt == jt and tt[:2] == (2, 2)


# --------------------------------------------------------------------------
# The served buckets' template counters (n = 64, 8 x 8 partitions, B = 4)
# --------------------------------------------------------------------------
TEMPLATES = {  # bucket -> (leaves, groups, prefusion, slots) of the template plan
    "lu_solve": (276, 80, 80, 59),
    "lu": (204, 29, 29, 22),
    "cholesky": (120, 28, 28, 22),
}


def _bucket_drain(pkg, kind, graph, B=4, n=64, p=8):
    rng = np.random.default_rng(7)
    d = pkg.core.Dispatcher(graph=graph)
    outs = []
    for s in range(B):
        if kind == "cholesky":
            A = _gdata(pkg, _spd(n, s), ((p, p),))
            pkg.lin.utp_cholesky(d, A)
            outs.append(A)
        elif kind == "lu":
            A = _gdata(pkg, _dd(n, s), ((p, p),))
            pkg.lin.utp_getrf(d, A)
            outs.append(A)
        else:
            A = _gdata(pkg, _dd(n, s), ((p, p),))
            Bv = _gdata(pkg, rng.standard_normal((n, 1)).astype(np.float32), ((p, 1),))
            pkg.lin.utp_lu_solve(d, A, Bv)
            outs.append(Bv)
    leaves = d.run()
    return _counters(d, leaves), [_np(X.value) for X in outs]


@pytest.mark.parametrize("kind", list(TEMPLATES))
def test_served_bucket_template_counters_match_reference(kind):
    jc, jv = _both(lambda pkg: _bucket_drain(pkg, kind, "g2"))[0]
    want = dict(zip(("leaves", "groups", "prefusion", "slots"), TEMPLATES[kind]))
    assert {k: jc[k] for k in want} == want
    assert (jc["launches"], jc["compiles"], jc["stacked"]) == (1, 1, 1)
    for graph in ("g2", "g2p"):
        tclear()
        tc, tv = _bucket_drain(T, kind, graph)
        assert tc == jc, graph
        for x, j in zip(tv, jv):
            np.testing.assert_allclose(x, j, rtol=1e-4, atol=1e-4)
