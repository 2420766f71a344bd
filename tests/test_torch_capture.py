"""Captured launch lists (``repro_torch.core.executors.captured``) on the
CPU, against the JAX package's jitted WaveProgram, and the g1/g2 Cholesky
leaf on input that is not positive definite (ROADMAP C4).

On the CPU a captured program runs its launch list eagerly over its static
grids (CUDA graphs exist only on the card), so these tests exercise what
capture rests on: the static storage and its copy-in, the aliasing rule
that hands static grids to the drain's handles, the index copy, the
recorded kernel-launch tally, the bounded program cache and the fault
sites.  Sizes are small: n = 64-256, 4 x 4 partitions, buckets <= 4.
Tolerances are the JAX tests': 2e-4 for the factors and solutions."""

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.executors.jit_wave as jjw
import repro.linalg as jlin
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.core.executors.captured as tcap
import repro_torch.core.executors.jit_wave as tjw
import repro_torch.linalg as tlin
import repro_torch.serve as tserve
from repro.core.executors import clear_compile_cache as jclear
from repro_torch.core.executors import clear_compile_cache as tclear
from repro_torch.kernels import tile_linalg as tl
from repro_torch.linalg.ops import POTRF
from repro_torch.testing import faults as tfaults

TOL = 2e-4
STATS = ("compiles", "launches", "tasks", "groups", "groups_prefusion", "slots")


@pytest.fixture(autouse=True)
def _fresh_caches():
    jclear()
    tclear()
    yield
    tfaults.reset()
    tjw._PROGRAMS.set_capacity(64)


def _spd(n, seed):
    return tcore.spd_matrix(n, seed=seed, device="cpu").numpy()


def _dd(n, seed):
    return tcore.dd_matrix(n, seed=seed, device="cpu").numpy()


def _rhs(n, m, seed):
    shape = (n,) if m is None else (n, m)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _grid_value(d):
    return d.value.numpy() if hasattr(d.value, "numpy") else np.asarray(d.value)


def _drain(pkg, graph, kind, seed, n=128, p=4, m=None):
    """One drain of ``kind`` on a fresh dispatcher of ``pkg`` (the JAX
    package or the port); returns (result, executor counters, memo hits)."""
    core, lin = (jcore, jlin) if pkg == "jax" else (tcore, tlin)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    d = core.Dispatcher(graph=graph)
    if kind == "cholesky":
        A = core.GData((n, n), partitions=((p, p),), value=_spd(n, seed), **kw)
        lin.utp_cholesky(d, A)
        out = A
    else:
        b = _rhs(n, m, seed)
        b2 = b[:, None] if m is None else b
        A = core.GData((n, n), partitions=((p, p),), value=_dd(n, seed), **kw)
        out = core.GData(b2.shape, partitions=((p, 1 if m is None else 2),), value=b2, **kw)
        lin.utp_lu_solve(d, A, out)
    d.run()
    res = _grid_value(out)
    if kind == "cholesky":
        res = np.tril(res)
    st = d.executor.stats
    return res, {k: st.get(k, 0) for k in STATS}, d.stats["memo_hits"]


CASES = [("g2", "cholesky", None), ("g2p", "cholesky", None), ("g2p", "lu_solve", 16), ("g2p", "lu_solve", None),
         ("g2", "lu_solve", 16)]


@pytest.mark.parametrize("graph,kind,m", CASES)
def test_first_drain_replays_and_fresh_plan_match_reference(graph, kind, m):
    """A first drain, two memo replays on fresh values, and a structurally
    equal drain re-planned on a fresh dispatcher (drain memo dropped, the
    captured program kept, its indices copied in) each match the JAX
    package's drain of the same inputs, with equal counters."""
    for step, seed in enumerate((0, 1, 2, 3)):
        if step == 3:
            jjw._DRAIN_MEMO.clear()
            tjw._DRAIN_MEMO.clear()
        want, jst, jhits = _drain("jax", graph, kind, seed, m=m)
        got, tst, thits = _drain("torch", graph, kind, seed, m=m)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert tst == jst and thits == jhits == int(step in (1, 2))
        assert tst["compiles"] == int(step == 0) and tst["launches"] == 1
    assert tjw.program_cache_stats()["entries"] == 1


def test_plan_key_does_not_fix_block_indices():
    """Two root tasks on different level-0 blocks of one datum plan the same
    structure (one plan key, one captured program) over other block
    indices: the second drain copies its indices into the static tensor."""
    n = 64
    a = _spd(n, 5)
    plans = []
    real = tjw.plan_schedule

    def keep(*args, **kw):
        plans.append(real(*args, **kw))
        return plans[-1]

    results = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjw, "plan_schedule", keep)
        for blk in (0, 1):
            d = tcore.Dispatcher(graph="g2p")
            A = tcore.GData((n, n), partitions=((2, 2), (2, 2)), value=a, device="cpu")
            d.submit_task(tcore.GTask(POTRF, None, [A(blk, blk)]))
            d.run()
            results.append(_grid_value(A))
            assert d.executor.stats.get("compiles", 0) == int(blk == 0)
    assert plans[0].key == plans[1].key
    assert not torch.equal(plans[0].flat_idxs, plans[1].flat_idxs)
    assert tjw.program_cache_stats()["entries"] == 1
    for blk, res in zip((0, 1), results):
        s = slice(32 * blk, 32 * blk + 32)
        np.testing.assert_allclose(np.tril(res[s, s]), np.linalg.cholesky(a[s, s].astype(np.float64)),
                                   rtol=TOL, atol=TOL)


def test_replay_leaves_an_earlier_handle_its_result():
    """Drain 1's handle keeps reading its own factor after drain 2 replayed
    the same program: the static grid moves to drain 2's handle, and drain
    1's handle gets a copy first.  A handle re-drained in place keeps the
    static grid with no copy."""
    n, p = 64, 4
    mats = [_spd(n, s) for s in (1, 2)]
    outs = []
    for a in mats:
        d = tcore.Dispatcher(graph="g2p")
        A = tcore.GData((n, n), partitions=((p, p),), value=a, device="cpu")
        tlin.utp_cholesky(d, A)
        d.run()
        outs.append((A, d.executor.last_program))
    (A1, prog), (A2, prog2) = outs
    assert prog is prog2 and A2.grid is prog.grids[0] and A1.grid is not prog.grids[0]
    for (A, _), a in zip(outs, mats):
        np.testing.assert_allclose(np.tril(_grid_value(A)), np.linalg.cholesky(a.astype(np.float64)),
                                   rtol=TOL, atol=TOL)
    # LU twice on one handle: the second drain runs in place on its grid
    d = tcore.Dispatcher(graph="g2p")
    B = tcore.GData((n, n), partitions=((p, p),), value=_dd(n, 3), device="cpu")
    tlin.utp_getrf(d, B)
    d.run()
    grid = B.grid
    d = tcore.Dispatcher(graph="g2p")
    tlin.utp_getrf(d, B)
    d.run()
    assert B.grid is grid is d.executor.last_program.grids[0]


@pytest.mark.parametrize("graph", ["g2", "g2p"])
def test_stacked_tick_futures_keep_their_lanes(graph):
    """A served tick's futures hold lanes of the static stacked grid; the
    next tick with fresh requests replays the same program, and the first
    tick's futures, read only afterwards, still give their own factors."""
    n, p = 64, 4
    srv = tserve.BatchServer(graph=graph, device="cpu")
    ticks = []
    for t in range(2):
        mats = [_spd(n, 10 * t + k) for k in range(3)]
        futs = [srv.cholesky(a, partitions=((p, p),)) for a in mats]
        rep = srv.tick()
        assert rep.resolved == 3 and rep.compiles == int(t == 0) and rep.stacked_drains == 1
        ticks.append((mats, futs))
    for mats, futs in ticks:
        for a, f in zip(mats, futs):
            np.testing.assert_allclose(f.result().numpy(), np.linalg.cholesky(a.astype(np.float64)),
                                       rtol=TOL, atol=TOL)


def test_repeat_stacked_drain_runs_on_the_static_grid():
    """The repeat-tick fast path: the same members, lanes 0..N-1 of the
    static grid's epoch and its only holders, run in place on it."""
    n, p = 32, 2
    roots = [tcore.GData((n, n), partitions=((p, p),), value=_dd(n, s), device="cpu") for s in range(3)]
    for _ in range(2):
        d = tcore.Dispatcher(graph="g2p")
        for A in roots:
            tlin.utp_getrf(d, A)
        d.run()
        ep = roots[0].lane[0]
        assert ep.grid is d.executor.last_program.grids[0] and ep.holders == 3


def test_replay_adds_the_recorded_tally_once_per_run(monkeypatch):
    """Kernel-launch counts of a run come from the tally its program
    recorded: a counting POTRF that counts only while ``on`` is set (as a
    graph replay issues no Python launch) still shows its 4 launches in
    every run, once."""
    on = [True]
    real, write_arg = tl.GRID_FUSED["potrf"]

    def counting(idxs, grids):
        if on[0]:
            tl.LAUNCHES["potrf"] += 1
        return real(idxs, grids)

    monkeypatch.setitem(tl.GRID_FUSED, "potrf", (counting, write_arg))
    tl.reset_launches()
    a = _spd(64, 7)
    for run in range(3):
        tlin.run_cholesky(a, graph="g2p", partitions=((4, 4),), device="cpu")
        assert tl.LAUNCHES["potrf"] == 4 * (run + 1)
        assert sum(tl.LAUNCHES.values()) == tl.LAUNCHES["potrf"] and not any(tl.STACKED_LAUNCHES.values())
        on[0] = False


def test_evicted_and_shed_programs_recapture():
    """The captured programs sit in a bounded LRU: a key evicted past the
    capacity, or shed by ``drain_memo_pressure``, is captured again on its
    next drain (counted under ``recaptures``; its list is not rebuilt, so
    ``compiles`` stays the JAX package's 0) and still gives the right
    factor."""
    tjw._PROGRAMS.set_capacity(1)
    a64, a128 = _spd(64, 1), _spd(128, 2)
    for a in (a64, a128):
        tlin.run_cholesky(a, graph="g2p", partitions=((4, 4),), device="cpu")
    assert tjw.program_cache_stats()["evictions"] == 1

    def replay(a):
        d = tcore.Dispatcher(graph="g2p")
        A = tcore.GData(a.shape, partitions=((4, 4),), value=a, device="cpu")
        tlin.utp_cholesky(d, A)
        d.run()
        np.testing.assert_allclose(np.tril(_grid_value(A)), np.linalg.cholesky(a.astype(np.float64)),
                                   rtol=TOL, atol=TOL)
        st = d.executor.stats
        return d.stats["memo_hits"], st.get("compiles", 0), st.get("recaptures", 0)

    assert replay(a64) == (1, 0, 1)  # evicted by a128's program
    tjw._PROGRAMS.set_capacity(64)
    assert replay(a128) == (1, 0, 1)
    assert tjw.program_cache_stats()["entries"] == 2
    before = tjw.program_cache_stats()["pressure_sheds"]
    tjw.drain_memo_pressure()
    assert tjw.program_cache_stats()["pressure_sheds"] == before + 1
    assert tjw.program_cache_stats()["entries"] == 1
    assert replay(a64)[2] + replay(a128)[2] == 1  # the shed one recaptures


def test_launch_fault_sites_fire_once_per_run():
    """``executor.launch`` and ``launch.oom`` fire exactly once per run of a
    captured list, first drain and replays alike."""
    a = _spd(64, 4)
    with tfaults.inject("executor.launch", record=True, times=None) as launch, \
            tfaults.inject("launch.oom", record=True, times=None) as oom:
        for run in range(3):
            tlin.run_cholesky(a, graph="g2p", partitions=((4, 4),), device="cpu")
            assert launch.fired == oom.fired == run + 1
    assert [c["replay"] for c in launch.log] == [c["replay"] for c in oom.log] == [False, True, True]


def test_failing_group_is_named(monkeypatch):
    """An error raised inside a launch list carries a note naming the group
    and its operation; a failed capture on the card reports it in its
    ``CaptureError``."""
    def broken(idxs, grids):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setitem(tl.GRID_FUSED, "potrf", (broken, 0))
    with pytest.raises(RuntimeError, match="capturing") as info:
        tlin.run_cholesky(_spd(64, 4), graph="g2p", partitions=((4, 4),), device="cpu")
    assert info.value.__notes__ == ["group 0 of 12, potrf (fused, 1 tasks)"]
    assert issubclass(tcap.CaptureError, RuntimeError)


# --------------------------------------------------------------------------
# C4: Cholesky on input that is not positive definite
# --------------------------------------------------------------------------
def _not_spd(n=64, at=37):
    a = np.eye(n, dtype=np.float32)
    a[at, at] = -1.0
    return a


@pytest.mark.parametrize("graph", ["g1", "g2", "g2p"])
def test_non_spd_cholesky_has_the_reference_nans(graph):
    """Both packages give the same non-finite entries (a failed tile is all
    NaN, as ``jnp.linalg.cholesky`` returns it) and equal finite ones."""
    a = _not_spd()
    want = np.asarray(jlin.run_cholesky(a, graph=graph, partitions=((4, 4),)))
    got = tlin.run_cholesky(a, graph=graph, partitions=((4, 4),), device="cpu").numpy()
    bad = ~np.isfinite(want)
    assert bad.any() and np.array_equal(~np.isfinite(got), bad)
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("check_finite", [True, False])
def test_served_non_spd_cholesky_fails_or_resolves_as_reference(check_finite):
    """Served on g2 beside an SPD bucket mate: with ``check_finite`` the
    request fails with ``NumericalError`` in both packages and its mate
    resolves; without it, it resolves to non-finite values in both."""
    good = _spd(64, 9)
    outs = {}
    for name, serve, kw in (("jax", jserve, {}), ("torch", tserve, {"device": "cpu"})):
        srv = serve.BatchServer(graph="g2", check_finite=check_finite, max_retries=0, **kw)
        futs = [srv.cholesky(m, partitions=((4, 4),)) for m in (_not_spd(), good)]
        srv.tick()
        err = futs[0].exception()
        if check_finite:
            assert type(err).__name__ == "NumericalError"
        else:
            assert err is None and not np.isfinite(np.asarray(futs[0].result())).all()
        np.testing.assert_allclose(np.asarray(futs[1].result()), np.linalg.cholesky(good.astype(np.float64)),
                                   rtol=TOL, atol=TOL)
        outs[name] = [_outcome(f) for f in futs]
    if check_finite:
        assert outs["torch"][0] == outs["jax"][0] == "NumericalError"
    else:
        bad = ~np.isfinite(outs["jax"][0])
        assert np.array_equal(~np.isfinite(outs["torch"][0]), bad)
        np.testing.assert_allclose(outs["torch"][0][~bad], outs["jax"][0][~bad], rtol=1e-6, atol=1e-6)


def _outcome(f):
    err = f.exception()
    return type(err).__name__ if err is not None else np.asarray(f.result())
