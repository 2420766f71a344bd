"""BatchServer in the port against the JAX package on the CPU (counterpart
of tests/test_serve.py, DESIGN.md §7/§10), and the parity harness that
test_torch_overlap.py, test_torch_chaos.py and
test_torch_serve_properties.py share.

Every scenario runs twice on the same numpy requests: once through
``repro.serve.BatchServer`` with ``repro.testing.faults``, once through
``repro_torch.serve.BatchServer(device="cpu")`` with the port's own
``repro_torch.testing.faults``.  Each run makes the JAX test's own
assertions, and the two runs' records must agree: results within the JAX
test's tolerance, and exactly equal request ids (relative to the scenario's
first), error class names and serving counters (launches, compiles, memo
hits, stacked drains, resolved, failed, expired, retried, bisected, shed).
The JAX package runs g2p as its own tests do, in Pallas interpret mode.
"""

import types

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.executors.jit_wave as jjw
import repro.errors as jerrors
import repro.linalg as jlin
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.core.executors.jit_wave as tjw
import repro_torch.errors as terrors
import repro_torch.linalg as tlin
import repro_torch.serve as tserve
from repro.core.executors import clear_compile_cache as jclear
from repro.testing import faults as jfaults
from repro_torch.core.executors import clear_compile_cache as tclear
from repro_torch.testing import faults as tfaults

SIDES = {
    "jax": types.SimpleNamespace(
        core=jcore, lin=jlin, jw=jjw, errors=jerrors, serve=jserve, faults=jfaults,
        clear=jclear, kw={}),
    "torch": types.SimpleNamespace(
        core=tcore, lin=tlin, jw=tjw, errors=terrors, serve=tserve, faults=tfaults,
        clear=tclear, kw={"device": "cpu"}),
}
# TickReport counters that must be equal across the two packages (times,
# host_idle_us and the latency percentiles are wall-clock readings)
COUNTERS = ("requests", "buckets", "drains", "launches", "compiles", "stacked_drains",
            "memo_hits", "memo_misses", "resolved", "failed", "expired", "retried",
            "bisected", "pending_after", "breaker_state", "breaker_trips", "breaker_closes",
            "breaker_fast_fails", "watchdog_fires", "oom_events", "degraded_buckets", "health")
STATS = ("requests", "ticks", "drains", "launches", "compiles", "memo_hits", "memo_misses",
         "stacked_drains", "resolved", "failed", "expired", "retried", "shed", "bisected",
         "breaker_trips", "breaker_closes", "breaker_fast_fails", "watchdog_fires", "oom_events")


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    jfaults.reset()
    tfaults.reset()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _dd(n, seed):
    return _np(tcore.dd_matrix(n, seed=seed, device="cpu"))


def _spd(n, seed):
    return _np(tcore.spd_matrix(n, seed=seed, device="cpu"))


def _rhs(n, m=None, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if m is None else (n, m)).astype(np.float32)


def _server(s, **kw):
    return s.serve.BatchServer(**kw, **s.kw)


def _lu(srv, seed=0, n=32, p=2):
    return srv.lu(_dd(n, seed), partitions=((p, p),))


def _chol(srv, seed=0, n=32, p=2):
    return srv.cholesky(_spd(n, seed), partitions=((p, p),))


def _outcome(f):
    """A future's result as numpy leaves, or its error's class name."""
    err = f.exception()
    if err is not None:
        return type(err).__name__
    res = f.result()
    return [_np(x) for x in (res if isinstance(res, tuple) else (res,))]


def _report(rep):
    out = {k: getattr(rep, k) for k in COUNTERS}
    out["per_bucket"] = [{k: v for k, v in b.items() if k != "signature"} for b in rep.per_bucket]
    return out


def _stats(srv):
    return {k: srv.stats[k] for k in STATS}


def _rids(futs):
    return [f.rid - futs[0].rid for f in futs]


def _same(want, got, tol, path="record"):
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _same(want[k], got[k], tol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            _same(w, g, tol, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and want.shape == got.shape, path
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=path)
    else:
        assert want == got, f"{path}: jax {want!r} != torch {got!r}"


def both(scenario, tol=1e-5, **kw):
    """Run ``scenario(side, **kw)`` on the JAX package, then on the port,
    each from a cleared build cache and drain memo; the two records must
    agree.  Returns the port's record."""
    rec = {}
    for name, s in SIDES.items():
        s.clear()
        try:
            rec[name] = scenario(s, **kw)
        finally:
            s.faults.reset()
    _same(rec["jax"], rec["torch"], tol)
    return rec["torch"]


# -- test_serve.py -------------------------------------------------------------
@pytest.mark.parametrize("graph", ["g2", "g2p"])
def test_lu_solve_requests_resolve_and_match(graph):
    def scenario(s):
        n, N = 64, 5
        srv = _server(s, graph=graph)
        futs, refs = [], []
        for seed in range(N):
            a, b = _dd(n, seed), _rhs(n, seed=seed)
            futs.append(srv.lu_solve(a, b))
            refs.append(_np(s.lin.run_lu_solve(a, b, graph=graph, partitions=((4, 4),), **s.kw)))
        assert srv.pending() == N and not futs[0].done
        rep = srv.tick()
        assert rep.requests == N and rep.buckets == 1
        assert rep.stacked_drains == 1 and rep.launches == 1
        assert srv.pending() == 0
        outs = [_outcome(f) for f in futs]
        for (x,), r in zip(outs, refs):
            assert x.shape == (n,)  # a vector rhs round-trips as a vector
            np.testing.assert_allclose(x, r, rtol=1e-5, atol=1e-5)
        return dict(outs=outs, rep=_report(rep), stats=_stats(srv))

    both(scenario)


@pytest.mark.parametrize("graph", ["g2", "g2p"])
def test_mixed_signatures_bucket_separately(graph):
    def scenario(s):
        srv = _server(s, graph=graph)
        lu = [srv.lu(_dd(64, seed)) for seed in range(3)]
        chol = [srv.cholesky(_spd(32, seed), partitions=((4, 4),)) for seed in range(2)]
        rep = srv.tick()
        assert rep.buckets == 2 and rep.drains == 2
        assert rep.stacked_drains == 2  # each homogeneous bucket stacked
        for seed, (l, u) in enumerate(_outcome(f) for f in lu):
            np.testing.assert_allclose(l @ u, _dd(64, seed), rtol=2e-4, atol=2e-4)
        for seed, (L,) in enumerate(_outcome(f) for f in chol):
            np.testing.assert_allclose(L @ L.T, _spd(32, seed), rtol=2e-4, atol=2e-4)
        return dict(outs=[_outcome(f) for f in lu + chol], rep=_report(rep))

    both(scenario, tol=2e-4)


@pytest.mark.parametrize("graph", ["g2", "g2p"])
def test_repeat_tick_replays_zero_compiles_one_launch(graph):
    def scenario(s):
        srv = _server(s, graph=graph)
        reps, outs = [], []

        def one_tick(seed0):
            futs = [srv.lu_solve(_dd(64, seed0 + k), _rhs(64, seed=k)) for k in range(4)]
            rep = srv.tick()
            outs.append([_outcome(f) for f in futs])
            reps.append(_report(rep))
            return rep

        one_tick(0)  # capture tick: builds once
        for seed0 in (10, 20):
            rep = one_tick(seed0)
            assert rep.compiles == 0 and rep.launches == 1 and rep.stacked_drains == 1
            assert rep.memo_hits == 1 and rep.memo_misses == 0
            for b in rep.per_bucket:
                assert b["compiles"] == 0 and b["launches"] == 1
        return dict(outs=outs, reps=reps, stats=_stats(srv))

    both(scenario)


def test_max_batch_chunks_one_signature():
    def scenario(s):
        srv = _server(s, graph="g2", max_batch=2)
        futs = [srv.lu(_dd(64, seed)) for seed in range(5)]
        rep = srv.tick()
        assert rep.buckets == 1 and rep.drains == 3  # 2 + 2 + 1
        outs = [_outcome(f) for f in futs]
        for seed, (l, u) in enumerate(outs):
            np.testing.assert_allclose(l @ u, _dd(64, seed), rtol=2e-4, atol=2e-4)
        return dict(outs=outs, rep=_report(rep))

    both(scenario, tol=2e-4)


def test_single_request_tick_still_serves():
    def scenario(s):
        srv = _server(s, graph="g2")
        f = srv.lu(_dd(64, 91))
        rep = srv.tick()
        assert rep.requests == 1  # nothing to stack, but it resolves
        l, u = _outcome(f)
        rl, ru = s.lin.run_lu(_dd(64, 91), partitions=((4, 4),), **s.kw)
        np.testing.assert_allclose(l, _np(rl), rtol=1e-6)
        np.testing.assert_allclose(u, _np(ru), rtol=1e-6)
        return dict(outs=[l, u], rep=_report(rep))

    both(scenario, tol=1e-6)


def test_matrix_rhs_lu_solve():
    def scenario(s):
        srv = _server(s, graph="g2")
        a, b = _dd(64, 7), _rhs(64, m=8, seed=7)
        f = srv.lu_solve(a, b, b_partitions=((4, 1),))
        srv.tick()
        (x,) = _outcome(f)
        ref = s.lin.run_lu_solve(a, b, partitions=((4, 4),), b_partitions=((4, 1),), **s.kw)
        np.testing.assert_allclose(x, _np(ref), rtol=1e-5, atol=1e-5)
        return x

    both(scenario)


def test_result_before_tick_raises():
    def scenario(s):
        srv = _server(s, graph="g2")
        f = srv.lu(_dd(32, 1), partitions=((2, 2),))
        with pytest.raises(RuntimeError, match="not drained"):
            f.result()
        srv.tick()
        return _outcome(f)

    both(scenario)


def test_submit_validation():
    def scenario(s):
        srv = _server(s, graph="g2")
        with pytest.raises(ValueError, match="arrays vs"):
            srv.submit("getrf", [np.eye(8, dtype=np.float32)], [])
        with pytest.raises(ValueError, match="shape mismatch"):
            srv.lu_solve(np.eye(8, dtype=np.float32), np.ones((4,), np.float32))
        for bad in (0, 48):  # a pow2, so chunks match the launch-list buckets
            with pytest.raises(ValueError, match="max_batch"):
                _server(s, max_batch=bad)
        return _stats(srv)

    both(scenario)


def test_tick_failure_is_contained_and_typed():
    def scenario(s):
        srv = _server(s, graph="g2", max_batch=2, max_retries=0)
        futs = [srv.lu(_dd(32, seed), partitions=((2, 2),)) for seed in range(3)]
        poisoned = futs[0].rid
        boom = RuntimeError("executor down")
        with s.faults.inject("serve.drain", boom, when=lambda ctx: poisoned in ctx["rids"], times=None):
            rep = srv.tick()  # must not raise
        assert rep.resolved == 2 and rep.failed == 1 and rep.bisected == 1
        assert srv.pending() == 0
        err = futs[0].exception()
        assert isinstance(err, s.errors.DrainError) and err.__cause__ is boom
        with pytest.raises(s.errors.DrainError, match=f"rid={poisoned}"):
            futs[0].result()
        outs = [_outcome(f) for f in futs]
        for seed in (1, 2):
            l, u = outs[seed]
            np.testing.assert_allclose(l @ u, _dd(32, seed), rtol=2e-4, atol=2e-4)
        return dict(outs=outs, rep=_report(rep), stats=_stats(srv))

    both(scenario, tol=2e-4)


def test_bisect_isolates_poisoned_request_in_large_bucket():
    def scenario(s):
        n, N = 32, 16
        srv = _server(s, graph="g2", max_retries=0)

        def submit(seed0):
            return [srv.lu(_dd(n, seed0 + k), partitions=((2, 2),)) for k in range(N)]

        submit(0)
        srv.tick()  # healthy capture tick
        futs = submit(100)
        poisoned = futs[3].rid
        with s.faults.inject("serve.drain", RuntimeError("lane poisoned"),
                             when=lambda ctx: poisoned in ctx["rids"], times=None):
            rep = srv.tick()
        assert rep.resolved == N - 1 and rep.failed == 1 and rep.bisected >= 1
        assert srv.pending() == 0
        outs = [_outcome(f) for f in futs]
        assert outs[3] == "DrainError"
        for k, o in enumerate(outs):
            if k != 3:
                np.testing.assert_allclose(o[0] @ o[1], _dd(n, 100 + k), rtol=2e-4, atol=2e-4)
        submit(200)
        rep2 = srv.tick()  # the serving loop is intact: a memo replay
        assert rep2.compiles == 0 and rep2.launches == 1 and rep2.stacked_drains == 1
        return dict(outs=outs, rep=_report(rep), rep2=_report(rep2), stats=_stats(srv))

    both(scenario, tol=2e-4)


@pytest.mark.parametrize("graph", ["g2", "g2p"])
def test_check_finite_fails_only_poisoned_lane(graph):
    def scenario(s):
        srv = _server(s, graph=graph, check_finite=True)
        mats = [_dd(32, seed) for seed in range(4)]
        mats[2][0, 0] = np.nan
        futs = [srv.lu(m, partitions=((2, 2),)) for m in mats]
        rep = srv.tick()
        assert rep.resolved == 3 and rep.failed == 1 and rep.retried == 0
        assert isinstance(futs[2].exception(), s.errors.NumericalError)
        outs = [_outcome(f) for f in futs]
        for k in (0, 1, 3):
            np.testing.assert_allclose(outs[k][0] @ outs[k][1], mats[k], rtol=2e-4, atol=2e-4)
        return dict(outs=outs, rep=_report(rep))

    both(scenario, tol=2e-4)


def test_deadline_expires_without_draining():
    def scenario(s):
        t = [0.0]
        srv = _server(s, graph="g2", clock=lambda: t[0])
        doomed = srv.lu(_dd(32, 0), partitions=((2, 2),), deadline=5.0)
        healthy = srv.lu(_dd(32, 1), partitions=((2, 2),))
        t[0] = 10.0  # past the deadline before any tick
        rep = srv.tick()
        assert rep.expired == 1 and rep.resolved == 1
        assert isinstance(doomed.exception(), s.errors.DeadlineExceeded)
        l, u = _outcome(healthy)
        np.testing.assert_allclose(l @ u, _dd(32, 1), rtol=2e-4, atol=2e-4)
        return dict(outs=[_outcome(doomed), [l, u]], rep=_report(rep))

    both(scenario, tol=2e-4)


@pytest.mark.parametrize("policy", ["reject", "drop_oldest"])
def test_admission_policies(policy):
    def scenario(s):
        srv = _server(s, graph="g2", max_pending=2, overload_policy=policy)
        futs = [srv.lu(_dd(32, seed), partitions=((2, 2),)) for seed in range(3)]
        shed = futs[2] if policy == "reject" else futs[0]
        # reject sheds the NEW request; drop_oldest admits it and evicts
        # the oldest queued one
        assert shed.done and isinstance(shed.exception(), s.errors.RejectedError)
        assert srv.pending() == 2 and srv.stats["shed"] == 1
        rep = srv.tick()
        outs = [_outcome(f) for f in futs]
        for seed, o in enumerate(outs):
            if futs[seed] is not shed:
                np.testing.assert_allclose(o[0] @ o[1], _dd(32, seed), rtol=2e-4, atol=2e-4)
        return dict(outs=outs, rep=_report(rep), stats=_stats(srv))

    both(scenario, tol=2e-4)


def test_retry_budget_with_backoff_then_recovery():
    def scenario(s):
        srv = _server(s, graph="g2", max_retries=2, retry_backoff=1)
        f = srv.lu(_dd(32, 5), partitions=((2, 2),))
        reps = []
        with s.faults.inject("serve.drain", RuntimeError("transient"), times=2):
            reps.append(srv.tick())  # attempt 1 fails: eligible next tick
            assert reps[-1].retried == 1 and not f.done and srv.pending() == 1
            reps.append(srv.tick())  # attempt 2 fails: backoff holds a tick
            assert reps[-1].retried == 1 and not f.done
            reps.append(srv.tick())  # held back: nothing eligible
            assert reps[-1].buckets == 0 and srv.pending() == 1
        reps.append(srv.tick())  # the fault is spent: the drain succeeds
        assert reps[-1].resolved == 1
        l, u = _outcome(f)
        np.testing.assert_allclose(l @ u, _dd(32, 5), rtol=2e-4, atol=2e-4)
        return dict(out=[l, u], reps=[_report(r) for r in reps], stats=_stats(srv))

    both(scenario, tol=2e-4)


def test_retry_budget_exhaustion_fails_typed():
    def scenario(s):
        srv = _server(s, graph="g2", max_retries=1, retry_backoff=1)
        f = srv.lu(_dd(32, 6), partitions=((2, 2),))
        with s.faults.inject("serve.drain", RuntimeError("hard down"), times=None):
            assert srv.tick().retried == 1
            assert srv.tick().failed == 1
        err = f.exception()
        assert isinstance(err, s.errors.DrainError) and "2 attempt(s)" in str(err)
        return dict(out=_outcome(f), stats=_stats(srv))

    both(scenario)


def test_requeue_preserves_fifo_and_carries_retry_count():
    def scenario(s):
        srv = _server(s, graph="g2", max_retries=2, retry_backoff=1)
        r0 = srv.lu(_dd(32, 0), partitions=((2, 2),))
        r1 = srv.lu(_dd(32, 1), partitions=((2, 2),))
        with s.faults.inject("serve.drain", RuntimeError("transient"),
                             when=lambda ctx: r1.rid in ctx["rids"], times=2):
            srv.tick()  # the [r0, r1] chunk, then the bisected [r1] singleton
        assert r0.exception() is None and not r1.done
        (pend,) = [p for q in srv._queues.values() for p in q]
        assert pend.future.rid == r1.rid
        assert pend.attempts == 1 and pend.retries_left == 1  # count carried
        r2 = srv.lu(_dd(32, 2), partitions=((2, 2),))
        with s.faults.inject("serve.drain", record=True, times=None) as probe:
            rep = srv.tick()
        assert rep.resolved == 2
        # ONE drain served both, the re-queued request at the front
        assert probe.log[0]["rids"] == [r1.rid, r2.rid]
        futs = [r0, r1, r2]
        outs = [_outcome(f) for f in futs]
        for seed, (l, u) in enumerate(outs):
            np.testing.assert_allclose(l @ u, _dd(32, seed), rtol=2e-4, atol=2e-4)
        return dict(outs=outs, rids=[r - r0.rid for r in probe.log[0]["rids"]],
                    rep=_report(rep), stats=_stats(srv))

    both(scenario, tol=2e-4)


def test_future_ergonomics():
    def scenario(s):
        srv = _server(s, graph="g2")
        f = srv.lu(_dd(32, 1), partitions=((2, 2),))
        with pytest.raises(RuntimeError, match=f"rid={f.rid}.*getrf"):
            f.result()
        with pytest.raises(RuntimeError, match="not drained"):
            f.exception()
        srv.tick()
        assert f.exception() is None
        g = srv.lu(_dd(32, 2), partitions=((2, 2),))
        rejecting = _server(s, graph="g2", max_pending=1, overload_policy="reject")
        rejecting.lu(_dd(32, 3), partitions=((2, 2),))
        h = rejecting.lu(_dd(32, 4), partitions=((2, 2),))
        assert isinstance(h.exception(), s.errors.RejectedError)
        with pytest.raises(s.errors.RejectedError):
            h.result()
        assert not g.done  # no server state leaks across futures
        return dict(outs=[_outcome(f), _outcome(h)], rids=_rids([f, g, h]))

    both(scenario)


def test_tick_reports_latency_percentiles():
    def scenario(s):
        t = [0.0]
        srv = _server(s, graph="g2", clock=lambda: t[0])
        for seed in range(3):
            srv.lu(_dd(32, seed), partitions=((2, 2),))
        t[0] = 0.25  # every request queued 250 ms before its drain completes
        rep = srv.tick()
        assert rep.resolved == 3
        assert rep.p50_ms >= 250.0 and rep.p99_ms >= rep.p50_ms
        pct = srv.latency_percentiles()
        assert pct["samples"] == 3 and pct["p50_ms"] >= 250.0
        # the clock is injected, so the percentiles are exact on both sides
        return dict(rep=_report(rep), p50=rep.p50_ms, p99=rep.p99_ms, pct=pct)

    both(scenario)
