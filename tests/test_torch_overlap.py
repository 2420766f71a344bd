"""Overlapped drains and the pipelined tick in the port against the JAX
package on the CPU (counterpart of tests/test_overlap.py, DESIGN.md §12),
through test_torch_serve.py's parity harness: the same requests through
both packages, the JAX test's own assertions on each, equal counters and
outcomes, results within the JAX test's tolerance.
"""

import numpy as np
import pytest

from repro.testing import faults as jfaults
from repro_torch.testing import faults as tfaults
from test_torch_serve import SIDES, _dd, _np, _outcome, _report, _server, _stats, both


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    jfaults.reset()
    tfaults.reset()


def test_run_async_matches_run():
    def scenario(s):
        a = _dd(64, 3)
        d1 = s.core.Dispatcher(graph="g2")
        A1 = s.core.GData((64, 64), partitions=((4, 4),), value=a, **s.kw)
        s.lin.utp_getrf(d1, A1)
        leaves = d1.run()
        d2 = s.core.Dispatcher(graph="g2")
        A2 = s.core.GData((64, 64), partitions=((4, 4),), value=a, **s.kw)
        s.lin.utp_getrf(d2, A2)
        handle = d2.run_async()
        assert isinstance(handle, s.core.DrainHandle) and handle.leaves == leaves
        assert handle.wait() >= 0.0 and handle.is_ready()
        assert handle.wait() >= 0.0  # an idempotent fence
        np.testing.assert_array_equal(_np(A1.value), _np(A2.value))
        return dict(leaves=leaves, out=_np(A2.value))

    both(scenario)


def test_run_async_on_inline_executor_is_complete():
    def scenario(s):
        d = s.core.Dispatcher(graph="g1")
        A = s.core.GData((32, 32), partitions=((4, 4),), value=_dd(32, 1), **s.kw)
        s.lin.utp_getrf(d, A)
        handle = d.run_async()
        assert handle.is_ready() and handle.wait() == 0.0
        return dict(leaves=handle.leaves, out=_np(A.value))

    both(scenario)


@pytest.mark.parametrize("graph", ["g1", "g2"])
@pytest.mark.parametrize("n_req", [1, 4, 16])
def test_overlap_on_off_bit_identical(graph, n_req):
    def scenario(s):
        mats = [_dd(32, 7 + k) for k in range(n_req)]
        results, reps = {}, {}
        for overlap in (False, True):
            srv = _server(s, graph=graph, check_finite=True, overlap=overlap)
            futs = [srv.lu(m) for m in mats]
            rep = srv.tick()
            assert rep.resolved == n_req and rep.failed == 0
            results[overlap] = [_outcome(f) for f in futs]
            reps[overlap] = _report(rep)
        for off, on in zip(results[False], results[True]):
            for x, y in zip(off, on):
                np.testing.assert_array_equal(x, y)
        return dict(outs=results[True], reps=[reps[False], reps[True]])

    both(scenario)


def test_overlap_multi_bucket_matches_reference():
    def scenario(s):
        on = _server(s, graph="g2", overlap=True)
        off = _server(s, graph="g2", overlap=False)
        futs_on, futs_off, refs = [], [], []
        for i, n in enumerate((32, 48, 64)):
            for k in range(3):
                a = _dd(n, 10 * i + k)
                futs_on.append(on.lu(a))
                futs_off.append(off.lu(a))
                refs.append([_np(x) for x in s.lin.run_lu(a, partitions=((4, 4),), **s.kw)])
        rep = on.tick()
        off.tick()
        assert rep.buckets == 3 and rep.resolved == 9
        outs = [_outcome(f) for f in futs_on]
        for o, f_off, ref in zip(outs, futs_off, refs):
            for x, y, r in zip(o, _outcome(f_off), ref):
                np.testing.assert_array_equal(x, y)
                np.testing.assert_allclose(x, r, atol=1e-5, rtol=1e-5)
        return dict(outs=outs, rep=_report(rep))

    both(scenario)


def test_repeat_drain_over_inflight_epoch_runs_in_place():
    """The port's counterpart of test_donation_safety_two_inflight_epochs:
    two overlapped drains over the SAME data handles.  Where JAX donates
    epoch 1's grid to drain 2, the port runs drain 2 in place on it (same
    storage), so both fences complete and the numerics match a run fenced
    between the drains."""
    n, count = 32, 4
    mats = [_dd(n, 21 + k) for k in range(count)]

    def run(s, fence_between):
        datas = [s.core.GData((n, n), partitions=((4, 4),), value=m, **s.kw) for m in mats]
        handles, grids = [], []
        for _ in range(2):
            d = s.core.Dispatcher(graph="g2")
            for A in datas:
                s.lin.utp_getrf(d, A)
            handles.append(d.run_async())
            ep = datas[0].lane[0]
            assert all(A.lane is not None and A.lane[0] is ep for A in datas)
            grids.append(ep.grid)
            if fence_between:
                handles[-1].wait()
        return datas, handles, grids

    ref, _, _ = run(SIDES["torch"], fence_between=True)
    datas, (h1, h2), (g1, g2) = run(SIDES["torch"], fence_between=False)
    assert g2.data_ptr() == g1.data_ptr()  # drain 2 ran in place on epoch 1's grid
    assert h1.wait() >= 0.0 and h2.wait() >= 0.0
    jref, _, _ = run(SIDES["jax"], fence_between=True)
    for A, R, J in zip(datas, ref, jref):
        np.testing.assert_array_equal(_np(A.value), _np(R.value))
        np.testing.assert_allclose(_np(A.value), _np(J.value), rtol=1e-5, atol=1e-5)


def test_deferred_check_finite_isolates_poisoned_lane():
    def scenario(s):
        srv = _server(s, graph="g2", check_finite=True, overlap=True)
        mats = [_dd(32, 31 + k) for k in range(4)]
        mats[2][5, 5] = np.nan
        futs = [srv.lu(m) for m in mats]
        rep = srv.tick()
        assert rep.resolved == 3 and rep.failed == 1
        assert rep.host_idle_us > 0.0  # the deferred fence was counted
        assert isinstance(futs[2].exception(), s.errors.NumericalError)
        return dict(outs=[_outcome(f) for f in futs], rep=_report(rep))

    both(scenario)


def test_overlap_counters_fence_free_without_check_finite():
    def scenario(s):
        srv = _server(s, graph="g2", overlap=True)
        for k in range(4):
            srv.lu(_dd(32, 41 + k))
        rep = srv.tick()
        assert rep.resolved == 4
        assert rep.host_idle_us == 0.0 and rep.overlap_ratio == 1.0
        assert srv.stats["host_idle_us"] == 0
        return _report(rep)

    both(scenario)


def test_inflight_fault_bisects_and_recovers():
    def scenario(s):
        srv = _server(s, graph="g2", overlap=True, check_finite=True)
        futs = [srv.lu(_dd(32, 51 + k)) for k in range(4)]
        with s.faults.inject("drain.inflight", RuntimeError("device lost mid-flight"),
                             when=lambda ctx: "rids" in ctx, times=1) as fault:
            rep = srv.tick()
        assert fault.fired == 1
        assert rep.bisected >= 1 and rep.resolved == 4 and rep.failed == 0
        return dict(outs=[_outcome(f) for f in futs], rep=_report(rep))

    both(scenario)


def test_inflight_poisoned_request_fails_typed_and_others_resolve():
    def scenario(s):
        srv = _server(s, graph="g2", overlap=True, max_retries=1)
        futs = [srv.lu(_dd(32, 61 + k)) for k in range(4)]
        target = futs[1].rid
        reps = []
        with s.faults.inject("drain.inflight", RuntimeError("device lost mid-flight"),
                             when=lambda ctx: target in ctx.get("rids", ()), times=None):
            for _ in range(8):
                reps.append(_report(srv.tick()))
                if all(f.done for f in futs):
                    break
        assert all(f.done for f in futs)  # no half-resolved futures
        err = futs[1].exception()
        assert isinstance(err, s.errors.InflightError) and isinstance(err, s.errors.DrainError)
        assert "attempt" in str(err)
        assert srv.stats["retried"] >= 1
        return dict(outs=[_outcome(f) for f in futs], reps=reps, stats=_stats(srv))

    both(scenario)


def test_inflight_failure_invalidates_drain_memo():
    def scenario(s):
        a = _dd(32, 71)

        def drain():
            d = s.core.Dispatcher(graph="g2")
            s.lin.utp_getrf(d, s.core.GData((32, 32), partitions=((4, 4),), value=a, **s.kw))
            return d.run_async()

        handle = drain()
        before = s.jw.drain_memo_stats()
        assert before["entries"] == 1  # this drain captured its entry
        with s.faults.inject("drain.inflight", RuntimeError("mid-flight")):
            with pytest.raises(RuntimeError):
                handle.wait()
        after = s.jw.drain_memo_stats()
        assert after["entries"] == 0
        assert after["invalidations"] == before["invalidations"] + 1
        drain().wait()  # the next healthy occurrence re-captures
        # hit/miss totals are process-wide: compare what this scenario changed
        return [before["entries"], after["entries"], s.jw.drain_memo_stats()["entries"],
                after["invalidations"] - before["invalidations"]]

    both(scenario)


def test_verify_green_under_overlap(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY", "1")

    def scenario(s):
        srv = _server(s, graph="g2", overlap=True, check_finite=True)
        futs = [srv.lu(_dd(32, 81 + k)) for k in range(4)]
        rep = srv.tick()
        assert rep.resolved == 4 and rep.failed == 0
        outs = [_outcome(f) for f in futs]
        assert all(np.isfinite(x).all() for o in outs for x in o)
        return dict(outs=outs, rep=_report(rep))

    both(scenario)


def test_latency_window_is_bounded():
    def scenario(s):
        srv = _server(s, graph="g2", latency_window=8)
        futs = [srv.lu(_dd(32, 91 + k)) for k in range(12)]
        rep = srv.tick()
        assert rep.resolved == 12
        assert srv._latencies.maxlen == 8 and len(srv._latencies) == 8
        pct = srv.latency_percentiles()
        assert pct["samples"] == 8 and pct["p50_ms"] >= 0.0
        assert rep.p50_ms >= 0.0 and rep.p99_ms >= rep.p50_ms
        return dict(outs=[_outcome(f) for f in futs], rep=_report(rep), samples=pct["samples"])

    both(scenario)


def test_latency_window_validation():
    for s in SIDES.values():
        with pytest.raises(ValueError):
            _server(s, latency_window=0)
