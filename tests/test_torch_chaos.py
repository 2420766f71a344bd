"""Self-healing serving in the port against the JAX package on the CPU
(counterpart of tests/test_chaos.py, DESIGN.md §14), through
test_torch_serve.py's parity harness: the same requests and fault
schedules through both packages' ``BatchServer`` and fault registries, the
JAX test's own assertions on each, equal outcomes, error class names and
counters (breaker trips and closes, fast fails, watchdog fires, OOM events,
retried, bisected), results within the JAX test's tolerance.  The chaos
property runs under the engine the JAX tests use (hypothesis, or the
vendored fallback), its examples derived from the test's name, so every
run draws the same.
"""

import time
from contextlib import ExitStack

import pytest
import torch

import repro_torch.core.executors.captured as tcap
from repro.testing import faults as jfaults
from repro_torch.testing import faults as tfaults
from test_torch_serve import SIDES, _chol, _dd, _lu, _outcome, _report, _server, both

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline container: the JAX tests' vendored engine
    from repro.testing.proptest import given, settings, strategies as st

_N, _P = 32, 2


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    jfaults.reset()
    tfaults.reset()


def _tick_healthy(srv, n=1, seed0=0):
    futs = [_lu(srv, seed=seed0 + k) for k in range(n)]
    rep = srv.tick()
    for f in futs:
        assert f.exception() is None
    return rep


# -- circuit breakers ----------------------------------------------------------
def test_breaker_trips_open_and_fails_fast():
    def scenario(s):
        srv = _server(s, graph="g2", max_retries=0, breaker_threshold=3)
        boom = RuntimeError("persistently poisoned bucket")
        outs = []
        with s.faults.inject("serve.drain", lambda: boom, times=None):
            for seed in range(3):  # three singleton failures = the threshold
                f = _lu(srv, seed)
                rep = srv.tick()
                assert f.done and f.exception() is not None
                outs.append(_outcome(f))
            assert rep.breaker_trips == 1 and rep.breaker_state == "open"
            assert srv.health() == "DEGRADED"
        f = _lu(srv, 99)  # fails fast without draining
        assert isinstance(f.exception(), s.errors.CircuitOpenError)
        assert srv.stats["breaker_fast_fails"] == 1
        return dict(outs=outs + [_outcome(f)], rep=_report(rep))

    both(scenario)


def test_breaker_fails_queued_requests_fast():
    def scenario(s):
        srv = _server(s, graph="g2", max_retries=1, retry_backoff=4, breaker_threshold=2,
                      breaker_cooldown=100)
        futs = [_lu(srv, seed) for seed in range(2)]
        with s.faults.inject("serve.drain", RuntimeError("boom"), times=None):
            rep0 = srv.tick()  # both fail and re-queue with backoff; trips
        assert rep0.retried == 2 and rep0.breaker_trips == 1
        assert not futs[0].done and srv.pending() == 2
        rep = srv.tick()  # the bucket is OPEN: fail fast
        for f in futs:
            assert isinstance(f.exception(), s.errors.CircuitOpenError)
        assert rep.breaker_fast_fails == 2 and rep.drains == 0
        return dict(outs=[_outcome(f) for f in futs], reps=[_report(rep0), _report(rep)])

    both(scenario)


def test_breaker_half_open_probe_recloses():
    def scenario(s):
        srv = _server(s, graph="g2", max_retries=0, breaker_threshold=2, breaker_cooldown=2)
        with s.faults.inject("serve.drain", RuntimeError("boom"), times=None):
            for seed in range(2):
                _lu(srv, seed)
                srv.tick()
        assert srv.breaker_round_trips() == 0
        srv.tick()
        srv.tick()  # the cooldown: the sweep half-opens at tick start
        probe, behind = _lu(srv, 10), _lu(srv, 11)
        rep = srv.tick()  # only the probe drains
        assert probe.exception() is None and rep.breaker_closes == 1
        assert not behind.done
        rep2 = srv.tick()
        assert behind.exception() is None
        assert srv.breaker_round_trips() == 1 and srv.health() == "HEALTHY"
        assert rep2.breaker_state == "closed"
        return dict(outs=[_outcome(probe), _outcome(behind)], reps=[_report(rep), _report(rep2)])

    both(scenario)


def test_half_open_probe_failure_retrips():
    def scenario(s):
        srv = _server(s, graph="g2", max_retries=0, breaker_threshold=2, breaker_cooldown=1)
        with s.faults.inject("serve.drain", RuntimeError("boom"), times=None):
            for seed in range(2):
                _lu(srv, seed)
                srv.tick()
            srv.tick()  # the cooldown elapses: half-open
            probe = _lu(srv, 10)
            rep = srv.tick()  # the probe fails: re-trips OPEN
        assert probe.done and probe.exception() is not None
        assert rep.breaker_trips == 1 and srv.breaker_round_trips() == 0
        f = _lu(srv, 20)
        assert isinstance(f.exception(), s.errors.CircuitOpenError)
        return dict(outs=[_outcome(probe), _outcome(f)], rep=_report(rep))

    both(scenario)


def test_single_poisoned_request_does_not_trip_breaker():
    def scenario(s):
        srv = _server(s, graph="g2", max_retries=0, breaker_threshold=2)
        outs = []
        for round_ in range(3):
            futs = [_lu(srv, round_ * 8 + k) for k in range(4)]
            poison = futs[0].rid
            with s.faults.inject("serve.drain", RuntimeError("poisoned"),
                                 when=lambda ctx: poison in ctx["rids"], times=None):
                srv.tick()
            assert futs[0].exception() is not None
            assert all(f.exception() is None for f in futs[1:])
            outs.append([_outcome(f) for f in futs])
        assert srv.stats["breaker_trips"] == 0 and srv.health() == "HEALTHY"
        return dict(outs=outs, bisected=srv.stats["bisected"])

    both(scenario, tol=2e-4)


# -- hung-drain watchdog -------------------------------------------------------
def test_watchdog_fails_stalled_chunk_typed():
    def scenario(s):
        srv = _server(s, graph="g2", watchdog_s=0.05, max_retries=3)
        futs = [_lu(srv, seed) for seed in range(2)]
        with s.faults.inject("drain.stall", delay_s=0.2):
            t0 = time.perf_counter()
            rep = srv.tick()
            wall = time.perf_counter() - t0
        assert rep.watchdog_fires == 1
        for f in futs:  # not retried despite the retry budget
            assert isinstance(f.exception(), s.errors.DrainStalledError)
        assert wall < 5.0
        rep2 = _tick_healthy(srv, n=2, seed0=10)
        assert rep2.resolved == 2 and rep2.watchdog_fires == 0
        return dict(outs=[_outcome(f) for f in futs], reps=[_report(rep), _report(rep2)])

    both(scenario)


def test_watchdog_unarmed_by_default():
    def scenario(s):
        srv = _server(s, graph="g2")
        with s.faults.inject("drain.stall", delay_s=0.2) as stall:
            rep = _tick_healthy(srv, n=1)
        assert rep.watchdog_fires == 0 and rep.resolved == 1 and stall.fired == 0
        return _report(rep)

    both(scenario)


def test_dispatcher_wait_timeout_raises_typed():
    def scenario(s):
        def drain_async():
            d = s.core.Dispatcher(graph="g2")
            a = _dd(_N, 0)
            data = s.core.GData(a.shape, partitions=((_P, _P),), value=a, **s.kw)
            d.submit_task(s.core.GTask(s.core.OpRegistry.get("getrf"), None, [data.root_view()]))
            return d.run_async()

        with s.faults.inject("drain.stall", delay_s=0.2):
            with pytest.raises(s.errors.DrainStalledError):
                drain_async().wait(timeout=0.05)
        assert drain_async().wait(timeout=30.0) >= 0.0  # clean after the stall
        return True

    both(scenario)


# -- adaptive degradation under memory pressure --------------------------------
def test_oom_splits_chunk_and_degrades_cap():
    def scenario(s):
        srv = _server(s, graph="g2", max_batch=4, degrade_recovery=3)
        futs = [_lu(srv, seed) for seed in range(4)]
        with s.faults.inject("launch.oom",
                             lambda: s.errors.ResourceExhausted("RESOURCE_EXHAUSTED: injected")):
            rep = srv.tick()
        assert rep.oom_events == 1 and all(f.exception() is None for f in futs)
        assert rep.degraded_buckets == 1 and srv.health() == "DEGRADED"
        sig = futs[0].signature
        caps = [srv._bucket_cap(sig)]
        _tick_healthy(srv, n=1, seed0=100)  # completes the recovery
        caps.append(srv._bucket_cap(sig))
        assert caps == [2, 4] and srv.health() == "HEALTHY"
        return dict(outs=[_outcome(f) for f in futs], rep=_report(rep), caps=caps)

    both(scenario, tol=2e-4)


def test_oom_singleton_fails_typed_never_retried():
    def scenario(s):
        srv = _server(s, graph="g2", max_retries=5)
        f = _lu(srv, 0)
        with s.faults.inject("launch.oom",
                             lambda: s.errors.ResourceExhausted("RESOURCE_EXHAUSTED: injected"),
                             times=None):
            rep = srv.tick()
        assert isinstance(f.exception(), s.errors.ResourceExhausted)
        assert rep.retried == 0 and rep.failed == 1
        return dict(out=_outcome(f), rep=_report(rep))

    both(scenario)


def test_oom_textual_match_wraps_generic_error():
    def scenario(s):
        srv = _server(s, graph="g2", max_retries=5)
        f = _lu(srv, 0)
        with s.faults.inject("launch.oom",
                             lambda: RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating"),
                             times=None):
            srv.tick()
        err = f.exception()
        assert isinstance(err, s.errors.ResourceExhausted)
        assert isinstance(err.__cause__, RuntimeError)
        return _outcome(f)

    both(scenario)


def test_cuda_oom_while_stacking_degrades_like_launch_oom(monkeypatch):
    """The port's real OOM: ``torch.cuda.OutOfMemoryError`` raised while a
    stacked grid is allocated (the static grids of the bucket's captured
    program, before any launch) takes the same split-and-degrade path as
    the JAX package's injected ``launch.oom``, with the same counters and
    results."""
    real = tcap.CapturedProgram.__init__
    armed = [True]

    def allocate_or_oom(self, fn, specs, idxs):
        if armed[0] and specs[0][0][0] == 4 and len(specs[0][0]) == 5:  # the (4, nr, nc, br, bc) bucket
            armed[0] = False
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 4.00 MiB")
        real(self, fn, specs, idxs)

    monkeypatch.setattr(tcap.CapturedProgram, "__init__", allocate_or_oom)

    def scenario(s):
        srv = _server(s, graph="g2", max_batch=4, degrade_recovery=3)
        futs = [_lu(srv, seed) for seed in range(4)]
        if s is SIDES["jax"]:
            with s.faults.inject("launch.oom",
                                 lambda: s.errors.ResourceExhausted("RESOURCE_EXHAUSTED")):
                rep = srv.tick()
        else:
            rep = srv.tick()
        assert rep.oom_events == 1 and all(f.exception() is None for f in futs)
        return dict(outs=[_outcome(f) for f in futs], rep=_report(rep),
                    cap=srv._bucket_cap(futs[0].signature))

    both(scenario, tol=2e-4)
    assert not armed[0]


# -- health and graceful shutdown ----------------------------------------------
def test_drain_flushes_queue_and_rejects_new_submits():
    def scenario(s):
        srv = _server(s, graph="g2")
        futs = [_lu(srv, seed) for seed in range(3)]
        assert srv.health() == "HEALTHY"
        reports = srv.drain()
        assert srv.health() == "DRAINING" and srv.pending() == 0
        assert sum(r.resolved for r in reports) == 3
        late = _lu(srv, 9)
        assert isinstance(late.exception(), s.errors.RejectedError)
        return dict(outs=[_outcome(f) for f in futs + [late]], reps=[_report(r) for r in reports])

    both(scenario, tol=2e-4)


def test_drain_flushes_backoff_held_retries():
    def scenario(s):
        srv = _server(s, graph="g2", max_retries=1, retry_backoff=2)
        with s.faults.inject("serve.drain", RuntimeError("transient")):
            f = _lu(srv, 0)
            srv.tick()  # fails once: re-queued with not_before = tick + 2
        assert not f.done
        reports = srv.drain()
        assert f.exception() is None and len(reports) >= 2
        return dict(out=_outcome(f), reps=[_report(r) for r in reports])

    both(scenario)


# -- retry jitter --------------------------------------------------------------
def test_retry_jitter_seeded_deterministic_and_bounded():
    def scenario(s):
        def run(seed):
            srv = _server(s, graph="g2", max_retries=3, retry_backoff=4, retry_jitter_seed=seed)
            f = _lu(srv, 0)
            delays = []
            with s.faults.inject("serve.drain", RuntimeError("boom"), times=3):
                for tick_no in range(200):
                    if f.done:
                        break
                    before = srv.stats["retried"]
                    srv.tick()
                    q = [p for q_ in srv._queues.values() for p in q_]
                    if srv.stats["retried"] > before and q:
                        delays.append(q[0].not_before - tick_no)
            assert f.exception() is None
            return delays

        d1, d2 = run(7), run(7)
        assert d1 == d2 and len(d1) == 3  # seeded: a reproducible schedule
        for attempt, delay in enumerate(d1, start=1):
            assert 1 <= delay <= 4 * 2 ** (attempt - 1)  # full jitter in [1, cap]
        return d1  # the same seed draws the same jitter in both packages

    both(scenario)


def test_no_jitter_default_keeps_exact_backoff():
    def scenario(s):
        srv = _server(s, graph="g2", max_retries=2, retry_backoff=3)
        f = _lu(srv, 0)
        with s.faults.inject("serve.drain", RuntimeError("boom")):
            srv.tick()  # attempt 1 fails: not_before = 0 + 3, exactly
            assert next(iter(srv._queues.values()))[0].not_before == 3
        for _ in range(3):
            srv.tick()  # held, held, drained at tick 3
        assert f.exception() is None
        return _outcome(f)

    both(scenario)


# -- chaos property ------------------------------------------------------------
@st.composite
def fault_schedule(draw):
    """A few ticks of traffic, each with its own fault cocktail: 0-2
    transient drain raises, an optional fence stall, an optional OOM."""
    ticks = []
    for _ in range(draw(st.integers(2, 4))):
        ticks.append({
            "lu": draw(st.integers(0, 3)),
            "chol": draw(st.integers(0, 2)),
            "raises": draw(st.integers(0, 2)),
            "stall": draw(st.booleans()),
            "oom": draw(st.booleans()),
        })
    return ticks


@settings(max_examples=3, deadline=None, derandomize=True)
@given(plan=fault_schedule(), overlap=st.booleans())
def test_chaos_every_future_resolves_or_fails_typed(plan, overlap):
    """Under one randomized multi-site fault schedule both packages resolve
    or typed-fail every future, never wedge a tick, return every breaker to
    CLOSED once the faults clear, and agree on every outcome and counter."""

    def scenario(s):
        srv = _server(s, graph="g2", overlap=overlap, max_batch=4, max_retries=1,
                      watchdog_s=0.3, breaker_threshold=3, breaker_cooldown=2,
                      degrade_recovery=1, retry_jitter_seed=42)
        futs, reps, seed = [], [], 0
        for spec in plan:
            for _ in range(spec["lu"]):
                futs.append(_lu(srv, seed))
                seed += 1
            for _ in range(spec["chol"]):
                futs.append(_chol(srv, seed))
                seed += 1
            with ExitStack() as stack:
                if spec["raises"]:
                    stack.enter_context(s.faults.inject(
                        "serve.drain", lambda: RuntimeError("chaos: transient drain"),
                        times=spec["raises"]))
                if spec["stall"]:
                    stack.enter_context(s.faults.inject("drain.stall", delay_s=0.6))
                if spec["oom"]:
                    stack.enter_context(s.faults.inject(
                        "launch.oom", lambda: s.errors.ResourceExhausted("RESOURCE_EXHAUSTED")))
                t0 = time.perf_counter()
                reps.append(_report(srv.tick()))
                assert time.perf_counter() - t0 < 60.0  # no wedged tick
        for i in range(10):  # the faults are cleared: recovery ticks
            futs.append(_lu(srv, 1000 + i))
            futs.append(_chol(srv, 1000 + i))
            reps.append(_report(srv.tick()))
            if srv.pending() == 0 and srv.health() == "HEALTHY" and all(f.done for f in futs):
                break
        for f in futs:
            assert f.done, f"lost future rid={f.rid}"
            err = f.exception()
            assert err is None or isinstance(err, s.errors.ServeError), err
        assert srv.pending() == 0 and srv.health() == "HEALTHY"
        assert all(snap["state"] == "closed" for snap in srv.breakers().values())
        _tick_healthy(srv, n=2, seed0=5000)
        rep = _tick_healthy(srv, n=2, seed0=6000)
        assert rep.compiles == 0 and rep.failed == 0
        return dict(outs=[_outcome(f) for f in futs], reps=reps)

    both(scenario, tol=2e-4)
