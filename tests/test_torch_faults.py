"""Fault injection in the port (counterpart of tests/test_faults.py,
DESIGN.md §10): the port's own registry (``repro_torch.testing.faults``)
keeps the JAX package's semantics, and every drain-path site of the port
fires where the JAX package's does, with the same recovery invariants — a
failed drain leaves no half-captured memo entry, the executor and
dispatcher stay reusable, corruption is caught by ``check_finite``, and the
value-dependent-split fallback gives the stacked drain's numerics.  Where a
site is observable in both packages, the same drains fire it the same
number of times with the same context."""

import time

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.linalg as jlin
from repro.core.executors import clear_compile_cache as jclear
from repro.errors import ScheduleVerificationError as JSVE
from repro.testing import faults as jfaults
from repro_torch.core import Dispatcher, GData, GTask, dd_matrix
from repro_torch.core.executors import clear_compile_cache, drain_memo_stats
from repro_torch.core.operation import OpRegistry
from repro_torch.errors import NumericalError, ScheduleVerificationError
from repro_torch.linalg import run_lu
from repro_torch.serve import BatchServer
from repro_torch.testing import faults


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    faults.reset()
    jfaults.reset()


def _dd(n, seed):
    return dd_matrix(n, seed=seed, device="cpu")


# -- registry semantics --------------------------------------------------------
def test_registry_is_the_ports_own():
    assert faults is not jfaults and faults.KNOWN_SITES == jfaults.KNOWN_SITES
    assert len(faults.KNOWN_SITES) == 12
    with faults.inject("executor.launch", RuntimeError("port only")):
        assert faults.active() and not jfaults.active()
        jfaults.fire("executor.launch")  # the JAX registry is not armed


def test_unknown_site_rejected():
    with pytest.raises(ValueError, match="unknown fault site"):
        with faults.inject("no.such.site", RuntimeError("x")):
            pass
    with pytest.raises(ValueError, match="probability"):
        faults.Fault("leaf.fn", p=1.5)


def test_arming_scoped_to_context():
    assert not faults.active()
    with faults.inject("executor.launch", RuntimeError("boom")):
        assert faults.active()
        with pytest.raises(RuntimeError, match="boom"):
            faults.fire("executor.launch")
    assert not faults.active()
    faults.fire("executor.launch")  # disarmed: no-op


def test_times_after_and_when():
    with faults.inject(
        "executor.launch",
        RuntimeError("boom"),
        when=lambda ctx: ctx.get("batch", 0) > 1,
        after=1,
        times=1,
    ) as f:
        faults.fire("executor.launch", batch=0)  # when=False: not a match
        faults.fire("executor.launch", batch=4)  # match 1 skipped by after
        with pytest.raises(RuntimeError):
            faults.fire("executor.launch", batch=4)  # fires
        faults.fire("executor.launch", batch=4)  # times budget spent
        assert f.matches == 3 and f.fired == 1


def test_delay_injection_sleeps_at_site():
    with faults.inject("drain.stall", delay_s=0.05) as f:
        t0 = time.perf_counter()
        faults.fire("drain.stall")  # delay-only: sleeps, does NOT raise
        assert time.perf_counter() - t0 >= 0.05
        assert f.fired == 1
    with faults.inject("drain.stall", RuntimeError("late"), delay_s=0.01):
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="late"):
            faults.fire("drain.stall")
        assert time.perf_counter() - t0 >= 0.01
    with pytest.raises(ValueError, match="delay_s"):
        faults.Fault("drain.stall", delay_s=-1.0)


def test_probabilistic_firing_is_seeded_like_the_reference():
    def run(reg, seed):
        hits = []
        with reg.inject("executor.launch", RuntimeError("x"), p=0.5, seed=seed, times=None):
            for _ in range(20):
                try:
                    reg.fire("executor.launch")
                    hits.append(False)
                except RuntimeError:
                    hits.append(True)
        return hits

    a = run(faults, 7)
    assert a == run(faults, 7) == run(jfaults, 7) and 0 < sum(a) < 20


def test_record_probe_observes_without_perturbing():
    with faults.inject("serve.drain", record=True, times=None) as probe:
        faults.fire("serve.drain", rids=[3, 4], op="getrf", size=2)
        faults.fire("serve.drain", rids=[5], op="getrf", size=1)
    assert [e["rids"] for e in probe.log] == [[3, 4], [5]]


def test_reset_disarms_everything():
    cm = faults.inject("executor.launch", RuntimeError("x"))
    cm.__enter__()
    assert faults.active()
    faults.reset()
    assert not faults.active()
    faults.fire("executor.launch")  # no-op after reset


def test_default_corruption_is_nan_tensors():
    g = [torch.ones(2, 2), torch.zeros(3)]
    with faults.inject("executor.output"):
        out = faults.corrupt("executor.output", g)
    assert all(torch.isnan(t).all() for t in out) and torch.equal(g[0], torch.ones(2, 2))


# -- site recovery invariants --------------------------------------------------
def test_launch_failure_then_clean_retry():
    clear_compile_cache()
    a = _dd(32, 0)
    rl, ru = run_lu(a, partitions=((2, 2),), device="cpu")
    with faults.inject("executor.launch", RuntimeError("device lost")):
        with pytest.raises(RuntimeError, match="device lost"):
            run_lu(a, partitions=((2, 2),), device="cpu")
    l, u = run_lu(a, partitions=((2, 2),), device="cpu")
    torch.testing.assert_close(l, rl, rtol=1e-6, atol=0)
    torch.testing.assert_close(u, ru, rtol=1e-6, atol=0)


def test_leaf_kernel_failure_fires_at_build_and_recovers():
    """``leaf.fn`` fires when a launch list is BUILT (once per group), not
    on every run of it: a memo replay never reaches it."""
    clear_compile_cache()
    a = _dd(32, 1)
    with faults.inject("leaf.fn", RuntimeError("bad kernel")):
        with pytest.raises(RuntimeError, match="bad kernel"):
            run_lu(a, partitions=((2, 2),), device="cpu")
    with faults.inject("leaf.fn", record=True, times=None) as probe:
        l, u = run_lu(a, partitions=((2, 2),), device="cpu")  # builds
        built = probe.fired
        run_lu(a, partitions=((2, 2),), device="cpu")  # replays
    # one per group of the 2 x 2 LU: GETRF, TRSML, TRSMU, GEMMNN, GETRF
    assert built == 5 and probe.fired == built
    torch.testing.assert_close(l @ u, a, rtol=2e-4, atol=2e-4)


def test_capture_failure_leaves_memo_unchanged():
    clear_compile_cache()
    a = _dd(32, 2)
    with faults.inject("memo.capture", RuntimeError("capture torn")):
        with pytest.raises(RuntimeError, match="capture torn"):
            run_lu(a, partitions=((2, 2),), device="cpu")
    assert drain_memo_stats()["entries"] == 0  # nothing half-captured
    l, u = run_lu(a, partitions=((2, 2),), device="cpu")
    torch.testing.assert_close(l @ u, a, rtol=2e-4, atol=2e-4)
    assert drain_memo_stats()["entries"] == 1  # clean re-capture
    hits0 = drain_memo_stats()["hits"]
    run_lu(a, partitions=((2, 2),), device="cpu")
    assert drain_memo_stats()["hits"] == hits0 + 1  # and it replays


def test_memo_replay_observed_via_probe_as_in_reference():
    a = _dd(32, 3)
    logs = []
    for reg, clear, lu, kw in ((jfaults, jclear, jlin.run_lu, {}), (faults, clear_compile_cache, run_lu,
                                                                     {"device": "cpu"})):
        clear()
        with reg.inject("executor.launch", record=True, times=None) as probe:
            lu(a.numpy(), partitions=((2, 2),), **kw)
            lu(a.numpy(), partitions=((2, 2),), **kw)
        logs.append(probe.log)
    assert logs[1] == logs[0]
    assert [e["replay"] for e in logs[1]] == [False, True]


def test_output_corruption_caught_by_check_finite():
    clear_compile_cache()
    a = _dd(32, 4)
    with faults.inject("executor.output"):
        with pytest.raises(NumericalError, match="non-finite"):
            run_lu(a, partitions=((2, 2),), check_finite=True, device="cpu")
    # without the check, corruption flows through silently: the NaNs were
    # written into the grids in place
    with faults.inject("executor.output"):
        l, _ = run_lu(a, partitions=((2, 2),), device="cpu")
        assert torch.isnan(l).any()
    l, _ = run_lu(a, partitions=((2, 2),), check_finite=True, device="cpu")  # healthy again
    assert torch.isfinite(l).all()


def test_value_dependent_split_falls_back_with_identical_numerics():
    clear_compile_cache()
    n, N = 32, 4
    mats = [_dd(n, s).numpy() for s in range(N)]
    srv = BatchServer(graph="g2", device="cpu")
    futs = [srv.lu(m, partitions=((2, 2),)) for m in mats]
    assert srv.tick().stacked_drains == 1
    stacked = [f.result() for f in futs]

    clear_compile_cache()
    srv2 = BatchServer(graph="g2", device="cpu")
    futs2 = [srv2.lu(m, partitions=((2, 2),)) for m in mats]
    with faults.inject("split.value_dependent", times=None) as f:
        rep2 = srv2.tick()
    assert f.fired > 0 and rep2.stacked_drains == 0  # abort -> interleaved
    assert rep2.resolved == N
    for (sl, su), f2 in zip(stacked, futs2):
        l2, u2 = f2.result()
        torch.testing.assert_close(l2, sl, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(u2, su, rtol=1e-5, atol=1e-5)


def test_dispatcher_reusable_after_failed_drain():
    clear_compile_cache()
    d = Dispatcher(graph="g2")
    op = OpRegistry.get("getrf")

    def submit(seed):
        a = _dd(32, seed)
        data = GData(a.shape, partitions=((2, 2),), value=a, device="cpu")
        d.submit_task(GTask(op, None, [data.root_view()]))
        return a, data

    submit(0)
    with faults.inject("executor.launch", RuntimeError("flaky")):
        with pytest.raises(RuntimeError, match="flaky"):
            d.run()
    a1, data1 = submit(1)
    d.run()
    packed = data1.value
    L = torch.tril(packed, -1) + torch.eye(32)
    torch.testing.assert_close(L @ torch.triu(packed), a1, rtol=2e-4, atol=2e-4)


# -- plan-mutation sites: the verifier catches what they corrupt ---------------
@pytest.mark.parametrize("site", ["plan.drop_edge", "plan.merge_groups"])
def test_plan_mutation_sites_caught_by_verifier(site):
    a = _dd(32, 5).numpy()
    for reg, clear, lu, err, kw in ((jfaults, jclear, jlin.run_lu, JSVE, {}),
                                    (faults, clear_compile_cache, run_lu, ScheduleVerificationError,
                                     {"device": "cpu"})):
        clear()
        d = (jcore if reg is jfaults else __import__("repro_torch.core").core).Dispatcher(
            graph="g2", verify=True)
        A = (jcore.GData(a.shape, partitions=((4, 4),), value=a) if reg is jfaults
             else GData(a.shape, partitions=((4, 4),), value=a, device="cpu"))
        (jlin if reg is jfaults else __import__("repro_torch.linalg").linalg).utp_getrf(d, A)
        with reg.inject(site, times=None) as f, pytest.raises(err):
            d.run()
        assert f.fired >= 1
