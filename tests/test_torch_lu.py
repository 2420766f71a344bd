"""The port's LU family against the JAX package's on the CPU: the same numpy
inputs through ``repro.linalg`` and ``repro_torch.linalg`` (run_lu,
run_solve, run_lu_solve, run_inv, run_lu_many) on g1/g2/g2p agree within
tests/test_lu.py's tolerances (LU and triangular solves atol 1e-5, the
composed solve and the inverse atol 1e-4), and the structural counters
(tasks, groups before and after fusion, slots, programs built and launched
per drain) equal the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.linalg as jlin
import repro_torch.core as tcore
from repro.core.executors import clear_compile_cache as jclear
from repro.errors import NumericalError as JNumericalError
from repro.errors import ScheduleVerificationError as JSVE
from repro.errors import ServeError as JServeError
from repro_torch.core.executors import clear_compile_cache
from repro_torch.errors import NumericalError, ScheduleVerificationError, ServeError
from repro_torch.linalg import (
    run_inv,
    run_lu,
    run_lu_many,
    run_lu_solve,
    run_solve,
    utp_getrf,
    utp_lu_solve,
)

GRAPHS = ["g1", "g2", "g2p"]


def _dd(n, seed):
    a = tcore.dd_matrix(n, seed=seed, device="cpu")
    assert np.array_equal(a.numpy(), np.asarray(jcore.dd_matrix(n, seed=seed)))  # bit-identical
    return a.numpy()


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


# --------------------------------------------------------------------------
# numerics against the JAX package, every graph
# --------------------------------------------------------------------------
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("n,parts", [(32, ((2, 2),)), (64, ((4, 4),))])
def test_lu_matches_reference(graph, n, parts):
    a = _dd(n, seed=n)
    L, U = run_lu(a, graph=graph, partitions=parts, device="cpu")
    jL, jU = jlin.run_lu(jnp.asarray(a), graph=graph, partitions=parts)
    _close(L, jL, 1e-5)
    _close(U, jU, 1e-5)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L)) and torch.equal(torch.diag(L), torch.ones(n))
    _close(L @ U, a, 1e-5)


def test_lu_same_program_all_graphs_identical():
    a = _dd(32, seed=11)
    outs = {g: run_lu(a, graph=g, partitions=((2, 2),), device="cpu") for g in GRAPHS}
    for L, U in outs.values():
        torch.testing.assert_close(L, outs["g1"][0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(U, outs["g1"][1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize(
    "lower,side,bshape,bparts",
    [
        (True, None, (64, 64), ((4, 4),)),
        (True, None, (64, 32), ((4, 2),)),
        (False, None, (64, 64), ((4, 4),)),
        (False, None, (32, 64), ((2, 4),)),
        (False, "left", (64, 32), ((4, 2),)),
    ],
)
def test_solve_matches_reference(graph, lower, side, bshape, bparts):
    """TRSML (lower), TRSMU (upper, right) and TRSMUL (upper, left), with
    non-square block counts on b (tests/test_lu.py:87-139)."""
    a = _dd(64, seed=3 if lower else 4)
    b = _rand(0 if lower else 1, bshape)
    kw = dict(lower=lower, side=side, graph=graph, partitions=((4, 4),), b_partitions=bparts)
    x = run_solve(a, b, device="cpu", **kw)
    _close(x, jlin.run_solve(jnp.asarray(a), jnp.asarray(b), **kw), 1e-5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if lower:
        _close((torch.tril(ta, -1) + torch.eye(64)) @ x, b, 1e-4)
    elif side == "left":
        _close(torch.triu(ta) @ x, b, 1e-4)
    else:
        _close(x @ torch.triu(ta), tb, 1e-4)


def test_solve_side_validation():
    a, b = _dd(32, seed=1), np.zeros((32, 32), np.float32)
    with pytest.raises(ValueError, match="left"):
        run_solve(a, b, lower=True, side="right", partitions=((2, 2),), device="cpu")
    with pytest.raises(ValueError, match="side"):
        run_solve(a, b, lower=False, side="up", partitions=((2, 2),), device="cpu")


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("bshape,bparts", [((64, 64), ((4, 4),)), ((64, 32), ((4, 2),)), ((64,), None)])
def test_lu_solve_matches_reference(graph, bshape, bparts):
    a = _dd(64, seed=13)
    b = _rand(5, bshape)
    x = run_lu_solve(a, b, graph=graph, partitions=((4, 4),), b_partitions=bparts, device="cpu")
    assert tuple(x.shape) == bshape
    want = jlin.run_lu_solve(jnp.asarray(a), jnp.asarray(b), graph=graph, partitions=((4, 4),),
                             b_partitions=bparts)
    _close(x, want, 1e-4)
    _close(torch.from_numpy(a) @ x, b, 1e-4)


def test_lu_solve_shape_mismatch():
    with pytest.raises(ValueError, match="mismatch"):
        run_lu_solve(_dd(32, seed=1), np.zeros((16, 4), np.float32), partitions=((2, 2),), device="cpu")


@pytest.mark.parametrize("graph", GRAPHS)
def test_run_inv_matches_reference(graph):
    a = _dd(64, seed=15)
    inv = run_inv(a, graph=graph, partitions=((4, 4),), device="cpu")
    _close(inv @ torch.from_numpy(a), np.eye(64), 1e-4)
    _close(inv, jlin.run_inv(jnp.asarray(a), graph=graph, partitions=((4, 4),)), 1e-4)


def test_lu_then_solve_round_trip():
    """Forward and backward substitution through the packed factor."""
    a, b = _dd(64, seed=8), _rand(3, (64, 64))
    L, U = run_lu(a, partitions=((4, 4),), device="cpu")
    packed = torch.tril(L, -1) + U
    y = run_solve(packed, b, lower=True, partitions=((4, 4),), device="cpu")
    x = run_solve(packed, y, lower=False, side="left", partitions=((4, 4),), device="cpu")
    _close(torch.from_numpy(a) @ x, b, 1e-4)


@pytest.mark.parametrize("graph", ["g2", "g2p"])
def test_run_lu_many_matches_reference(graph):
    mats = [_dd(64, seed=s) for s in (31, 32)]
    outs = run_lu_many(mats, graph=graph, partitions=((4, 4),), device="cpu")
    want = jlin.run_lu_many([jnp.asarray(m) for m in mats], graph=graph, partitions=((4, 4),))
    for (L, U), (jL, jU), m in zip(outs, want, mats):
        _close(L, jL, 1e-5)
        _close(U, jU, 1e-5)
        _close(L @ U, m, 2e-4)


def test_run_lu_leaves_its_input_alone():
    a = torch.from_numpy(_dd(32, seed=12))
    a0 = a.clone()
    L, U = run_lu(a, graph="g2p", partitions=((1, 1),), device="cpu")
    assert torch.equal(a, a0)
    _close(L @ U, a0, 2e-4)


# --------------------------------------------------------------------------
# check_finite and the error taxonomy
# --------------------------------------------------------------------------
def test_check_finite_raises_numerical_error_on_zero_pivot():
    a = _dd(32, seed=2)
    a[0, 0] = 0.0  # pivot-free LU divides by it
    L, U = run_lu(a, partitions=((2, 2),), device="cpu")  # opt-in: no check
    assert not torch.isfinite(L).all()
    with pytest.raises(NumericalError, match="non-finite"):
        run_lu(a, partitions=((2, 2),), check_finite=True, device="cpu")
    with pytest.raises(NumericalError, match="run_lu_solve"):
        run_lu_solve(a, _rand(1, (32,)), partitions=((2, 2),), check_finite=True, device="cpu")
    with pytest.raises(NumericalError):
        run_solve(a * 0, _rand(1, (32, 32)), lower=False, partitions=((2, 2),),
                  check_finite=True, device="cpu")
    L, _ = run_lu(_dd(32, seed=2), partitions=((2, 2),), check_finite=True, device="cpu")
    assert torch.isfinite(L).all()  # a healthy input passes the check


def test_serve_error_catches_both_as_in_the_reference():
    for err, ref in ((NumericalError, JNumericalError), (ScheduleVerificationError, JSVE)):
        assert issubclass(err, ServeError) and issubclass(ref, JServeError)
        assert [c.__name__ for c in err.__mro__] == [c.__name__ for c in ref.__mro__]
    for exc in (NumericalError("x"), ScheduleVerificationError("V3", "overlap", ("t1", "t2"))):
        try:
            raise exc
        except ServeError as caught:
            assert caught is exc
    assert str(ScheduleVerificationError("V3", "overlap", ("t1",))) == str(JSVE("V3", "overlap", ("t1",)))


# --------------------------------------------------------------------------
# structural counters against the reference
# --------------------------------------------------------------------------
def _drain_lu(graph, n=64, p=4, seed=1, rhs=None):
    d = tcore.Dispatcher(graph=graph)
    A = tcore.GData((n, n), partitions=((p, p),), value=_dd(n, seed), device="cpu")
    if rhs is None:
        utp_getrf(d, A)
    else:
        B = tcore.GData(rhs.shape, partitions=((p, p),), value=rhs, device="cpu")
        utp_lu_solve(d, A, B)
    k = d.run()
    st = d.executor.stats
    return k, st.get("launches", 0), st.get("compiles", 0), st, d


@pytest.mark.parametrize("graph", ["g2", "g2p"])
def test_repeated_lu_drains_compile_once(graph):
    clear_compile_cache()
    stats = [_drain_lu(graph, seed=s)[:3] for s in (1, 2, 3)]
    # 4x4 right-looking LU: sum_k 1 + 2*(3-k) + (3-k)^2 = 30 leaf tasks
    assert stats[0] == (30, 1, 1)
    assert stats[1:] == [(30, 1, 0)] * 2


@pytest.mark.parametrize("graph", ["g2", "g2p"])
def test_lu_solve_single_drain_compile_once(graph):
    clear_compile_cache()
    stats = [_drain_lu(graph, seed=s, rhs=_rand(s, (64, 64)))[:3] for s in (1, 2, 3)]
    # factor 30 + forward 40 + backward 40 block-substitution tasks at p = 4
    assert stats[0] == (110, 1, 1)
    assert stats[1:] == [(110, 1, 0)] * 2


@pytest.mark.parametrize("graph", ["g2", "g2p"])
@pytest.mark.parametrize("rhs", [None, (64, 64)])
def test_counters_match_reference(graph, rhs):
    """Tasks, groups, prefusion groups, slots, builds and launches per
    drain, and memo hits, equal the JAX package's for the same program."""
    b = None if rhs is None else _rand(7, rhs)
    clear_compile_cache()
    jclear()
    keys = ("compiles", "launches", "groups", "groups_prefusion", "slots", "tasks")
    for _ in range(2):
        k, _, _, st, d = _drain_lu(graph, rhs=b)
        jd = jcore.Dispatcher(graph=graph)
        jA = jcore.GData((64, 64), partitions=((4, 4),), value=jnp.asarray(_dd(64, 1)))
        if b is None:
            jlin.utp_getrf(jd, jA)
        else:
            jlin.utp_lu_solve(jd, jA, jcore.GData(b.shape, partitions=((4, 4),), value=jnp.asarray(b)))
        jk = jd.run()
        want = {key: jd.executor.stats[key] for key in keys if key in jd.executor.stats}
        assert (k, {key: st[key] for key in want}, d.stats["memo_hits"]) == (jk, want, jd.stats["memo_hits"])


def test_lu_solve_fuses_solve_groups_into_factor_groups():
    clear_compile_cache()
    st = _drain_lu("g2", rhs=_rand(7, (64, 64)))[3]
    assert (st["groups"], st["groups_prefusion"]) == (24, 30)


def test_single_root_lu_is_at_its_chain_lower_bound():
    for p in (4, 8):
        clear_compile_cache()
        st = _drain_lu("g2", n=8 * p, p=p, seed=41)[3]
        assert st["groups"] == st["groups_prefusion"] == 3 * (p - 1) + p


def test_multiroot_lu_pair_fuses_groups_across_roots():
    clear_compile_cache()
    # stack_roots=False pins segment fusion, as the JAX package's
    # tests/test_schedule_fusion.py does: a homogeneous pair would stack
    d = tcore.Dispatcher(graph="g2p", stack_roots=False)
    roots = []
    for s in (21, 22):
        A = tcore.GData((64, 64), partitions=((4, 4),), value=_dd(64, s), device="cpu")
        utp_getrf(d, A)
        roots.append(A)
    d.run()
    st = d.executor.stats
    assert st["launches"] == 1
    assert st["groups"] < st["groups_prefusion"] == 2 * st["groups"]
    for A, s in zip(roots, (21, 22)):
        packed = A.value
        L = torch.tril(packed, -1) + torch.eye(64)
        _close(L @ torch.triu(packed), _dd(64, s), 2e-4)


def test_verify_mode_proves_the_lu_solve_plan():
    """V3/V4 (distinct write blocks per slot) are what make the in-place
    fused kernels race-free; the LU plans must pass them."""
    clear_compile_cache()
    a, b = _dd(64, seed=9), _rand(9, (64, 32))
    x = run_lu_solve(a, b, graph="g2p", partitions=((4, 4),), b_partitions=((4, 2),),
                     device="cpu", verify=True)
    _close(torch.from_numpy(a) @ x, b, 1e-4)


def test_lu_ops_registered_and_memoizable():
    for name in ("getrf", "trsml", "trsmu", "trsmul", "gemmnn", "lu_solve"):
        assert tcore.OpRegistry.get(name).memoizable
        assert [m.value for m in tcore.OpRegistry.get(name).default_modes(3)] == [
            m.value for m in jcore.OpRegistry.get(name).default_modes(3)
        ]


def test_lu_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = _dd(8, seed=1)
    for call in (lambda: run_lu(a), lambda: run_lu_solve(a, a), lambda: run_inv(a),
                 lambda: run_solve(a, a), lambda: run_lu_many([a])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
