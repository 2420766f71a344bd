"""Stacked drains and mixed-signature traffic against independent drains,
in both packages, which must agree (counterpart of
tests/test_serve_properties.py, DESIGN.md §7), through
test_torch_serve.py's parity harness.  The properties run under the engine
the JAX tests use (hypothesis, or the vendored fallback), their examples
derived from each test's name, so every run draws the same.
"""

import numpy as np
import pytest

from repro.testing import faults as jfaults
from repro_torch.testing import faults as tfaults
from test_torch_serve import _chol, _dd, _lu, _np, _report, _server, _spd, both

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


@settings(max_examples=6, deadline=None, derandomize=True)
@given(n_roots=st.integers(1, 6), geom=st.sampled_from([(32, 2), (32, 4), (64, 4)]),
       graph=st.sampled_from(["g1", "g2"]), seed=st.integers(0, 1000))
def test_stacked_lu_matches_independent_drains(n_roots, geom, graph, seed):
    """Every lane of one stacked drain matches the same request drained on
    its own (1e-6, the JAX property's tolerance), in both packages, and the
    two packages agree on the stacked results."""
    n, p = geom
    mats = [_dd(n, seed + k) for k in range(n_roots)]

    def scenario(s):
        stacked = s.lin.run_lu_batched(mats, graph=graph, partitions=((p, p),), **s.kw)
        s.clear()
        singles = [s.lin.run_lu(m, graph=graph, partitions=((p, p),), **s.kw) for m in mats]
        out = []
        for (ls, us), (li, ui) in zip(stacked, singles):
            np.testing.assert_allclose(_np(ls), _np(li), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(_np(us), _np(ui), rtol=1e-6, atol=1e-6)
            out.append([_np(ls), _np(us)])
        return out

    both(scenario, tol=2e-4)


@settings(max_examples=4, deadline=None, derandomize=True)
@given(n_roots=st.integers(1, 5), m_cols=st.sampled_from([1, 4]),
       graph=st.sampled_from(["g1", "g2"]), seed=st.integers(0, 1000))
def test_stacked_lu_solve_matches_independent_drains(n_roots, m_cols, graph, seed):
    n, p = 32, 4
    rng = np.random.default_rng(seed)
    mats = [_dd(n, seed + k) for k in range(n_roots)]
    rhss = [rng.standard_normal((n, m_cols)).astype(np.float32) for _ in range(n_roots)]

    def scenario(s):
        kw = dict(graph=graph, partitions=((p, p),), b_partitions=((p, 1),), **s.kw)
        stacked = s.lin.run_lu_solve_batched(mats, rhss, **kw)
        s.clear()
        singles = [s.lin.run_lu_solve(a, b, **kw) for a, b in zip(mats, rhss)]
        for xs, xi in zip(stacked, singles):
            np.testing.assert_allclose(_np(xs), _np(xi), rtol=1e-6, atol=1e-6)
        return [_np(x) for x in stacked]

    both(scenario)


_KINDS = ("lu", "cholesky", "lu_solve")


def _rhs(seed):
    return np.random.default_rng(1000 + seed).standard_normal(_N).astype(np.float32)


def _submit(srv, kind, seed):
    if kind == "lu":
        return _lu(srv, seed)
    if kind == "cholesky":
        return _chol(srv, seed)
    return srv.lu_solve(_dd(_N, seed), _rhs(seed), partitions=((_P, _P),))


def _sequential(s, kind, seed):
    if kind == "lu":
        return s.lin.run_lu(_dd(_N, seed), partitions=((_P, _P),), **s.kw)
    if kind == "cholesky":
        return s.lin.run_cholesky(_spd(_N, seed), partitions=((_P, _P),), **s.kw)
    return s.lin.run_lu_solve(_dd(_N, seed), _rhs(seed), partitions=((_P, _P),),
                              b_partitions=((_P, 1),), **s.kw)


def _leaves(result):
    return [_np(x) for x in (result if isinstance(result, tuple) else (result,))]


@st.composite
def traffic(draw):
    """A few ticks of mixed lu / cholesky / lu_solve traffic, each tick's
    submission order an arbitrary interleaving of the three signatures."""
    ticks = []
    for _ in range(draw(st.integers(1, 3))):
        reqs = [(kind, draw(st.integers(0, 50))) for kind in _KINDS
                for _ in range(draw(st.integers(0, 3)))]
        order = draw(st.permutations(list(range(len(reqs)))))
        ticks.append([reqs[i] for i in order])
    return ticks


@settings(max_examples=4, deadline=None, derandomize=True)
@given(plan=traffic(), overlap=st.booleans())
def test_mixed_signature_traffic_matches_sequential(plan, overlap):
    """Random interleavings of mixed-signature submits resolve every future
    bit-identically to a server that sees each tick's requests grouped by
    signature (lanes are independent), and within 1e-6 of the same request
    drained on its own — in both packages, which agree with each other."""

    def scenario(s):
        srv = _server(s, graph="g2", overlap=overlap)
        canon = _server(s, graph="g2", overlap=False)
        subject, canon_futs, reps = [], {}, []
        for tick in plan:
            for kind, seed in tick:
                subject.append((kind, seed, _submit(srv, kind, seed)))
            for kind, seed in sorted(tick, key=lambda r: _KINDS.index(r[0])):
                canon_futs.setdefault((kind, seed), []).append(_submit(canon, kind, seed))
            rep = srv.tick()
            canon.tick()
            assert rep.resolved == len(tick) and rep.failed == 0
            reps.append(_report(rep))
        outs = []
        for kind, seed, fut in subject:
            got = _leaves(fut.result())
            # first in, first out: a request repeated in a later tick is
            # paired with the canonical server's request of that same tick
            for g, w in zip(got, _leaves(canon_futs[(kind, seed)].pop(0).result())):
                assert np.array_equal(g, w), f"{kind}(seed={seed}) != signature-grouped result"
            for g, w in zip(got, _leaves(_sequential(s, kind, seed))):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
            outs.append(got)
        return dict(outs=outs, reps=reps)

    both(scenario, tol=2e-4)
