"""The port's LU tile kernels on the CPU: their plain PyTorch versions and
the torch oracles against the JAX package's Pallas kernels (interpret mode)
and oracles on the same numpy inputs, with tests/test_kernels.py's
tolerances (GETRF 2e-4, TRSML/TRSMU/TRSMUL 2e-3, GEMMNN 1e-4).  Right-hand
sides may be non-square (bc = 1 is a blocked vector).  The CUDA kernels
themselves run only on the card: chip_smoke.py holds them against these
plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import tile_linalg as jtl
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tile_linalg as tl

SIZES = [8, 16, 32]
WIDTHS = [1, 8]
TOL = {"getrf": 2e-4, "trsml": 2e-3, "trsmu": 2e-3, "trsmul": 2e-3, "gemmnn": 1e-4}
ARITY = {"getrf": 1, "trsml": 2, "trsmu": 2, "trsmul": 2, "gemmnn": 3}
# (name, b, bc): GETRF takes one square tile; the others a width-bc operand
CASES = [("getrf", b, b) for b in SIZES] + [
    (name, b, bc) for name in ("trsml", "trsmu", "trsmul", "gemmnn") for b in SIZES for bc in WIDTHS
]


def _dd(rng, n, b):
    """Column-diagonally-dominant tiles (dd_matrix's recipe per tile)."""
    a = rng.standard_normal((n, b, b)).astype(np.float32)
    a /= np.abs(a).sum(axis=1, keepdims=True) * 1.5
    idx = np.arange(b)
    a[:, idx, idx] = 1.0 + rng.uniform(0.0, 1.0, (n, b)).astype(np.float32)
    return a


def _packed(rng, n, b):
    """Packed L\\U of dd tiles from a float64 pivot-free LU: the unused
    triangle carries real junk that the solve kernels must not read."""
    m = _dd(rng, n, b).astype(np.float64)
    for k in range(b):
        m[:, k + 1 :, k] /= m[:, k, k, None]
        m[:, k + 1 :, k + 1 :] -= m[:, k + 1 :, k, None] * m[:, k, None, k + 1 :]
    return m.astype(np.float32)


def _inputs(name, b, bc, n=1, seed=0):
    rng = np.random.default_rng(seed)
    shapes = tl.tile_shapes(name, b, bc)
    if name == "getrf":
        return [_dd(rng, n, b)]
    xs = [rng.standard_normal((n,) + s).astype(np.float32) * 0.3 for s in shapes]
    if name != "gemmnn":
        xs[0] = _packed(rng, n, b)
    return xs


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("name,b,bc", CASES)
def test_plain_tile_matches_pallas(name, b, bc):
    xs = _inputs(name, b, bc, seed=b + bc)
    want = getattr(jops, name)(*(jnp.asarray(x[0]) for x in xs), interpret=True)
    got = getattr(tl, f"{name}_plain")(*(torch.from_numpy(x) for x in xs))[0]
    _close(got, want, TOL[name])


@pytest.mark.parametrize("name,b,bc", CASES)
def test_torch_oracle_matches_jax_oracle(name, b, bc):
    xs = _inputs(name, b, bc, seed=100 + b + bc)
    want = getattr(jref, name)(*(jnp.asarray(x[0]) for x in xs))
    got = getattr(tref, name)(*(torch.from_numpy(x[0]) for x in xs))
    _close(got, want, TOL[name])


@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("name", list(ARITY))
def test_batched_wrapper_and_single_tile_entry_on_cpu(name, b):
    """On CPU tensors the wrappers run the plain version (no launch is
    counted) and leave their inputs untouched."""
    xs = [torch.from_numpy(x) for x in _inputs(name, b, 8, n=5, seed=200 + b)]
    before = [x.clone() for x in xs]
    launches = dict(tl.LAUNCHES)
    out = getattr(tl, f"batched_{name}")(*xs)
    torch.testing.assert_close(out, getattr(tl, f"{name}_plain")(*xs), rtol=0, atol=0)
    one = getattr(tops, name)(*(x[2] for x in xs))
    torch.testing.assert_close(one, out[2], rtol=TOL[name], atol=TOL[name])
    assert tl.LAUNCHES == launches
    for x, x0 in zip(xs, before):
        assert torch.equal(x, x0)


def _grid_case(name, b, bc, n=5, seed=0):
    """Random non-square grids (nc != nr), one per distinct tile shape, so
    arguments of one shape address the same grid (as in a single-root LU).
    Write blocks are distinct; read blocks of the written grid come from
    the rest.  Triangle blocks hold packed L\\U tiles, GETRF's dd tiles."""
    rng = np.random.default_rng(seed)
    shapes = tl.tile_shapes(name, b, bc)
    w = tl.GRID_FUSED[name][1]
    grid_of, grids = {}, []
    for s in shapes:
        if s not in grid_of:
            grid_of[s] = len(grids)
            grids.append(rng.standard_normal((3, 4) + s).astype(np.float32) * 0.3)
    writes = rng.permutation(12)[:n]
    flat = []
    for a, s in enumerate(shapes):
        if a == w:
            flat.append(writes)
        else:
            pool = np.setdiff1d(np.arange(12), writes) if grid_of[s] == grid_of[shapes[w]] else np.arange(12)
            flat.append(rng.choice(pool, n))
    if name == "getrf":
        grids[0].reshape(-1, b, b)[writes] = _dd(rng, n, b)
    elif name != "gemmnn":
        ls = np.unique(flat[0])
        grids[grid_of[shapes[0]]].reshape(-1, b, b)[ls] = _packed(rng, len(ls), b)
    idxs = [np.stack([f // 4, f % 4], 1).astype(np.int32) for f in flat]
    return grids, [grid_of[s] for s in shapes], idxs


@pytest.mark.parametrize("name,b,bc", CASES)
def test_grid_fused_matches_pallas_grid(name, b, bc):
    """Whole grids compared, blocks outside the call included: the in-place
    write must land exactly on the indexed blocks."""
    grids, which, idxs = _grid_case(name, b, bc, seed=300 + b + bc)
    w = tl.GRID_FUSED[name][1]
    jg = [jnp.asarray(g) for g in grids]
    want = getattr(jtl, f"grid_{name}")(
        [jnp.asarray(ix) for ix in idxs], [jg[k] for k in which], interpret=True
    )
    tg = [torch.from_numpy(g.copy()) for g in grids]
    launches = dict(tl.LAUNCHES)
    out = getattr(tl, f"grid_{name}")([torch.from_numpy(ix) for ix in idxs], [tg[k] for k in which])
    assert out is tg[which[w]]  # updated in place
    assert tl.LAUNCHES == launches
    _close(out, want, TOL[name])
    for k, g in enumerate(tg):
        if k != which[w]:
            assert np.array_equal(g.numpy(), grids[k])  # read-only grids untouched


@pytest.mark.parametrize("name", list(ARITY))
def test_grid_plain_writes_only_its_blocks(name):
    grids, which, idxs = _grid_case(name, 16, 8, seed=17)
    w = tl.GRID_FUSED[name][1]
    tg = [torch.from_numpy(g.copy()) for g in grids]
    getattr(tl, f"grid_{name}_plain")([torch.from_numpy(ix) for ix in idxs], [tg[k] for k in which])
    gw, g0 = tg[which[w]].numpy(), grids[which[w]]
    written = {tuple(r) for r in idxs[w]}
    for r in range(3):
        for c in range(4):
            assert np.array_equal(gw[r, c], g0[r, c]) != ((r, c) in written)


def test_grid_fused_table_matches_reference():
    for name in ARITY:
        fn, w = tl.GRID_FUSED[name]
        assert fn is getattr(tl, f"grid_{name}")
        assert jtl.GRID_FUSED[name][1] == w
    assert set(tl.LAUNCHES) == set(jtl.GRID_FUSED)


@pytest.mark.parametrize("b", [8, 16])
def test_lu_solve_single_tile_matches_pallas(b):
    """The composed LUSOLVE leaf: (packed, x) with a @ x == b."""
    rng = np.random.default_rng(b)
    a = _dd(rng, 1, b)[0]
    rhs = rng.standard_normal((b, b)).astype(np.float32) * 0.3
    jp, jx = jops.lu_solve(jnp.asarray(a), jnp.asarray(rhs), interpret=True)
    for packed, x in (tops.lu_solve(torch.from_numpy(a), torch.from_numpy(rhs)),
                      tref.lu_solve(torch.from_numpy(a), torch.from_numpy(rhs))):
        _close(packed, jp, 2e-3)
        _close(x, jx, 2e-3)
        _close(torch.from_numpy(a) @ x, rhs, 2e-3)


def test_getrf_oracle_runs_under_vmap_on_cpu():
    """PyTorch has no pivot-free LU on the CPU: the oracle takes the plain
    recurrence there, which must batch under torch.func.vmap (the g2 leaf)."""
    a = torch.from_numpy(_dd(np.random.default_rng(3), 4, 16))
    got = torch.func.vmap(tref.getrf)(a)
    torch.testing.assert_close(got, tl.getrf_plain(a), rtol=0, atol=0)
    want = jax.vmap(jref.getrf)(jnp.asarray(a.numpy()))
    _close(got, want, TOL["getrf"])
    L = torch.tril(got, -1) + torch.eye(16)
    torch.testing.assert_close(L @ torch.triu(got), a, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize(
    "name,shapes",
    [
        ("trsml", [(8, 8), (9, 4)]),
        ("trsmul", [(8, 8), (8, 129)]),
        ("trsmu", [(8, 8), (4, 9)]),
        ("gemmnn", [(4, 8), (7, 2), (4, 2)]),
        ("gemmnn", [(4, 8), (8, 2), (4, 3)]),
        ("getrf", [(8, 4)]),
    ],
)
def test_shape_contracts_are_checked(name, shapes):
    grids = [torch.zeros((2, 2) + s) for s in shapes]
    ix = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="contract|limit"):
        getattr(tl, f"grid_{name}")([ix] * len(shapes), grids)
    with pytest.raises(ValueError, match="contract|limit"):
        getattr(tl, f"batched_{name}")(*(g[0] for g in grids))


def test_lu_kernel_sources_note_what_they_replace():
    from repro_torch.kernels import _build

    for name in ARITY:
        src = (_build.CSRC / f"{tl.LIBRARY[name]}.cu").read_text()
        assert f"_{name}_tile" in src and f"{name}_kernel(" in src
        assert f"int tile_{name}(" in src
    # TRSMUL and TRSML keep a column in a half-warp; TRSMUL's lane j hands on its quotient
    src = (_build.CSRC / f"{tl.LIBRARY['trsmul']}.cu").read_text()
    assert "__shfl_sync(0xffffffffu, div_rn(x[i] - t[i], dg, dinv), j, kW)" in src
    assert "__shfl_sync(0xffffffffu, x[i], j, kW)" in (_build.CSRC / f"{tl.LIBRARY['trsml']}.cu").read_text()
