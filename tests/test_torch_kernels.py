"""The port's Cholesky tile kernels on the CPU: their plain PyTorch versions
and the torch oracles against the JAX package's Pallas kernels (interpret
mode) on the same numpy inputs, with tests/test_kernels.py's tolerances
(POTRF 2e-4, TRSM 2e-3, SYRK/GEMM 1e-4).  The CUDA kernels themselves run
only on the card: chip_smoke.py holds them against these plain versions."""

import re

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
TOL = {"potrf": 2e-4, "trsm": 2e-3, "syrk": 1e-4, "gemm": 1e-4}
ARITY = {"potrf": 1, "trsm": 2, "syrk": 2, "gemm": 3}
WRITE_ARG = {"potrf": 0, "trsm": 1, "syrk": 1, "gemm": 2}


def _spd(rng, n, b):
    m = rng.standard_normal((n, b, b)).astype(np.float32) / np.float32(np.sqrt(b))
    return m @ m.transpose(0, 2, 1) + 2.0 * np.eye(b, dtype=np.float32)


def _inputs(name, b, n=1, seed=0):
    """numpy tile stacks for one kernel; TRSM's L carries finite junk above
    the diagonal, which both packages' tile bodies must ignore."""
    rng = np.random.default_rng(seed)
    if name == "potrf":
        return [_spd(rng, n, b)]
    if name == "trsm":
        low = np.linalg.cholesky(_spd(rng, n, b).astype(np.float64)).astype(np.float32)
        junk = np.triu(rng.standard_normal((n, b, b)).astype(np.float32), 1) * 0.3
        return [low + junk, rng.standard_normal((n, b, b)).astype(np.float32) * 0.3]
    return [rng.standard_normal((n, b, b)).astype(np.float32) * 0.3 for _ in range(ARITY[name])]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("name", list(ARITY))
def test_plain_tile_matches_pallas(name, b):
    xs = _inputs(name, b, seed=b)
    want = getattr(jops, name)(*(jnp.asarray(x[0]) for x in xs), interpret=True)
    got = getattr(tl, f"{name}_plain")(*(torch.from_numpy(x) for x in xs))[0]
    _close(got, want, TOL[name])


@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("name", list(ARITY))
def test_torch_oracle_matches_jax_oracle(name, b):
    xs = _inputs(name, b, seed=100 + b)
    if name == "trsm":  # the oracles read a clean factor
        xs[0] = np.tril(xs[0])
    want = getattr(jref, name)(*(jnp.asarray(x[0]) for x in xs))
    got = getattr(tref, name)(*(torch.from_numpy(x[0]) for x in xs))
    _close(got, want, TOL[name])


@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("name", list(ARITY))
def test_batched_wrapper_and_single_tile_entry_on_cpu(name, b):
    """On CPU tensors the wrappers run the plain version (no launch is
    counted) and leave their inputs untouched."""
    xs = [torch.from_numpy(x) for x in _inputs(name, b, n=5, seed=200 + b)]
    before = [x.clone() for x in xs]
    launches = dict(tl.LAUNCHES)
    out = getattr(tl, f"batched_{name}")(*xs)
    torch.testing.assert_close(out, getattr(tl, f"{name}_plain")(*xs), rtol=0, atol=0)
    one = getattr(tops, name)(*(x[2] for x in xs))
    torch.testing.assert_close(one, out[2], rtol=TOL[name], atol=TOL[name])
    assert tl.LAUNCHES == launches
    for x, x0 in zip(xs, before):
        assert torch.equal(x, x0)


def _grid_case(name, b, nr=3, nc=4, n=5, seed=0):
    """A random non-square grid, distinct write blocks, read blocks drawn
    from the rest; every argument addresses the same grid (as in the
    single-root Cholesky)."""
    rng = np.random.default_rng(seed)
    grid = rng.standard_normal((nr, nc, b, b)).astype(np.float32) * 0.3
    blocks = rng.permutation(nr * nc)
    flat = [rng.choice(blocks[n:], n) for _ in range(ARITY[name])]
    flat[WRITE_ARG[name]] = blocks[:n]
    if name == "potrf":
        grid.reshape(-1, b, b)[blocks[:n]] = _spd(rng, n, b)
    if name == "trsm":
        ls = np.unique(flat[0])
        grid.reshape(-1, b, b)[ls] = _inputs("trsm", b, n=len(ls), seed=seed + 1)[0]
    idxs = [np.stack([f // nc, f % nc], 1).astype(np.int32) for f in flat]
    return grid, idxs


@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("name", list(ARITY))
def test_grid_fused_matches_pallas_grid(name, b):
    """Whole grids compared, blocks outside the call included: the in-place
    write must land exactly on the indexed blocks of a grid with nc != nr."""
    grid, idxs = _grid_case(name, b, seed=300 + b)
    arity = ARITY[name]
    jg = jnp.asarray(grid)
    want = getattr(jtl, f"grid_{name}")(
        [jnp.asarray(ix) for ix in idxs], (jg,) * arity, interpret=True
    )
    tg = torch.from_numpy(grid.copy())
    launches = dict(tl.LAUNCHES)
    out = getattr(tl, f"grid_{name}")([torch.from_numpy(ix) for ix in idxs], [tg] * arity)
    assert out is tg  # updated in place
    assert tl.LAUNCHES == launches
    _close(tg, want, TOL[name])


def test_grid_fused_table_matches_reference():
    assert set(tl.GRID_FUSED) == set(jtl.GRID_FUSED)  # the LU five: test_torch_lu_kernels
    for name, (_, w) in tl.GRID_FUSED.items():
        assert jtl.GRID_FUSED[name][1] == w
        if name in WRITE_ARG:
            assert w == WRITE_ARG[name]


def test_potrf_plain_zeroes_upper_triangle():
    (a,) = _inputs("potrf", 16, n=3, seed=7)
    L = tl.potrf_plain(torch.from_numpy(a))
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    torch.testing.assert_close(L @ L.mT, torch.from_numpy(a), rtol=2e-4, atol=2e-4)


def test_kernel_sources_note_what_they_replace():
    """Each kernel's source names the TPU function it replaces, its bound
    on the card, and one C entry per kernel that reports launch errors."""
    from repro_torch.kernels import _build

    # each kernel's C entry lives in the source of its library
    srcs = {lib: (_build.CSRC / f"{lib}.cu").read_text() for lib in set(tl.LIBRARY.values())}
    for name in ARITY:
        src = srcs[tl.LIBRARY[name]]
        assert f"_{name}_tile" in src and f"{name}_kernel" in src
        assert f"int tile_{name}(" in src
    # one C entry per kernel
    assert sum(src.count("int tile_") for src in srcs.values()) == len(tl.LAUNCHES)

    def returns(src, head):
        start = src.index(head)
        return re.findall(r"return ([^;]*);", src[start : src.index("\n}\n", start)])

    for src in srcs.values():
        # launch_smem raises the shared-memory limit, launches and reports
        assert returns(src, "int launch_smem(") == ["(int)err", "(int)cudaGetLastError()"]
        assert "bound" in src and "sm_90a" in src
    for name in tl.LAUNCHES:
        *early, last = returns(srcs[tl.LIBRARY[name]], f"int tile_{name}(")
        assert early == ["(int)cudaErrorInvalidValue"], name  # bad arguments
        assert last == "(int)cudaGetLastError()" or last.startswith("launch_smem("), name


def test_tile_edge_limit_is_named():
    """Tiles wider than the kernels' limit are refused on every device."""
    big = torch.zeros(1, 1, tl.MAX_TILE + 1, tl.MAX_TILE + 1)
    ix = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match=str(tl.MAX_TILE)):
        tl.grid_gemm([ix] * 3, [big] * 3)
    with pytest.raises(ValueError, match=str(tl.MAX_TILE)):
        tl.batched_potrf(big[:, 0])
