"""The stacked grid form of the nine tile kernels (the JAX package's
``make_grid_fused`` ``kernel_stacked``) on the CPU: the port's plain stacked
version against the JAX package's stacked Pallas call in interpret mode, on
the same numpy ``(B, nr, nc, br, bc)`` grids, with tests/test_kernels.py's
tolerances.  Every lane shares the random distinct write blocks; lane 2 is
a copy of lane 1, as a pow2 padding lane is; whole grids are compared, so
unwritten blocks and lanes must keep their bytes.  The CUDA kernels run
only on the card: chip_smoke.py holds them against this plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import tile_linalg as jtl
from repro_torch.kernels import tile_linalg as tl

TOL = {"potrf": 2e-4, "trsm": 2e-3, "syrk": 1e-4, "gemm": 1e-4,
       "getrf": 2e-4, "trsml": 2e-3, "trsmu": 2e-3, "trsmul": 2e-3, "gemmnn": 1e-4}
WIDE = ("trsml", "trsmu", "trsmul", "gemmnn")
CASES = [(name, b, bc) for name in TOL for b in (8, 16)
         for bc in ((1, b) if name in WIDE else (b,))]
LANES, NR, NC, N = 3, 3, 4, 5


def _spd(rng, n, b):
    m = rng.standard_normal((n, b, b)).astype(np.float32) / np.float32(np.sqrt(b))
    return m @ m.transpose(0, 2, 1) + 2.0 * np.eye(b, dtype=np.float32)


def _dd(rng, n, b):
    a = rng.standard_normal((n, b, b)).astype(np.float32)
    a /= np.abs(a).sum(axis=1, keepdims=True) * 1.5
    a[:, np.arange(b), np.arange(b)] = 1.0 + rng.uniform(0.0, 1.0, (n, b)).astype(np.float32)
    return a


def _packed(rng, n, b):
    m = _dd(rng, n, b).astype(np.float64)
    for k in range(b):
        m[:, k + 1 :, k] /= m[:, k, k, None]
        m[:, k + 1 :, k + 1 :] -= m[:, k + 1 :, k, None] * m[:, k, None, k + 1 :]
    return m.astype(np.float32)


def _lower(rng, n, b):
    low = np.linalg.cholesky(_spd(rng, n, b).astype(np.float64)).astype(np.float32)
    return low + np.triu(rng.standard_normal((n, b, b)).astype(np.float32), 1) * 0.3


FACTOR = {"potrf": _spd, "getrf": _dd, "trsm": _lower, "trsml": _packed, "trsmu": _packed,
          "trsmul": _packed}


def _stacked_case(name, b, bc, seed):
    """Stacked grids, one per distinct tile shape; per-lane factor tiles in
    the blocks the factor argument reads; the last lane copies the one
    before it."""
    rng = np.random.default_rng(seed)
    shapes = tl.tile_shapes(name, b, bc)
    w = tl.GRID_FUSED[name][1]
    grid_of, grids = {}, []
    for s in shapes:
        if s not in grid_of:
            grid_of[s] = len(grids)
            grids.append(rng.standard_normal((LANES, NR, NC) + s).astype(np.float32) * 0.3)
    writes = rng.permutation(NR * NC)[:N]
    flat = []
    for a, s in enumerate(shapes):
        same = grid_of[s] == grid_of[shapes[w]]
        pool = np.setdiff1d(np.arange(NR * NC), writes) if same else np.arange(NR * NC)
        flat.append(writes if a == w else rng.choice(pool, N))
    make = FACTOR.get(name)
    if make is not None:
        blk = np.unique(flat[0])
        g = grids[grid_of[shapes[0]]]
        for lane in range(LANES):
            g[lane].reshape(-1, b, b)[blk] = make(rng, len(blk), b)
    for g in grids:
        g[-1] = g[-2]  # a padding lane
    idxs = [np.stack([f // NC, f % NC], 1).astype(np.int32) for f in flat]
    return grids, [grid_of[s] for s in shapes], idxs


@pytest.mark.parametrize("name,b,bc", CASES)
def test_stacked_plain_matches_pallas_stacked(name, b, bc):
    grids, which, idxs = _stacked_case(name, b, bc, seed=b * 10 + bc)
    w = tl.GRID_FUSED[name][1]
    jg = [jnp.asarray(g) for g in grids]
    want = getattr(jtl, f"grid_{name}")([jnp.asarray(ix) for ix in idxs], [jg[k] for k in which],
                                        interpret=True)
    tg = [torch.from_numpy(g.copy()) for g in grids]
    counts = (dict(tl.LAUNCHES), dict(tl.STACKED_LAUNCHES))
    out = getattr(tl, f"grid_{name}")([torch.from_numpy(ix) for ix in idxs], [tg[k] for k in which])
    assert out is tg[which[w]]  # updated in place
    assert (tl.LAUNCHES, tl.STACKED_LAUNCHES) == counts  # the CPU runs the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL[name], atol=TOL[name])
    np.testing.assert_array_equal(out[-1].numpy(), out[-2].numpy())  # lanes are independent
    for k, g in enumerate(tg):
        if k != which[w]:
            assert np.array_equal(g.numpy(), grids[k])  # read-only grids untouched
    written = {tuple(r) for r in idxs[w]}
    for r in range(NR):
        for c in range(NC):
            if (r, c) not in written:
                assert np.array_equal(out[:, r, c].numpy(), grids[which[w]][:, r, c])


@pytest.mark.parametrize("name", list(TOL))
def test_stacked_plain_equals_lane_by_lane_grid_form(name):
    """The stacked form is the unstacked one per lane (same arithmetic,
    one flattened stack)."""
    grids, which, idxs = _stacked_case(name, 16, 8, seed=41)
    w = tl.GRID_FUSED[name][1]
    ix = [torch.from_numpy(i) for i in idxs]
    stacked = [torch.from_numpy(g.copy()) for g in grids]
    tl.GRID_FUSED[name][0](ix, [stacked[k] for k in which])
    for lane in range(LANES):
        lg = [torch.from_numpy(g[lane].copy()) for g in grids]
        tl.GRID_FUSED[name][0](ix, [lg[k] for k in which])
        torch.testing.assert_close(stacked[which[w]][lane], lg[which[w]], rtol=1e-6, atol=1e-6)


def test_stacked_grids_must_agree_on_lanes():
    ix = torch.zeros(1, 2, dtype=torch.int32)
    g4 = torch.zeros(2, 2, 8, 8)
    with pytest.raises(ValueError, match="all"):
        tl.grid_gemm([ix] * 3, [g4, g4[None], g4])
    with pytest.raises(ValueError, match="lane count"):
        tl.grid_gemm([ix] * 3, [g4[None].repeat(2, 1, 1, 1, 1), g4[None], g4[None]])
    with pytest.raises(ValueError, match=str(tl.MAX_TILE)):
        tl.grid_potrf([ix], [torch.zeros(2, 1, 1, tl.MAX_TILE + 1, tl.MAX_TILE + 1)])


def test_stacked_kernel_source_takes_a_lane_dimension():
    """Each C entry takes a lane count and, per argument, a 64-bit lane
    stride; CTAs run on (task, lane) with the lane on blockIdx.y."""
    from repro_torch.kernels import _build

    srcs = {lib: (_build.CSRC / f"{lib}.cu").read_text() for lib in set(tl.LIBRARY.values())}
    for src in srcs.values():
        assert "kernel_stacked" in src and "blockIdx.y * lane" in src
        assert "dim3(n, batch)" in src and "kMaxBatch = 65535" in src
    for src in srcs.values():  # every launch, on (task, lane)
        assert src.count("<<<") == src.count("<<<dim3(n, batch)") >= 1
    for name in TOL:
        src = srcs[tl.LIBRARY[name]]
        head = src[src.index(f"int tile_{name}("): src.index("{", src.index(f"int tile_{name}("))]
        assert head.count("long long") == tl._SIGNATURES[name][0] and "int batch" in head, name
    assert tl.MAX_BATCH == 65535
