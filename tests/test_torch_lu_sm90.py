"""The redesigned POTRF, GETRF, TRSML, TRSMU, TRSMUL, TRSM, SYRK, GEMM and
GEMMNN kernels (``csrc/tile_lu_sm90.cu``) on the CPU: emulations of their
arithmetic against the JAX package's Pallas kernels (interpret mode) on the
same numpy inputs, the wrapper's choice of launch shape, and the source's
notes.  The CUDA kernels themselves run only on the card: chip_smoke.py
holds them against the plain versions.

Tolerances are tests/test_kernels.py's: GEMMNN, SYRK and GEMM 1e-4, the
four triangular solves 2e-3, GETRF and POTRF 2e-4 (atol = rtol), the same
as chip_smoke.py's ``TOL``."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.data import dd_matrix
from repro.kernels import tile_linalg as jtl
from repro_torch.kernels import _build
from repro_torch.kernels import tile_linalg as tl

GEMMNN_TOL, TRSMU_TOL, GETRF_TOL, POTRF_TOL = 1e-4, 2e-3, 2e-4, 2e-4
TC_RATIO = 2.0  # chip_smoke.py's: a tensor-core tile's error at most twice fp32's


def tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: the float32 mantissa rounded to 10 bits, to
    nearest with ties away from zero (the low 13 bits cleared)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def gemmnn_tf32(a, b, c, terms: int) -> np.ndarray:
    """The kernel's C - A B on the tensor cores: each operand splits into
    big = tf32(x) and small = tf32(x - big); every 8-deep step's partial
    small*big, big*small and big*big (``terms`` = 3) or big*big alone (1)
    starts from 0 and is added into a float32 sum; C - sum is taken last.
    Products of TF32 values are exact in float32."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ab, bb = tf32(a), tf32(b)
    as_, bs = tf32(a - ab), tf32(b - bb)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        if terms == 3:
            part = as_[:, k] @ bb[k]
            part = part + ab[:, k] @ bs[k]
            part = part + ab[:, k] @ bb[k]
        else:
            part = ab[:, k] @ bb[k]
        acc = acc + part
    return np.asarray(c, np.float32) - acc


def _tiles(kind: str):
    """(A, B, C) at 128^3: dd_matrix tiles (the LU's diagonally dominant
    inputs) or 0.3-scale Gaussian ones (chip_smoke.py's check grids)."""
    if kind == "dd":
        return [np.asarray(dd_matrix(128, seed=s)) for s in (1, 2, 3)]
    rng = np.random.default_rng(7)
    return [rng.standard_normal((128, 128)).astype(np.float32) * 0.3 for _ in range(3)]


def _within(got, want, tol) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool((np.abs(got - want) <= tol + tol * np.abs(want)).all())


@pytest.mark.parametrize("kind", ["dd", "randn"])
def test_3xtf32_gemmnn_holds_the_fp32_tolerance_and_1xtf32_does_not(kind):
    a, b, c = _tiles(kind)
    want = np.asarray(jtl.batched_gemmnn(*(jnp.asarray(x[None]) for x in (a, b, c)), interpret=True))[0]
    three = gemmnn_tf32(a, b, c, terms=3)
    np.testing.assert_allclose(three, want, rtol=GEMMNN_TOL, atol=GEMMNN_TOL)
    assert not _within(gemmnn_tf32(a, b, c, terms=1), want, GEMMNN_TOL)  # why three terms


def test_tf32_split_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # a TF32 ulp at 1
    x = np.array([one + ulp / 2, one + ulp / 4, -(one + ulp / 2), one + 3 * ulp / 2], np.float32)
    np.testing.assert_array_equal(tf32(x), [one + ulp, one, -(one + ulp), one + 2 * ulp])
    y = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    big = tf32(y)
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any()
    rest = y - big
    assert np.abs(rest - tf32(rest)).max() <= 2.0**-22 * np.abs(y).max()


def trsmu_blocked(u: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """The kernel's order for X = B inv(U): column blocks of ``width``; each
    block first takes X_J -= X_{<J} U_{<J,J}, then a right-looking
    substitution inside the block (scale column j by 1 / U[j, j], subtract it
    from the block's later columns).  Reads only U's upper triangle."""
    u, x = u.float(), b.float().clone()
    n = u.shape[-1]
    for j0 in range(0, n, width):
        j1 = min(j0 + width, n)
        x[..., j0:j1] -= x[..., :j0] @ u[..., :j0, j0:j1]
        for j in range(j0, j1):
            x[..., j] *= 1.0 / u[..., j, j, None]
            x[..., j + 1 : j1] -= x[..., j, None] * u[..., j, None, j + 1 : j1]
    return x


def _packed(rng, n, b):
    """Packed L\\U of column-diagonally-dominant tiles (chip_smoke.py's
    ``packed_lu_tiles``): the strictly-lower part is L's junk."""
    m = rng.standard_normal((n, b, b))
    m /= np.abs(m).sum(axis=1, keepdims=True) * 1.5
    m[:, np.arange(b), np.arange(b)] = 1.0 + rng.uniform(0.0, 1.0, (n, b))
    for k in range(b):
        m[:, k + 1 :, k] /= m[:, k, k, None]
        m[:, k + 1 :, k + 1 :] -= m[:, k + 1 :, k, None] * m[:, k, None, k + 1 :]
    return m.astype(np.float32)


@pytest.mark.parametrize("width", [16, 32])
@pytest.mark.parametrize("br,b", [(1, 40), (5, 24), (40, 40), (24, 33)])
def test_blocked_trsmu_order_matches_pallas(width, br, b):
    rng = np.random.default_rng(br * 131 + b)
    u = _packed(rng, 2, b)
    rhs = rng.standard_normal((2, br, b)).astype(np.float32) * 0.3
    want = np.asarray(jtl.batched_trsmu(jnp.asarray(u), jnp.asarray(rhs), interpret=True))
    got = trsmu_blocked(torch.from_numpy(u), torch.from_numpy(rhs), width)
    np.testing.assert_allclose(got.numpy(), want, rtol=TRSMU_TOL, atol=TRSMU_TOL)
    # the strictly-lower junk is never read
    junk = torch.from_numpy(u) + torch.tril(torch.full((b, b), 7.0), -1)
    torch.testing.assert_close(trsmu_blocked(junk, torch.from_numpy(rhs), width), got, rtol=0, atol=0)


def trsml_blocked(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's order for X = inv(L) B, L unit lower: row blocks of 16;
    block I first takes X_I -= L_{I,<I} X_{<I}, then a unit-lower
    substitution inside the block whose products are summed apart (t) and
    subtracted last (x_j = x - t handed to the block's later rows; no
    division).  Reads only L's strictly lower triangle."""
    l, x = l.float(), b.float().clone()
    n = l.shape[-1]
    for i0 in range(0, n, 16):
        i1 = min(i0 + 16, n)
        x[..., i0:i1, :] -= l[..., i0:i1, :i0] @ x[..., :i0, :]
        t = torch.zeros_like(x[..., i0:i1, :])
        for j in range(i0, i1):
            xj = x[..., j, None, :] - t[..., j - i0, None, :]
            t[..., j - i0 + 1 :, :] += l[..., j + 1 : i1, j, None] * xj
        x[..., i0:i1, :] -= t
    return x


@pytest.mark.parametrize("b,bc", [(8, 1), (24, 5), (40, 40), (33, 24), (128, 1), (128, 128)])
def test_blocked_trsml_order_matches_pallas(b, bc):
    rng = np.random.default_rng(b * 131 + bc)
    l = _packed(rng, 2, b)
    rhs = rng.standard_normal((2, b, bc)).astype(np.float32) * 0.3
    want = np.asarray(jtl.batched_trsml(jnp.asarray(l), jnp.asarray(rhs), interpret=True))
    got = trsml_blocked(torch.from_numpy(l), torch.from_numpy(rhs))
    np.testing.assert_allclose(got.numpy(), want, rtol=TRSMU_TOL, atol=TRSMU_TOL)
    # the diagonal and the upper junk are never read
    junk = torch.from_numpy(l) + torch.triu(torch.full((b, b), 7.0))
    torch.testing.assert_close(trsml_blocked(junk, torch.from_numpy(rhs)), got, rtol=0, atol=0)


def trsmul_blocked(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's order for X = inv(U) B, U non-unit upper: row blocks of 16
    from the last (the ragged one) to the first; block I first sums
    U_{I,>I} X_{>I} into t, then runs an upper substitution inside the block
    from its last row up, adding the block's own products into t: x_j =
    (x_j - t_j) / U[j, j], one subtraction and a division, handed to the
    block's earlier rows.  Reads only U's upper triangle."""
    u, x = u.float(), b.float().clone()
    n = u.shape[-1]
    for i0 in reversed(range(0, n, 16)):
        i1 = min(i0 + 16, n)
        t = u[..., i0:i1, i1:] @ x[..., i1:, :]
        for j in reversed(range(i0, i1)):
            x[..., j, :] = (x[..., j, :] - t[..., j - i0, :]) / u[..., j, j, None]
            t[..., : j - i0, :] += u[..., i0:j, j, None] * x[..., j, None, :]
    return x


@pytest.mark.parametrize("b,bc", [(8, 1), (24, 5), (33, 24), (40, 40), (128, 1), (128, 128)])
def test_blocked_trsmul_order_matches_pallas(b, bc):
    rng = np.random.default_rng(b * 137 + bc)
    u = _packed(rng, 2, b)
    rhs = rng.standard_normal((2, b, bc)).astype(np.float32) * 0.3
    want = np.asarray(jtl.batched_trsmul(jnp.asarray(u), jnp.asarray(rhs), interpret=True))
    got = trsmul_blocked(torch.from_numpy(u), torch.from_numpy(rhs))
    np.testing.assert_allclose(got.numpy(), want, rtol=TRSMU_TOL, atol=TRSMU_TOL)
    # the strictly-lower junk (L of a packed L\U block) is never read
    junk = torch.from_numpy(u) + torch.tril(torch.full((b, b), 7.0), -1)
    torch.testing.assert_close(trsmul_blocked(junk, torch.from_numpy(rhs)), got, rtol=0, atol=0)


def trsm_blocked(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's order for X = B inv(L)^T, L non-unit lower: row p of X
    solves L x = B[p]^T by TRSML's column blocks of 16; block J first sums
    X_{<J} L_{J,<J}^T into t, then runs a right-looking substitution inside
    the block, adding the block's own products into t: x_j = (x_j - t_j) /
    L[j, j], one subtraction and a division, handed to the block's later
    columns.  Reads only L's lower triangle."""
    l, x = l.float(), b.float().clone()
    n = l.shape[-1]
    for j0 in range(0, n, 16):
        j1 = min(j0 + 16, n)
        t = x[..., :, :j0] @ l[..., j0:j1, :j0].mT
        for j in range(j0, j1):
            x[..., :, j] = (x[..., :, j] - t[..., :, j - j0]) / l[..., j, j, None]
            t[..., :, j - j0 + 1 :] += x[..., :, j, None] * l[..., None, j + 1 : j1, j]
    return x


def _chol(rng, n, b):
    """Cholesky factors of SPD tiles (chip_smoke.py's ``lower_with_junk``
    before its junk), computed in float64."""
    m = rng.standard_normal((n, b, b)) / np.sqrt(b)
    return np.linalg.cholesky(m @ m.transpose(0, 2, 1) + 2.0 * np.eye(b)).astype(np.float32)


@pytest.mark.parametrize("b", [8, 24, 33, 40, 128])
def test_blocked_trsm_order_matches_pallas(b):
    rng = np.random.default_rng(b * 139)
    low = _chol(rng, 2, b)
    rhs = rng.standard_normal((2, b, b)).astype(np.float32) * 0.3
    want = np.asarray(jtl.batched_trsm(jnp.asarray(low), jnp.asarray(rhs), interpret=True))
    got = trsm_blocked(torch.from_numpy(low), torch.from_numpy(rhs))
    np.testing.assert_allclose(got.numpy(), want, rtol=TRSMU_TOL, atol=TRSMU_TOL)
    # junk in the strict upper triangle is never read
    junk = torch.from_numpy(low) + torch.triu(torch.full((b, b), 7.0), 1)
    torch.testing.assert_close(trsm_blocked(junk, torch.from_numpy(rhs)), got, rtol=0, atol=0)


SQ = [(128, 128)] * 3
H100_SMS = 132


def ctas(name, tiles, n, lanes, shape):
    """CTAs a launch of ``n`` tasks over ``lanes`` lanes makes at launch shape
    ``shape``: TRSMU's and TRSM's row pieces of B, TRSML's and TRSMUL's
    column pieces, the output tiles of GEMMNN (32 rows a matrix-vector CTA),
    SYRK and GEMM."""
    m = tiles[-1][0]
    if name in ("trsmu", "trsm"):
        return n * lanes * -(-m // shape)
    q = tiles[-1][1]
    if name in ("trsml", "trsmul"):
        return n * lanes * -(-q // shape)
    return n * lanes * (-(-m // 32) if shape == 0 else -(-m // shape) * -(-q // shape))


def test_small_gemmnn_groups_fill_the_card():
    """A 4-task 128^3 group (the LU solve's) runs on >= 64 CTAs of 32^2; 64^2
    tiles only where they give every SM a CTA (the LU plan's 961-task group:
    3844 of them)."""
    for n, lanes, shape, want in ((4, 1, 32, 64), (31, 1, 32, 496), (33, 1, 64, 132), (961, 1, 64, 3844),
                                  (49, 64, 64, 12544)):  # the last: the served 49 x 64 lanes
        assert tl.launch_shape("gemmnn", SQ, n, lanes, H100_SMS) == (shape,)
        assert ctas("gemmnn", SQ, n, lanes, shape) == want
    assert tl.launch_shape("gemmnn", SQ, 33, 1, 200) == (32,)  # a card with more SMs


@pytest.mark.parametrize("q", [1, 3, 7])
def test_narrow_gemmnn_takes_the_matrix_vector_mapping(q):
    tiles = [(128, 128), (128, q), (128, q)]
    assert tl.launch_shape("gemmnn", tiles, 31, 1, H100_SMS) == (0,)
    assert ctas("gemmnn", tiles, 31, 1, 0) == 31 * 4  # 32 rows a CTA
    assert tl.launch_shape("gemmnn", [(128, 128), (128, 8), (128, 8)], 31, 1, H100_SMS) != (0,)


def test_trsml_splits_columns_across_ctas():
    """16 columns a CTA while those CTAs fit on the SMs at once, else 32 (the
    LU plan's 31-task group as 124 CTAs, the served 7 x 64 group as 1792)."""
    tiles = [(128, 128), (128, 128)]
    for n, lanes, shape, want in ((31, 1, 32, 124), (7, 64, 32, 1792), (1, 1, 16, 8), (16, 1, 16, 128),
                                  (17, 1, 32, 68), (465, 1, 32, 1860)):
        assert tl.launch_shape("trsml", tiles, n, lanes, H100_SMS) == (shape,)
        assert ctas("trsml", tiles, n, lanes, shape) == want
    # bc <= 16: one CTA a task, 16 columns (32 would leave half its half-warps on the zero column)
    for n, lanes, bc in ((1, 1, 1), (465, 1, 1), (8, 64, 1), (465, 1, 16)):
        assert tl.launch_shape("trsml", [(128, 128), (128, bc)], n, lanes, H100_SMS) == (16,)
        assert ctas("trsml", [(128, 128), (128, bc)], n, lanes, 16) == n * lanes
    assert tl.launch_shape("trsml", [(128, 128), (128, 17)], 465, 1, H100_SMS) == (32,)


def test_trsmul_splits_columns_across_ctas():
    """TRSMUL takes TRSML's rule: the LU solve's 4-task bc = 128 group as 32
    CTAs of 16 columns, a vector solve's bc = 1 task as one CTA, the served
    1 x 64 bc = 1 group as 64."""
    wide, vector = [(128, 128), (128, 128)], [(128, 128), (128, 1)]
    for tiles, n, lanes, shape, want in ((wide, 4, 1, 16, 32), (vector, 1, 1, 16, 1), (vector, 1, 64, 16, 64),
                                         (wide, 31, 1, 32, 124), (wide, 7, 64, 32, 1792)):
        assert tl.launch_shape("trsmul", tiles, n, lanes, H100_SMS) == (shape,)
        assert tl.launch_shape("trsmul", tiles, n, lanes, H100_SMS) == tl.launch_shape("trsml", tiles, n, lanes,
                                                                                       H100_SMS)
        assert ctas("trsmul", tiles, n, lanes, shape) == want


def test_trsm_splits_rows_across_ctas():
    """TRSM takes TRSMU's rule: the Cholesky plan's 31-task group as 248 CTAs
    of 16 rows, a 1-task group as 8, the served 7 x 64 group as 1792 of 32."""
    for n, lanes, shape, want in ((31, 1, 16, 248), (1, 1, 16, 8), (7, 64, 32, 1792), (33, 1, 32, 132)):
        assert tl.launch_shape("trsm", SQ[:2], n, lanes, H100_SMS) == (shape,)
        assert tl.launch_shape("trsm", SQ[:2], n, lanes, H100_SMS) == tl.launch_shape("trsmu", SQ[:2], n, lanes,
                                                                                     H100_SMS)
        assert ctas("trsm", SQ[:2], n, lanes, shape) == want


def test_gemm_splits_its_output_like_syrk():
    """The Cholesky plan's 465-task GEMM group as 1860 CTAs of 64^2, the
    served 21 x 64 group as 5376, a 1-task group as 16 of 32^2."""
    for n, lanes, shape, want in ((465, 1, 64, 1860), (31, 1, 32, 496), (21, 64, 64, 5376), (1, 1, 32, 16)):
        assert tl.launch_shape("gemm", SQ, n, lanes, H100_SMS) == (shape,)
        assert tl.launch_shape("gemm", SQ, n, lanes, H100_SMS) == tl.launch_shape("syrk", SQ[:2], n, lanes, H100_SMS)
        assert ctas("gemm", SQ, n, lanes, shape) == want


def test_trsmu_splits_rows_across_ctas():
    tiles = [(128, 128), (128, 128)]
    assert tl.launch_shape("trsmu", tiles, 31, 1, H100_SMS) == (16,)
    assert ctas("trsmu", tiles, 31, 1, 16) == 248
    assert tl.launch_shape("trsmu", tiles, 7, 64, H100_SMS) == (32,)  # the served 7 x 64 lanes
    assert ctas("trsmu", tiles, 7, 64, 32) == 1792


@pytest.mark.parametrize("n,lanes", [(1, 1), (4, 1), (31, 1), (961, 1), (3, 64), (200, 3)])
@pytest.mark.parametrize("edge", [1, 8, 40, 96, 128])
def test_launch_shapes_are_ones_the_c_launchers_take(n, lanes, edge):
    (rows,) = tl.launch_shape("trsmu", [(96, 96), (edge, 96)], n, lanes, H100_SMS)
    assert rows in (16, 32)
    for name in ("trsml", "trsmul"):
        (cols,) = tl.launch_shape(name, [(96, 96), (96, edge)], n, lanes, H100_SMS)
        assert cols in (16, 32)
        assert ctas(name, [(96, 96), (96, edge)], n, lanes, cols) >= n * lanes
    (rows,) = tl.launch_shape("trsm", [(edge, edge)] * 2, n, lanes, H100_SMS)
    assert rows in (16, 32)
    assert ctas("trsm", [(edge, edge)] * 2, n, lanes, rows) >= n * lanes
    for q in (1, 7, 8, edge):
        tiles = [(edge, 96), (96, q), (edge, q)]
        (tile,) = tl.launch_shape("gemmnn", tiles, n, lanes, H100_SMS)
        assert tile in (32, 64) or (tile == 0 and q < 8)
        assert ctas("gemmnn", tiles, n, lanes, tile) >= n * lanes
    assert tl.launch_shape("syrk", [(edge, edge)] * 2, n, lanes, H100_SMS)[0] in (32, 64)
    assert tl.launch_shape("gemm", [(edge, edge)] * 3, n, lanes, H100_SMS)[0] in (32, 64)


@pytest.mark.parametrize("edge", [0, 129])
def test_launch_shape_refuses_edges_outside_the_limit(edge):
    with pytest.raises(ValueError, match="limit"):
        tl.launch_shape("trsmu", [(8, 8), (edge, 8)], 4, 1, H100_SMS)
    with pytest.raises(ValueError, match="limit"):
        tl.launch_shape("gemmnn", [(8, 8), (8, edge), (8, edge)], 4, 1, H100_SMS)
    with pytest.raises(ValueError, match="limit"):
        tl.grid_gemmnn([torch.zeros(1, 2, dtype=torch.int32)] * 3,
                       [torch.zeros((1, 1, 8, 8)), torch.zeros((1, 1, 8, edge)), torch.zeros((1, 1, 8, edge))])


def test_lu_sm90_source_notes_what_it_replaces():
    """The redesigned kernels' source names the TPU kernels it replaces and
    what bounds them, runs SYRK, GEMM and GEMMNN as 3xTF32 on the tensor
    cores with cp.async staging, takes the wrapper's launch shape, and
    reports launch errors; it holds all nine tile kernels."""
    src = (_build.CSRC / "tile_lu_sm90.cu").read_text()
    sm90 = {"potrf", "getrf", "trsmu", "syrk", "gemmnn", "trsml", "gemm", "trsm", "trsmul"}
    assert {k for k, lib in tl.LIBRARY.items() if lib == "tile_lu_sm90"} == sm90 == set(tl.LIBRARY)
    for name in sm90:
        assert f"_{name}_tile" in src and f"batched_{name}" in src and f"{name}_kernel(" in src
    for word in ("bound", "sm_90a", "mma.sync.aligned.m16n8k8", "0x1000u) & 0xffffe000u", "cp.async", "__shfl_sync"):
        assert word in src, word
    assert "atomic" not in src.replace("atomics", "")  # deterministic: no atomics

    def entry(name):
        start = src.index(f"int tile_{name}(")
        return src[start : src.index("\n}\n", start)]

    for name in sm90:
        body = entry(name)
        *early, last = re.findall(r"return ([^;]*);", body)
        assert early == ["(int)cudaErrorInvalidValue"] and last.startswith("launch_smem("), name
        # one ctypes argument a C parameter: per argument its segment table and idx; nseg, n, batch, dims, shape
        # (SPLIT), stream
        params = body[body.index("(") + 1 : body.index(")")].split(",")
        assert len(params) == len(tl._ARGTYPES[name]), name
        assert sum("long long" in p for p in params) == tl._SIGNATURES[name][0], name
    head = src[src.index("int launch_smem("):]
    assert re.findall(r"return ([^;]*);", head[: head.index("\n}\n")]) == ["(int)err", "(int)cudaGetLastError()"]
    assert "blockIdx.y * lane" in src and "kMaxBatch = 65535" in src
    assert set(re.findall(r"int tile_(\w+)\(", src)) == sm90
    assert sorted(p.name for p in _build.CSRC.glob("tile_*.cu")) == ["tile_lu_sm90.cu"]


# --------------------------------------------------------------------------
# The C3 repair of GEMMNN, and SYRK on GEMMNN's tile
# --------------------------------------------------------------------------
def _err64(got, a, b, c) -> float:
    want = c.astype(np.float64) - a.astype(np.float64) @ b.astype(np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max())


@pytest.mark.parametrize("kind", ["dd", "randn"])
def test_promoted_gemmnn_error_within_twice_fp32s(kind):
    """Partials promoted every 8-deep step and C subtracted last keep the
    3xTF32 product within TC_RATIO times the float32 product's error against
    float64 (chip_smoke.py holds the card's kernel to the same against
    ``torch.matmul``)."""
    a, b, c = _tiles(kind)
    assert _err64(gemmnn_tf32(a, b, c, terms=3), a, b, c) <= TC_RATIO * _err64(c - a @ b, a, b, c)


@pytest.mark.parametrize("kind,op", [("dd", "syrk"), ("randn", "syrk"), ("dd", "gemm"), ("randn", "gemm")],
                         ids=["dd", "randn", "gemm-dd", "gemm-randn"])
def test_syrk_route_matches_pallas(kind, op):
    """SYRK and GEMM are GEMMNN's tile with B^T staged from B's rows: C - A
    A^T and C - A B^T, the full square."""
    a, b, c = _tiles(kind)
    if op == "syrk":
        b = a
        want = jtl.batched_syrk(jnp.asarray(a[None]), jnp.asarray(c[None]), interpret=True)
    else:
        want = jtl.batched_gemm(*(jnp.asarray(x[None]) for x in (a, b, c)), interpret=True)
    got = gemmnn_tf32(a, b.T, c, terms=3)
    np.testing.assert_allclose(got, np.asarray(want)[0], rtol=GEMMNN_TOL, atol=GEMMNN_TOL)
    assert _err64(got, a, b.T, c) <= TC_RATIO * _err64(c - a @ b.T, a, b.T, c)


def test_syrk_launch_shapes_fill_the_card():
    sq = [(128, 128)] * 2
    assert tl.launch_shape("syrk", sq, 31, 1, H100_SMS) == (32,)
    assert 31 * (128 // 32) ** 2 == 496 >= H100_SMS  # the Cholesky plan's 31-task group
    assert tl.launch_shape("syrk", sq, 7, 64, H100_SMS) == (64,)  # the served 7 x 64 lanes: 1792 CTAs
    assert tl.launch_shape("syrk", sq, 33, 1, H100_SMS) == (64,)
    for b in (1, 7, 8, 40, 128):  # no matrix-vector mapping: a tensor-core tile at every edge
        assert tl.launch_shape("syrk", [(b, b)] * 2, 4, 1, H100_SMS)[0] in (32, 64)
    with pytest.raises(ValueError, match="limit"):
        tl.launch_shape("syrk", [(129, 129)] * 2, 4, 1, H100_SMS)



# --------------------------------------------------------------------------
# GETRF: the tile in registers, one rank-1 step a barrier
# --------------------------------------------------------------------------
def getrf_steps(a: torch.Tensor, fused: bool) -> torch.Tensor:
    """The kernel's step order: at step k, column k below the pivot divided
    by it (the reference's division), then a[i][j] -= l[i] u[j] over rows and
    columns past k.  ``fused`` rounds that update once, as the kernel's fmaf
    does (the exact product and difference in float64, rounded to float32);
    otherwise the product and the difference round separately, as the plain
    version does."""
    m = a.float().clone()
    b = m.shape[-1]
    for k in range(b):
        m[..., k + 1 :, k] = m[..., k + 1 :, k] / m[..., k, k, None]
        l, u = m[..., k + 1 :, k, None], m[..., k, None, k + 1 :]
        if fused:
            m[..., k + 1 :, k + 1 :] = (m[..., k + 1 :, k + 1 :].double() - l.double() * u.double()).float()
        else:
            m[..., k + 1 :, k + 1 :] = m[..., k + 1 :, k + 1 :] - l * u
    return m


def _dd(rng, n, b):
    """Column-diagonally-dominant tiles (chip_smoke.py's ``dd_tiles``)."""
    a = rng.standard_normal((n, b, b)).astype(np.float32)
    a /= np.abs(a).sum(axis=1, keepdims=True) * 1.5
    a[:, np.arange(b), np.arange(b)] = 1.0 + rng.uniform(0.0, 1.0, (n, b)).astype(np.float32)
    return a


@pytest.mark.parametrize("b", [8, 32, 33, 96, 120, 128])
def test_getrf_step_order_matches_pallas_and_plain(b):
    a = _dd(np.random.default_rng(b), 2, b)
    want = np.asarray(jtl.batched_getrf(jnp.asarray(a), interpret=True))
    fused = getrf_steps(torch.from_numpy(a), fused=True)
    np.testing.assert_allclose(fused.numpy(), want, rtol=GETRF_TOL, atol=GETRF_TOL)
    # the same order with separate roundings is the plain version, bit for bit
    assert torch.equal(getrf_steps(torch.from_numpy(a), fused=False), tl.getrf_plain(torch.from_numpy(a)))


# --------------------------------------------------------------------------
# POTRF: the tile in registers, left-looking, one column a barrier
# --------------------------------------------------------------------------
def potrf_steps(a: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic: s[i][j] accumulates l_i l_j over the finished
    columns by fused multiply-add (the exact product and sum in float64,
    rounded to float32), kept apart from A; column k of L is c = a[:, k] -
    s[:, k] taken once (A's lower triangle: s is symmetric), d = sqrt(c[k])
    and l = c / d below the pivot (IEEE square root and division), 0 above."""
    a = a.float()
    b = a.shape[-1]
    idx = torch.arange(b)
    s = torch.zeros_like(a)
    L = torch.zeros_like(a)
    for k in range(b):
        c = a[..., :, k] - s[..., :, k]
        d = torch.sqrt(c[..., k])
        col = torch.where(idx > k, c / d[..., None], 0.0)
        col[..., k] = d
        L[..., :, k] = col
        s = (s.double() + col.double()[..., :, None] * col.double()[..., None, :]).float()
    return L


def _spd(rng, n, b):
    """SPD tiles (chip_smoke.py's ``spd_tiles``)."""
    m = rng.standard_normal((n, b, b)).astype(np.float32) / np.float32(np.sqrt(b))
    return m @ m.transpose(0, 2, 1) + 2.0 * np.eye(b, dtype=np.float32)


@pytest.mark.parametrize("b", [8, 32, 33, 96, 120, 128])
def test_potrf_step_order_matches_pallas_and_plain(b):
    a = _spd(np.random.default_rng(b), 2, b)
    want = np.asarray(jtl.batched_potrf(jnp.asarray(a), interpret=True))
    got = potrf_steps(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), want, rtol=POTRF_TOL, atol=POTRF_TOL)
    torch.testing.assert_close(got, tl.potrf_plain(torch.from_numpy(a)), rtol=POTRF_TOL, atol=POTRF_TOL)
    assert not torch.triu(got, 1).any()  # zeros above the diagonal, written


def test_potrf_steps_give_nan_where_the_reference_does():
    """A tile that is not SPD: the first negative pivot's column and every
    later one turn NaN, zeros stay above the diagonal, as in the Pallas
    kernel (the card's kernel must not hang or give finite garbage)."""
    a = _spd(np.random.default_rng(5), 1, 16)
    a[0, 6, 6] = -4.0
    want = np.asarray(jtl.batched_potrf(jnp.asarray(a), interpret=True))
    got = potrf_steps(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 6, 6]) and np.isfinite(got[0, :, :6]).all()
    assert (got[0][np.triu_indices(16, 1)] == 0).all()
