"""The matmul's routes (``csrc/matmul.cu``) on the CPU: emulations of the
3xTF32 and bf16 routes' arithmetic against the JAX package's Pallas
``matmul`` (interpret mode) on the same numpy inputs, and the wrapper's
choice of route.  The CUDA kernels themselves run only on the card:
chip_smoke.py holds each route against the plain version.

Tolerances: float32 1e-4 (tests/test_kernels.py::test_matmul_tiled's);
bfloat16 one bf16 ulp of the result, 2^-7 relative at worst (chip_smoke.py's
``MATMUL_TOL``); a 3xTF32 product's error against float64 at most TC_RATIO
times the float32 product's (chip_smoke.py holds the card's kernel to the
same against ``torch.matmul``)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import tile_linalg as jtl
from repro_torch.kernels import _build
from repro_torch.kernels import tile_linalg as tl

FP32_TOL, BF16_TOL = 1e-4, 2.0**-7
TC_RATIO = 2.0
M, K, N = 128, 1024, 128  # a long K: the partials' promotion matters


def kernel_depth() -> int:
    """The tf32x3 kernel's promotion depth, ``kPromote`` in the source."""
    src = (_build.CSRC / "matmul.cu").read_text()
    return int(re.search(r"constexpr int kPromote = (\d+);", src).group(1))


def tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: the float32 mantissa rounded to 10 bits, to
    nearest with ties away from zero (the low 13 bits cleared)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def matmul_tf32(a, b, terms: int, depth: int) -> np.ndarray:
    """The tf32x3 route's A B: each operand splits into big = tf32(x) and
    small = tf32(x - big); each 8-deep step adds small*big, big*small and
    big*big (``terms`` = 3) or big*big alone (1) into a partial that starts
    from 0 every ``depth`` deep and is then added into a float32 sum.
    Products of TF32 values are exact in float32."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ab, bb = tf32(a), tf32(b)
    as_, bs = tf32(a - ab), tf32(b - bb)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], depth):
        part = np.zeros_like(acc)
        for s0 in range(k0, min(k0 + depth, a.shape[1]), 8):
            k = slice(s0, s0 + 8)
            if terms == 3:
                part = part + as_[:, k] @ bb[k]
                part = part + ab[:, k] @ bs[k]
            part = part + ab[:, k] @ bb[k]
        acc = acc + part
    return acc


def _inputs(kind: str):
    rng = np.random.default_rng(11)
    if kind == "randn":  # chip_smoke.py's 0.3-scale inputs
        return [rng.standard_normal(s).astype(np.float32) * 0.3 for s in ((M, K), (K, N))]
    # all positive: no cancellation, the sum grows with K
    return [rng.uniform(0.0, 1.0, s).astype(np.float32) for s in ((M, K), (K, N))]


def _pallas(a, b):
    return np.asarray(jtl.matmul(jnp.asarray(a), jnp.asarray(b), interpret=True))


def _err64(got, a, b) -> float:
    return float(np.abs(np.asarray(got, np.float64) - a.astype(np.float64) @ b.astype(np.float64)).max())


def _within(got, want, tol) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool((np.abs(got - want) <= tol + tol * np.abs(want)).all())


@pytest.mark.parametrize("depth", [8, 16, 32])
@pytest.mark.parametrize("kind", ["randn", "uniform"])
def test_3xtf32_route_matches_pallas_within_twice_fp32s_error(kind, depth):
    """At each promotion depth the route's knob may take (the kernel's
    ``kPromote``; scripts/matmul_potrf_variants.py times the others on the
    card), the 3xTF32 product holds the float32 reference's 1e-4 and stays
    within TC_RATIO times numpy's float32 error against float64."""
    a, b = _inputs(kind)
    got = matmul_tf32(a, b, terms=3, depth=depth)
    np.testing.assert_allclose(got, _pallas(a, b), rtol=FP32_TOL, atol=FP32_TOL)
    assert _err64(got, a, b) <= TC_RATIO * _err64(a @ b, a, b)


@pytest.mark.parametrize("kind", ["randn", "uniform"])
def test_1xtf32_misses_the_fp32_rules(kind):
    """Why three terms: one TF32 product keeps ~2^-11 a term, and misses
    the 1e-4 tolerance or the error rule."""
    a, b = _inputs(kind)
    one = matmul_tf32(a, b, terms=1, depth=kernel_depth())
    within_tol = _within(one, _pallas(a, b), FP32_TOL)
    within_ratio = _err64(one, a, b) <= TC_RATIO * _err64(a @ b, a, b)
    assert not (within_tol and within_ratio)


def test_promotion_depth_is_one_emulated_here():
    """The kernel's depth is one the tests above hold to the rules, and a
    ring chunk holds whole partials."""
    src = (_build.CSRC / "matmul.cu").read_text()
    chunk = int(re.search(r"constexpr int kTcKC = (\d+);", src).group(1))
    assert kernel_depth() in (8, 16, 32) and chunk % kernel_depth() == 0


@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (64, 128, 32), (128, 64, 128), (128, 1024, 128)])
def test_bf16_route_matches_pallas(m, k, n):
    """The wgmma route: bf16 products (exact in float32) summed in float32,
    rounded to bf16 once: within one bf16 ulp of Pallas's bf16 product."""
    rng = np.random.default_rng(m + k + n)
    a, b = (rng.standard_normal(s).astype(np.float32) * 0.3 for s in ((m, k), (k, n)))
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    got = (ta.float() @ tb.float()).bfloat16().float().numpy()
    want = jtl.matmul(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), bm=min(m, 128), bn=min(n, 128),
                      bk=min(k, 128), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), rtol=BF16_TOL, atol=BF16_TOL)
    # the wrapper's plain version computes the same on the CPU
    assert torch.equal(tl.matmul(ta, tb, bm=min(m, 128), bn=min(n, 128), bk=min(k, 128)).float(),
                       torch.from_numpy(got))


@pytest.mark.parametrize("dtype,m,k,n,aligned,route", [
    ("float32", 4096, 4096, 4096, True, tl.TF32X3),
    ("float32", 7, 5, 3, False, tl.TF32X3),  # any shape, any base
    ("float32", 128, 36, 20, True, tl.TF32X3),
    ("bfloat16", 4096, 4096, 4096, True, tl.WGMMA),
    ("bfloat16", 32, 32, 32, True, tl.WGMMA),  # TMA zero-fills the 128 x 256 tile's ragged edge
    ("bfloat16", 100, 40, 24, True, tl.WGMMA),
    ("bfloat16", 4096, 4096, 4096, False, tl.SIMPLE),  # a misaligned view: TMA needs 16-byte bases
    ("bfloat16", 7, 5, 3, True, tl.SIMPLE),  # k and n: TMA needs 16-byte row strides
    ("bfloat16", 128, 36, 128, True, tl.SIMPLE),
    ("bfloat16", 128, 128, 6, True, tl.SIMPLE),
])
def test_matmul_route_by_shape(dtype, m, k, n, aligned, route):
    assert tl.matmul_route(getattr(torch, dtype), m, k, n, aligned) == route


def test_matmul_counts_each_route_and_the_cpu_launches_none():
    assert set(tl.MATMUL_LAUNCHES) == {tl.WGMMA, tl.TF32X3, tl.SIMPLE}
    before = dict(tl.MATMUL_LAUNCHES)
    for dt in (torch.float32, torch.bfloat16):
        tl.matmul(torch.ones(8, 8, dtype=dt), torch.ones(8, 8, dtype=dt))
    assert tl.MATMUL_LAUNCHES == before
