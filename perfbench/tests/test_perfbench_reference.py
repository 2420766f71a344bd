"""The plain references against float64 NumPy at small sizes, and the
control, the reference one precision step down (float32 with TF32
products, emulated here), against each configuration's limit."""

import numpy as np
import pytest
import torch

from perfbench.compare import in_precision, tf32_matmul, tf32_round
from perfbench.registry import Registry

REG = Registry()


def hplmxp(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 0.5, (n, n))
    a[np.diag_indices(n)] = np.abs(a).sum(1)
    return a, rng.uniform(-0.5, 0.5, (n, 3))


def magma_spd(n, seed):
    a = np.random.default_rng(seed).uniform(0, 1, (n, n))
    a = np.tril(a) + np.tril(a, -1).T
    return a + n * np.eye(n)


@pytest.mark.parametrize("n,tile", [(16, 4), (48, 8), (64, 16)])
def test_lu_solve_reference(n, tile):
    a, b = hplmxp(n, n)
    x = REG.reference("lu_solve").lu_solve(torch.from_numpy(a), torch.from_numpy(b), tile).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("n,tile", [(16, 4), (48, 8), (64, 16)])
def test_cholesky_reference(n, tile):
    a = magma_spd(n, n)
    got = REG.reference("cholesky").cholesky(torch.from_numpy(a), tile).numpy()
    np.testing.assert_allclose(got, np.linalg.cholesky(a), rtol=1e-12, atol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11 + 2**-12, 1 + 2**-12, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-10, 1.0, 3.0])
    assert torch.equal(tf32_round(x), want)
    a = torch.rand(8, 8, dtype=torch.float32)
    assert (tf32_matmul(a, a) - a @ a).abs().max() < 1e-2


@pytest.mark.parametrize("config", ["sgesv-nopiv-n4096-fp32", "potrf-n8192-fp32"])
def test_control_fails_the_limit(config):
    """At n = 512 in tiles of 32 on the CPU: the reference in plain float32
    stays under the configuration's limit, the control (TF32 products)
    does not."""
    cfg = dict(REG.config(config), n=512, tile=32)
    op = REG.operation(cfg["operation"])
    (name, limit), = cfg["limits"].items()
    gen = torch.Generator().manual_seed(3)
    pool = op.make_pool(cfg, 2, gen, torch.device("cpu"))
    rhs = op.make_rhs(cfg, 4, gen, torch.device("cpu"))
    picks = [0, 1, 0, 1]
    readings = {p: op.compare(cfg, REG, pool, picks, rhs, [None] * 4, p)[name] for p in ("float32", "tf32")}
    assert readings["float32"] < limit < readings["tf32"], readings


@pytest.mark.parametrize("stage", ["updates", "panels", "factor"])
def test_lu_limit_is_blind_to_tf32_in_the_factor(stage):
    """What the LU cells' ``x_rel_err`` can and cannot see, at n = 512 in
    tiles of 32 on the CPU: TF32 products in the factor alone (its trailing
    updates, the GEMMNN groups, or its panels, the TRSML and TRSMU groups)
    stay under the limit, while TF32 in the solves alone exceeds it.  A
    change of the factor's precision needs proof elsewhere (PERF.md)."""
    cfg = dict(REG.config("sgesv-nopiv-n4096-fp32"), n=512, tile=32)
    ref, op = REG.reference("lu_solve"), REG.operation("lu_solve")
    gen = torch.Generator().manual_seed(3)
    a = op.make_pool(cfg, 2, gen, torch.device("cpu"))
    b = op.make_rhs(cfg, 2, gen, torch.device("cpu"))[..., None]
    want = ref.lu_solve(a.double(), b.double(), 32)

    def err(panels, updates, solves):
        x = ref.solve(*ref.factor(a, 32, panels, updates), b, 32, solves).double()
        return ((x - want).abs().amax(1) / want.abs().amax(1)).max().item()

    mm, tf32 = torch.matmul, tf32_matmul
    factor = {"updates": (mm, tf32), "panels": (tf32, mm), "factor": (tf32, tf32)}[stage]
    limit = cfg["limits"]["x_rel_err"]
    assert err(*factor, mm) < limit / 2
    assert err(mm, mm, tf32) > 3 * limit


def test_precision_restores_the_flag():
    before = torch.backends.cuda.matmul.allow_tf32
    with in_precision("tf32", torch.device("cpu")) as (dtype, mm):
        assert dtype == torch.float32 and mm is tf32_matmul
    assert torch.backends.cuda.matmul.allow_tf32 == before
