"""The port's blocked Cholesky against the JAX package's on the CPU: the
same numpy input through ``repro.linalg.run_cholesky`` and
``repro_torch.linalg.run_cholesky`` on g1/g2/g2p agrees within the JAX
test's tolerance (tests/test_cholesky.py: rtol = atol = 2e-4)."""

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.linalg import run_cholesky as jrun
import repro_torch.core as tcore
from repro_torch.linalg import run_cholesky, utp_cholesky


@pytest.mark.parametrize("graph", ["g1", "g2", "g2p"])
@pytest.mark.parametrize("n,parts", [(32, ((2, 2),)), (64, ((4, 4),))])
def test_cholesky_matches_reference(graph, n, parts):
    a = tcore.spd_matrix(n, seed=n, device="cpu")
    ja = jcore.spd_matrix(n, seed=n)
    assert np.array_equal(a.numpy(), np.asarray(ja))  # bit-identical inputs
    L = run_cholesky(a.numpy(), graph=graph, partitions=parts, device="cpu")
    assert L.device.type == "cpu" and L.dtype == torch.float32
    np.testing.assert_allclose(L.numpy(), np.asarray(jrun(ja, graph=graph, partitions=parts)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(a.double().numpy()),
                               rtol=2e-4, atol=2e-4)


def test_same_program_all_graphs_identical_results():
    """The paper's portability claim: ONE program, any graph, same result."""
    a = tcore.spd_matrix(32, seed=11, device="cpu")
    outs = {g: run_cholesky(a, graph=g, partitions=((2, 2),), device="cpu") for g in ("g1", "g2", "g2p")}
    for g, v in outs.items():
        torch.testing.assert_close(v, outs["g1"], rtol=1e-5, atol=1e-5)


def test_dispatcher_stats():
    a = tcore.spd_matrix(32, seed=3, device="cpu")
    d = tcore.Dispatcher(graph="g2")
    A = tcore.GData(a.shape, partitions=((4, 4),), value=a, device="cpu")
    utp_cholesky(d, A)
    # 4x4 blocked cholesky: 4 potrf + 6 trsm + 6 syrk + 4 gemm = 20 leaf tasks
    assert d.run() == 20
    assert d.stats["submitted"] == 1
    assert d.stats["split"] == 1


def test_run_cholesky_leaves_its_input_alone():
    a = tcore.spd_matrix(32, seed=12, device="cpu")
    a0 = a.clone()
    L = run_cholesky(a, graph="g2p", partitions=((1, 1),), device="cpu")
    assert torch.equal(a, a0)
    torch.testing.assert_close(L @ L.T, a, rtol=2e-4, atol=2e-4)
