"""The benchmark's own count of each operation's tasks equals a count over
the tasks the port plans (p = 4 and 8 tiles a side, on the CPU)."""

from collections import Counter

import pytest
import torch

from perfbench.registry import Registry


def planned(monkeypatch, run):
    """Tasks the port's planner puts in its drains while ``run()`` runs:
    (op name, rows, columns of the written region) -> count."""
    from repro_torch.core.executors import jit_wave

    seen = Counter()
    plan = jit_wave.plan_schedule

    def spy(waves, dag=None):
        out = plan(waves, dag)
        if out is not None:
            for t in out.tasks:
                r = t.outputs()[0].region
                seen[(t.op.name, r.shape[0], r.shape[1])] += 1
        return out

    monkeypatch.setattr(jit_wave, "plan_schedule", spy)
    run()
    return seen


def counted(work, n, tile, rhs):
    """The work module's tasks: (kernel, rows, columns written) -> count,
    a task of b told by its FLOPs (at most 2 t^2 c, under a tile task's)."""
    out = Counter()
    for kernel, count, flops, _ in work.tasks(n, tile, rhs):
        cols = rhs if flops <= 2 * tile * tile * rhs else tile
        out[(kernel, tile, cols)] += count
    return out


@pytest.mark.parametrize("p", [4, 8])
def test_lu_solve_count(monkeypatch, p):
    from repro_torch.linalg import run_lu_solve

    tile, n = 4, 4 * p
    g = torch.Generator().manual_seed(p)
    a = torch.rand(n, n, generator=g) - 0.5
    a.diagonal().copy_(a.abs().sum(-1))
    b = torch.rand(n, generator=g)
    seen = planned(monkeypatch, lambda: run_lu_solve(a, b, graph="g2p", partitions=((p, p),), device="cpu"))
    assert seen == counted(Registry().work("lu_solve"), n, tile, 1)


@pytest.mark.parametrize("p", [4, 8])
def test_cholesky_count(monkeypatch, p):
    from repro_torch.linalg import run_cholesky

    tile, n = 4, 4 * p
    a = torch.rand(n, n, generator=torch.Generator().manual_seed(p))
    a = torch.tril(a) + torch.tril(a, -1).T + n * torch.eye(n)
    seen = planned(monkeypatch, lambda: run_cholesky(a, graph="g2p", partitions=((p, p),), device="cpu"))
    assert seen == counted(Registry().work("cholesky"), n, tile, 0)


@pytest.mark.parametrize("name,n,flops", [
    ("lu_solve", 4096, 2 * 4096**3 / 3 + 2 * 4096**2),
    ("cholesky", 8192, 8192**3 / 3),
])
def test_task_flops_add_up_to_the_algorithm(name, n, flops):
    """The tasks' FLOPs sum to LAPACK's count up to lower-order terms."""
    work = Registry().work(name)
    total = sum(c * f for _, c, f, _ in work.tasks(n, 128, 1))
    assert work.algorithmic_flops(n, 1) == flops
    assert abs(total / flops - 1) < 0.02
