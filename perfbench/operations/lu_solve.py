"""LU factor-and-solve cells: inputs made on the device from the seed, the
program's entries (``repro_torch.linalg.run_lu_solve``,
``BatchServer.lu_solve``), and the comparison with the plain reference that
decides ``correct``.

Inputs follow HPL-MxP's generator (the configuration's ``assumed``): a_ij
uniform on [-0.5, 0.5), a_ii = sum_j |a_ij| (row dominance, so the LU
needs no pivoting), and b uniform on [-0.5, 0.5).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from perfbench.compare import chunks, finite, in_precision

REFERENCE = "lu_solve"
WORK = "lu_solve"


def make_pool(cfg: dict, count: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    n = cfg["n"]
    a = torch.rand((count, n, n), generator=gen, device=device, dtype=torch.float32)
    a -= 0.5
    for m in a:
        m.diagonal().copy_(m.abs().sum(-1))
    return a


def make_rhs(cfg: dict, count: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    b = torch.rand((count, cfg["n"]), generator=gen, device=device, dtype=torch.float32)
    return b.sub_(0.5)


def _parts(cfg: dict):
    p = cfg["n"] // cfg["tile"]
    return ((p, p),)


def entry(cfg: dict, device: torch.device) -> Callable:
    """``call(a, b) -> x``: the program's one-shot entry."""
    from repro_torch.linalg import run_lu_solve

    parts, graph = _parts(cfg), cfg["graph"]

    def call(a, b):
        return run_lu_solve(a, b, graph=graph, partitions=parts, device=device)

    return call


def server(cfg: dict, traffic: dict, device: torch.device):
    """The program's request server, and ``submit(srv, a, b) -> future``."""
    from repro_torch.serve import BatchServer

    parts = _parts(cfg)
    srv = BatchServer(graph=cfg["graph"], max_batch=traffic["max_batch"], device=device)
    return srv, lambda s, a, b: s.lu_solve(a, b, partitions=parts)


def compare(cfg: dict, registry, pool: torch.Tensor, picks: Sequence[int], rhs: torch.Tensor,
            outs: Sequence[torch.Tensor], precision: str = "float64") -> Dict[str, float]:
    """``x_rel_err``: the largest ||x - x_ref||_inf / ||x_ref||_inf over the
    answers ``outs`` (answer k solves ``pool[picks[k]] @ x == rhs[k]``),
    with x_ref from the plain reference run in ``precision``; and, for a
    control, ``control``: the same for the reference's own answers run in
    ``precision`` against float64."""
    ref = registry.reference(REFERENCE)
    tile = cfg["tile"]
    by: Dict[int, List[int]] = {}
    for k, j in enumerate(picks):
        by.setdefault(int(j), []).append(k)
    worst = 0.0
    for group in chunks(sorted(by), pool.shape[-1]):
        width = max(len(by[j]) for j in group)
        a = pool[list(group)].double()
        b = torch.zeros((len(group), a.shape[-1], width), dtype=torch.float64, device=a.device)
        for g, j in enumerate(group):
            b[g, :, : len(by[j])] = rhs[by[j]].double().T
        want = ref.lu_solve(a, b, tile)
        if precision == "float64":
            got = torch.zeros_like(b)
            for g, j in enumerate(group):
                got[g, :, : len(by[j])] = torch.stack([outs[k] for k in by[j]], -1).double()
        else:
            with in_precision(precision, a.device) as (dtype, mm):
                got = ref.lu_solve(a.to(dtype), b.to(dtype), tile, mm).double()
        for g, j in enumerate(group):
            m = len(by[j])
            err = (got[g, :, :m] - want[g, :, :m]).abs().amax(0) / want[g, :, :m].abs().amax(0)
            worst = max(worst, finite(err.max().item()))
        del a, b, want, got
    return {"x_rel_err": worst}
