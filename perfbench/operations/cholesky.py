"""Cholesky cells: inputs made on the device from the seed, the program's
entry (``repro_torch.linalg.run_cholesky``), and the comparison with the
plain reference that decides ``correct``.

Inputs follow MAGMA's ``testing_spotrf_gpu`` (the configuration's
``assumed``): entries uniform on [0, 1), the lower triangle mirrored into
the upper, and n added to the diagonal (``magma_smake_hpd``).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from perfbench.compare import chunks, finite, in_precision

REFERENCE = "cholesky"
WORK = "cholesky"


def make_pool(cfg: dict, count: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    n = cfg["n"]
    a = torch.rand((count, n, n), generator=gen, device=device, dtype=torch.float32)
    for m in a:
        m.copy_(torch.tril(m) + torch.tril(m, -1).T)
        m.diagonal().add_(n)
    return a


def make_rhs(cfg: dict, count: int, gen: torch.Generator, device: torch.device) -> None:
    return None


def entry(cfg: dict, device: torch.device) -> Callable:
    """``call(a, b) -> L``: the program's one-shot entry (``b`` unused)."""
    from repro_torch.linalg import run_cholesky

    p = cfg["n"] // cfg["tile"]
    parts, graph = ((p, p),), cfg["graph"]

    def call(a, b=None):
        return run_cholesky(a, graph=graph, partitions=parts, device=device)

    return call


def compare(cfg: dict, registry, pool: torch.Tensor, picks: Sequence[int], rhs,
            outs: Sequence[torch.Tensor], precision: str = "float64") -> Dict[str, float]:
    """``l_tile_err``, the worst over the answers ``outs`` (answer k
    factors ``pool[picks[k]]``) of: each tile's largest error below the
    diagonal over that tile's largest entry there (tiles of the
    configuration's edge); each diagonal entry's relative error; the
    largest entry above the diagonal over the largest of L_ref.  L_ref is
    the plain reference's, in float64.  Each part is scaled by its own
    size: in one scale the diagonal (about sqrt(n)) would hide the panels'
    errors, and a tile, unlike a column near the end, never holds only a
    few small entries.  With another ``precision``, the same for the
    reference's own factors run in it (the control)."""
    ref = registry.reference(REFERENCE)
    tile = cfg["tile"]
    by: Dict[int, list] = {}
    for k, j in enumerate(picks):
        by.setdefault(int(j), []).append(k)
    worst = 0.0
    for group in chunks(sorted(by), pool.shape[-1]):
        a = pool[list(group)].double()
        want = ref.cholesky(a, tile)
        if precision != "float64":
            with in_precision(precision, a.device) as (dtype, mm):
                low = ref.cholesky(a.to(dtype), tile, mm)
        del a
        for g, j in enumerate(group):
            got = [low[g]] if precision != "float64" else [outs[k] for k in by[j]]
            for x in got:
                worst = max(worst, finite(tile_error(x.double(), want[g], tile)))
        del want
    return {"l_tile_err": worst}


def tile_error(got: torch.Tensor, want: torch.Tensor, tile: int) -> float:
    n = want.shape[-1]
    p = n // tile
    d = (got - want).abs()
    below = torch.tril(d, -1).view(p, tile, p, tile).amax((1, 3))
    scale = torch.tril(want, -1).abs().view(p, tile, p, tile).amax((1, 3))
    lower = torch.tril(torch.ones(p, p, dtype=torch.bool, device=want.device))
    tiles = (below[lower] / scale[lower]).max()
    diag = (d.diagonal() / want.diagonal().abs()).max()
    above = torch.triu(got, 1).abs().max() / want.abs().max()
    return max(tiles.item(), diag.item(), above.item())
