"""The paper's application + technical layers for Cholesky (Fig. 2a).

``utp_cholesky`` is the technical-layer subroutine (lines 19-25): it creates
the root POTRF task and submits it to the dispatcher.  ``run_cholesky`` is
the whole application program: define data + partitions, call the
subroutine, wait for completion — identical for every task-flow graph.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..core import Dispatcher, GData, GTask
from ..core.data import from_grid
from .ops import POTRF


def utp_cholesky(dispatcher: Dispatcher, A: GData) -> GTask:
    task = GTask(POTRF, None, [A.root_view()])
    dispatcher.submit_task(task)
    return task


def run_cholesky(
    a: Any,
    graph: str = "g2",
    partitions: Tuple[Tuple[int, int], ...] = ((4, 4),),
    device=None,
    verify: Optional[bool] = None,
) -> torch.Tensor:
    """Factorize SPD ``a`` (numpy array or tensor); returns the lower factor
    L (upper zeroed) on ``device``, which is CUDA unless the caller names
    another."""
    d = Dispatcher(graph=graph, verify=verify)
    dtype = a.dtype if torch.is_tensor(a) else torch.float32
    A = GData(tuple(a.shape), partitions=partitions, dtype=dtype, value=a, device=device)
    utp_cholesky(d, A)
    d.run()
    if A.in_grid_epoch:
        return torch.tril(from_grid(A.grid))
    return torch.tril(A.value)
