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
from ..core.data import like, local_part
from ..core.executors.sharded import drained, mesh_device
from .ops import POTRF


def lower(v: torch.Tensor) -> torch.Tensor:
    """The lower triangle of ``v``, whole or split: on this rank's part, by
    its offset, with no collective."""
    local, (r0, c0) = local_part(v)
    return like(v, torch.tril(local, r0 - c0))


def utp_cholesky(dispatcher: Dispatcher, A: GData) -> GTask:
    task = GTask(POTRF, None, [A.root_view()])
    dispatcher.submit_task(task)
    return task


def run_cholesky(
    a: Any,
    graph: str = "g2",
    partitions: Tuple[Tuple[int, int], ...] = ((4, 4),),
    mesh=None,
    device=None,
    verify: Optional[bool] = None,
) -> torch.Tensor:
    """Factorize SPD ``a`` (numpy array or tensor); returns the lower factor
    L (upper zeroed) on ``device``, which is CUDA unless the caller names
    another.  With ``mesh`` (the distributed graphs) the data goes on the
    mesh's device and L stays split as the drain left it, as the JAX
    package's sharded result does: a ``DTensor`` whose ``to_local()`` is
    this rank's rows (``full_tensor()``, a collective every rank calls,
    gives the whole factor); a root the mesh does not split comes back
    whole.  ``a`` may be the whole matrix on every rank or a ``DTensor``
    split that way."""
    device = mesh_device(mesh, device)
    d = Dispatcher(graph=graph, mesh=mesh, verify=verify)
    dtype = a.dtype if torch.is_tensor(a) else torch.float32
    A = GData(tuple(a.shape), partitions=partitions, dtype=dtype, value=a, device=device)
    utp_cholesky(d, A)
    d.run()
    return lower(drained(d.executor, A))
