"""Batched serving front end over the stacked drain path (DESIGN.md §7).

``BatchServer`` queues many small independent user requests (e.g.
``lu_solve(a, b)``), buckets them by structural signature, and drains ONE
stacked launch list per signature per ``tick()``.  Each request returns a
``ServeFuture`` resolved at tick time; results are extracted lazily from
the shared stacked result grids.

Serving is fault-contained (DESIGN.md §10): a failing drain is bisected to
isolate the poisoned request(s), transient failures retry with backoff,
requests carry deadlines, and ``max_pending`` bounds the queue with
explicit overload shedding.  The error taxonomy lives in
``repro_torch.errors`` and is re-exported here for convenience.
"""

from ..errors import (
    DeadlineExceeded,
    DrainError,
    InflightError,
    NumericalError,
    RejectedError,
    ServeError,
)
from .server import BatchServer, ServeFuture, TickReport

__all__ = [
    "BatchServer",
    "DeadlineExceeded",
    "DrainError",
    "InflightError",
    "NumericalError",
    "RejectedError",
    "ServeError",
    "ServeFuture",
    "TickReport",
]
