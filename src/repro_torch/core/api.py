"""Paper-style application-layer facade (Fig. 2a): utp_initialize/finalize.

Keeps a module-level current dispatcher so application programs read like
the paper's ``unified_cholesky.cpp``:

    utp_initialize(graph="g2")            # pick the task-flow graph
    A = GData(...); utp_cholesky(dispatcher(), A)   # submit root tasks
    utp_finalize()                        # drain: run everything submitted

For library code prefer constructing a ``Dispatcher`` directly (as
``repro_torch.linalg.run_*`` do); this facade exists for paper-shaped example
programs and scripts.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

from .dispatcher import Dispatcher

_current: Optional[Dispatcher] = None


def utp_initialize(graph: str = "g2") -> Dispatcher:
    """Create the current dispatcher (paper Fig. 2a line 11).

    ``graph`` names a task-flow graph (g1/g2/g2p — see
    ``core.graph.GRAPHS``; the distributed graphs are not ported yet).
    Returns the dispatcher, which is also reachable through
    ``dispatcher()`` until the next ``utp_initialize``.
    """
    global _current
    _current = Dispatcher(graph=graph)
    return _current


def dispatcher() -> Dispatcher:
    """The dispatcher created by the last ``utp_initialize`` call."""
    if _current is None:
        raise RuntimeError("call utp_initialize() first")
    return _current


def utp_finalize() -> int:
    """Wait for all tasks to finish (paper Fig. 2a line 16)."""
    n = dispatcher().run()
    return n


def utp_get_parameters(
    argv: Optional[List[str]] = None, defaults: Tuple[int, int, int] = (1024, 4, 4)
) -> Tuple[int, int, int]:
    """(N, b1, b2) from the command line, as in paper Fig. 2a line 10.

    Raises ``ValueError`` for non-positive values: a negative or zero matrix
    size / partition count would silently produce empty or inverted block
    grids downstream (``"-4".lstrip("-").isdigit()`` is True, so these used
    to parse "successfully").
    """
    argv = sys.argv[1:] if argv is None else argv
    names = ("N", "b1", "b2")
    vals = []
    for a in argv[:3]:
        # one optional sign, then digits; anything else is a non-int flag
        if not (a[1:] if a[:1] in "+-" else a).isdigit():
            continue
        v = int(a)
        if v <= 0:
            raise ValueError(
                f"utp_get_parameters: {names[len(vals)]}={v} must be a "
                "positive integer"
            )
        vals.append(v)
    n = vals[0] if len(vals) > 0 else defaults[0]
    b1 = vals[1] if len(vals) > 1 else defaults[1]
    b2 = vals[2] if len(vals) > 2 else defaults[2]
    return n, b1, b2
