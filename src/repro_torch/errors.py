"""Errors a drain can raise (DESIGN.md §10).

The port raises one error of its own so far: ``ScheduleVerificationError``,
from the static verifier.  The rest of the JAX package's taxonomy (the
``ServeError`` tree of drain, in-flight, stall and serving failures) comes
with the asynchronous drains and serving that raise it (ROADMAP queue A9).
"""

from __future__ import annotations


class ScheduleVerificationError(Exception):
    """A schedule invariant failed static verification (DESIGN.md §11).

    Raised by the hazard analysis (a dependence the versioning DAG does not
    order — a race) or by the plan verifier (an illegal fused group, slot
    order or scatter overlap).  The message carries the verification *site*
    and the offending task pair / block coordinates so the failure is
    actionable without re-running.  Deterministic for a given schedule
    structure.
    """

    def __init__(self, site: str, detail: str, pair: tuple = ()):
        self.site = site
        self.pair = tuple(pair)
        msg = f"[{site}] {detail}"
        if self.pair:
            msg += f" (tasks: {', '.join(str(p) for p in self.pair)})"
        super().__init__(msg)


__all__ = ["ScheduleVerificationError"]
