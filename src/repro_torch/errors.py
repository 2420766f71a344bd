"""Errors a drain can raise (DESIGN.md §10).

Every failure the port surfaces to a caller is an instance of
``ServeError``, so application code can catch one base class and branch on
the concrete type, as in the JAX package:

    ServeError
    ├── NumericalError    a drain completed but produced non-finite values
    │                     (singular pivot, overflow) — deterministic, so
    │                     never retried
    └── ScheduleVerificationError
                          the static verifier proved a schedule invariant
                          violated; the message names the site and the
                          offending task pair

The rest of the JAX package's tree (drain, in-flight, stall and serving
failures) comes with the asynchronous drains and serving that raise it
(ROADMAP queue A9).
"""

from __future__ import annotations


class ServeError(Exception):
    """Base class for every runtime-surfaced drain/serving failure."""


class NumericalError(ServeError):
    """A drain completed but the result contains non-finite values.

    Deterministic (re-running the same request reproduces it), so a caller
    fails the request instead of retrying it.  Raised by the LU entry
    points' ``check_finite=True``.
    """


class ScheduleVerificationError(ServeError):
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


__all__ = ["NumericalError", "ScheduleVerificationError", "ServeError"]
