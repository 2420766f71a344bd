"""Error taxonomy for drains and batched serving (DESIGN.md §10).

Every failure the port surfaces to a caller is an instance of
``ServeError`` (or a plain exception wrapped into one at the serving
boundary), so application code can catch one base class and branch on the
concrete type, as in the JAX package:

    ServeError
    ├── DrainError        a dispatcher drain raised (build/launch/capture
    │                     failure); ``__cause__`` carries the original
    │   ├── InflightError the drain launched but FAILED before its
    │   │                 in-flight results were fenced (overlapped
    │   │                 execution, DESIGN.md §12) — detected at the
    │   │                 deferred resolution fence; retryable like any
    │   │                 DrainError
    │   ├── DrainStalledError
    │   │                 the hung-drain watchdog's wall-clock budget
    │   │                 expired before the drain's fence became ready
    │   │                 (DESIGN.md §14) — the drain's memo entries were
    │   │                 invalidated; NEVER retried (a re-drain would
    │   │                 race the same hung computation)
    │   └── ResourceExhausted
    │                     the card ran out of memory for a stacked drain
    │                     (``torch.cuda.OutOfMemoryError``); the serving
    │                     layer degrades the bucket's batch cap and
    │                     re-drains split halves (DESIGN.md §14) — only a
    │                     request that OOMs ALONE lands this on its
    │                     future, so it is never retried at full size
    ├── NumericalError    a drain completed but produced non-finite values
    │                     (singular pivot, overflow) — deterministic, so
    │                     NEVER retried
    ├── DeadlineExceeded  the request's deadline passed before it was
    │                     drained; the request was failed WITHOUT draining
    ├── RejectedError     admission control shed the request (queue at
    │                     ``max_pending``) — it was never queued/drained
    ├── CircuitOpenError  the request's signature bucket has its circuit
    │                     breaker OPEN (persistent drain failures,
    │                     DESIGN.md §14): failed fast WITHOUT draining;
    │                     the bucket half-opens after a cooldown
    └── ScheduleVerificationError
                          the static verifier (DESIGN.md §11) proved a
                          schedule invariant violated — a race the
                          versioning missed or an illegal plan; the message
                          names the site and the offending task pair.
                          Deterministic (structural), NEVER retried.

The taxonomy lives at the top level (not under ``serve/``) because the
drain-side surfaces raise it too: ``run_lu(check_finite=True)`` raises
``NumericalError`` directly, with no serving stack involved.

``LintError`` stands apart: static tooling (``analysis/lint_ops.py``)
raises it, never a drain.
"""

from __future__ import annotations


class ServeError(Exception):
    """Base class for every runtime-surfaced drain/serving failure."""


class DrainError(ServeError):
    """A dispatcher drain raised; the original exception is ``__cause__``.

    Transient by assumption (executor hiccup, injected fault): the serving
    layer retries these within the request's retry budget.
    """


class InflightError(DrainError):
    """An overlapped drain failed AFTER launch, at deferred resolution.

    Kernel launches return before the card finishes (DESIGN.md §12); a
    failure surfacing at the deferred fence (end-of-tick validation, an
    injected ``drain.inflight`` fault) lands here.  The drain's memo
    entries were already invalidated by the handle.  A ``DrainError``
    subclass: transient by assumption, retried within the request's budget.
    """


class DrainStalledError(DrainError):
    """The hung-drain watchdog fired: the drain's fence did not become
    ready within its wall-clock budget (DESIGN.md §14).

    The stalled drain's memo entries were invalidated before this raised.
    NOT retried despite being a ``DrainError``: the hung kernels still own
    their device resources (a CUDA event cannot be interrupted), so a retry
    would queue behind the very computation that stalled.  Only process
    restart reclaims the card.
    """


class ResourceExhausted(DrainError):
    """A drain failed with device out-of-memory.

    The serving layer treats this as *pressure*, not poison: the bucket's
    batch cap is halved, drain-memo entries are shed, and the chunk
    re-drains as split halves (DESIGN.md §14).  It lands on a future only
    when a SINGLE request still OOMs, which re-running at the same size
    deterministically reproduces — so it is never retried.
    """


class CircuitOpenError(ServeError):
    """The request's signature bucket is circuit-broken (DESIGN.md §14).

    A bucket whose drains keep failing trips its breaker OPEN: queued and
    incoming requests of that signature fail fast, without draining, so a
    persistently poisoned workload class cannot starve the tick loop or
    burn the retry budget of healthy buckets.  After a cooldown the
    breaker half-opens and a single probe request tests recovery.
    """


class NumericalError(ServeError):
    """A drain completed but the result contains non-finite values.

    Deterministic (re-running the same request reproduces it), so the
    serving layer fails the request immediately, never retries.
    """


class DeadlineExceeded(ServeError):
    """The request's deadline expired before it was drained."""


class RejectedError(ServeError):
    """Admission control rejected the request (overload shedding)."""


class ScheduleVerificationError(ServeError):
    """A schedule invariant failed static verification (DESIGN.md §11).

    Raised by the hazard analysis (a dependence the versioning DAG does not
    order — a race) or by the plan verifier (an illegal fused group, slot
    order, scatter overlap, or lane aliasing).  The message carries the
    verification *site* and the offending task pair / block coordinates so
    the failure is actionable without re-running.  Deterministic for a
    given schedule structure, so the serving layer never retries it.
    """

    def __init__(self, site: str, detail: str, pair: tuple = ()):
        self.site = site
        self.pair = tuple(pair)
        msg = f"[{site}] {detail}"
        if self.pair:
            msg += f" (tasks: {', '.join(str(p) for p in self.pair)})"
        super().__init__(msg)


class LintError(Exception):
    """The operation-algebra linter found contract violations (DESIGN.md
    §11): an impure ``split`` on a memoizable Operation, access modes
    inconsistent with the leaf's write positions, or incoherent
    leaf/batched-leaf signatures.  Static tooling only — never raised by a
    drain."""

    def __init__(self, issues):
        self.issues = list(issues)
        super().__init__(
            f"{len(self.issues)} operation lint issue(s):\n  "
            + "\n  ".join(str(i) for i in self.issues)
        )


__all__ = [
    "CircuitOpenError",
    "DeadlineExceeded",
    "DrainError",
    "DrainStalledError",
    "InflightError",
    "LintError",
    "NumericalError",
    "RejectedError",
    "ResourceExhausted",
    "ScheduleVerificationError",
    "ServeError",
]
