"""Deterministic, seedable fault injection at named runtime sites.

The recovery paths of the drain/serving stack (DESIGN.md §10) are only
trustworthy if every one of them is exercisable on demand.  Production code
is instrumented at a small set of NAMED SITES; a test (or the CI fault
gate) arms a site with ``inject(...)`` and the instrumented code raises,
corrupts, or diverts exactly as specified — deterministically by default
(fire on the Nth match), or probabilistically with a seeded RNG.

    with faults.inject("executor.launch", RuntimeError("device lost")):
        run_lu(a)          # raises: the launch site fired

    with faults.inject("serve.drain", NumericalError("poisoned"),
                       when=lambda ctx: 7 in ctx["rids"], times=None):
        srv.tick()         # every drain containing request 7 fails

    with faults.inject("drain.stall", delay_s=0.2):
        srv.tick()         # the fence site SLEEPS 200ms (a hung drain)

Effects compose per fault: ``delay_s`` sleeps at the site first, then
``exc`` (if any) raises — a delay-only fault models a slow/hung path
without failing it, which is what the watchdog budget (DESIGN.md §14)
must catch.

Sites (armed by name; arming an unknown name is an error):

    leaf.fn                 resolving a group's leaf kernel at launch-list
                            build time raises (bad kernel)
    executor.launch         a launch-list run raises before executing
                            (ctx: batch, n_tasks, replay)
    executor.output         a finished list's grids are passed through
                            ``corrupt`` (default: all-NaN) and the result
                            written back into them in place — non-finite
                            corruption without a raise
    memo.capture            recording a ProgramRecord into the drain
                            capture raises (mid-drain, after the list
                            ran) — exercises memo-cleanliness invariants
    split.value_dependent   boolean site: a matched task split is treated
                            as value-dependent (non-memoizable), forcing
                            the ``_StackedAbort`` collect-mode fallback
    serve.drain             a ``BatchServer`` chunk drain raises before
                            dispatching (ctx: rids, op, size) — the
                            request-attributable failure bisection hunts
    drain.inflight          an overlapped drain fails while its epoch is
                            still in flight (DESIGN.md §12): fired at the
                            deferred resolution fence — ``DrainHandle.
                            wait()`` (ctx: epochs, leaves) and the serving
                            finalize step (ctx: rids, op, size, pending) —
                            after the kernels were launched, exercising
                            memo invalidation and the no-half-resolved-
                            futures invariant
    drain.stall             the fence over an overlapped drain hangs:
                            fired inside ``DrainHandle.wait`` and the
                            serving end-of-tick fence BEFORE readiness is
                            polled (ctx: rids/op/size or epochs/leaves),
                            so a ``delay_s`` fault here makes the fence
                            blow its wall-clock budget — the hung-drain
                            watchdog (DESIGN.md §14) must surface
                            ``DrainStalledError``
    launch.oom              a launch-list run fails with device OOM
                            (ctx: batch, n_tasks, replay) — arm with
                            ``ResourceExhausted`` (or any exception whose
                            text says "out of memory") to
                            exercise adaptive degradation: cap halving,
                            memo pressure shedding, split re-drains
                            (DESIGN.md §14)

Plan-mutation sites (DESIGN.md §11) — boolean sites whose consuming code
CORRUPTS the schedule instead of raising, so the static verifier can be
proven to detect exactly the bug class it claims to:

    plan.drop_edge          the leaf scope's tracker DAG loses every
                            in-edge of one task (a missed dependence —
                            the race ``analyze_hazards`` must catch)
    plan.merge_groups       the fusion pass force-merges two DEPENDENT
                            same-signature groups into one launch (the
                            illegal fusion ``verify_plan`` V1 must catch)
    plan.alias_lane         a stacked drain aliases lane 1 of every root
                            slot to lane 0's data (the overlap
                            ``verify_stacked_members`` V5 must catch)

Pure stdlib (``corrupt``'s default imports torch when it fires);
importable from production code with near-zero cost when no fault is armed
(one module-flag check per site call).  This is the port's own registry:
arming a site of the JAX package's ``repro.testing.faults`` does not arm
the port's, and the other way round.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

KNOWN_SITES = frozenset(
    {
        "leaf.fn",
        "executor.launch",
        "executor.output",
        "memo.capture",
        "split.value_dependent",
        "serve.drain",
        "drain.inflight",
        "drain.stall",
        "launch.oom",
        "plan.drop_edge",
        "plan.merge_groups",
        "plan.alias_lane",
    }
)


class Fault:
    """One armed fault: firing rule + effect + observability counters.

    ``matches`` counts site hits that passed ``when``; ``fired`` counts the
    subset that actually took effect (after ``after``/``times``/``p``).
    ``log`` keeps the ctx dict of every firing when ``record=True`` — a
    pure probe (``exc=None, record=True``) observes a site without
    perturbing it, which tests use to assert drain order.
    """

    def __init__(
        self,
        site: str,
        exc: Optional[BaseException] = None,
        *,
        when: Optional[Callable[[dict], bool]] = None,
        times: Optional[int] = 1,
        after: int = 0,
        p: float = 1.0,
        seed: int = 0,
        corrupt: Optional[Callable[[Any], Any]] = None,
        record: bool = False,
        delay_s: float = 0.0,
    ):
        if site not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site {site!r}; known: {sorted(KNOWN_SITES)}"
            )
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault probability must be in [0, 1], got {p}")
        if delay_s < 0:
            raise ValueError(f"fault delay_s must be >= 0, got {delay_s}")
        self.site = site
        self.exc = exc
        self.delay_s = delay_s
        self.when = when
        self.times = times
        self.after = after
        self.p = p
        self.corrupt = corrupt
        self.record = record
        self._rng = random.Random(seed)
        self.matches = 0
        self.fired = 0
        self.log: List[dict] = []

    def _take(self, ctx: dict) -> bool:
        """Decide (and account) whether this fault fires for ``ctx``."""
        if self.when is not None and not self.when(ctx):
            return False
        self.matches += 1
        if self.matches <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self.fired += 1
        if self.record:
            self.log.append(dict(ctx))
        return True

    def _raise(self) -> None:
        """Apply the fault's effects: sleep ``delay_s`` first (a slow/hung
        path), then raise ``exc`` if armed (a failing one)."""
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        exc = self.exc
        if callable(exc) and not isinstance(exc, BaseException):
            exc = exc()
        if exc is not None:
            raise exc


_LOCK = threading.Lock()
_ACTIVE: Dict[str, List[Fault]] = {}
_ENABLED = False  # fast-path flag: sites bail on this before any lookup


def active() -> bool:
    """True iff any fault is currently armed."""
    return _ENABLED


@contextmanager
def inject(
    site: str,
    exc: Optional[BaseException] = None,
    *,
    when: Optional[Callable[[dict], bool]] = None,
    times: Optional[int] = 1,
    after: int = 0,
    p: float = 1.0,
    seed: int = 0,
    corrupt: Optional[Callable[[Any], Any]] = None,
    record: bool = False,
    delay_s: float = 0.0,
):
    """Arm ``site`` for the duration of the ``with`` block; yields the
    ``Fault`` so the caller can assert on ``fired``/``matches``/``log``.

    ``times=1`` (default) fires once then disarms logically — the standard
    transient-fault shape; ``times=None`` fires on every match — the
    deterministic poisoned-request shape.  ``after=k`` skips the first k
    matches; ``p``/``seed`` make firing probabilistic but reproducible.
    ``delay_s`` sleeps at the site before (optionally) raising — a
    delay-only fault (``exc=None``) models a slow or hung path, the shape
    the watchdog budget hunts (DESIGN.md §14).
    """
    fault = Fault(
        site,
        exc,
        when=when,
        times=times,
        after=after,
        p=p,
        seed=seed,
        corrupt=corrupt,
        record=record,
        delay_s=delay_s,
    )
    global _ENABLED
    with _LOCK:
        _ACTIVE.setdefault(site, []).append(fault)
        _ENABLED = True
    try:
        yield fault
    finally:
        with _LOCK:
            lst = _ACTIVE.get(site)
            if lst and fault in lst:  # robust to a reset() mid-block
                lst.remove(fault)
                if not lst:
                    del _ACTIVE[site]
            _ENABLED = bool(_ACTIVE)


def reset() -> None:
    """Disarm everything (test-teardown safety net)."""
    global _ENABLED
    with _LOCK:
        _ACTIVE.clear()
        _ENABLED = False


def fire(site: str, **ctx) -> None:
    """Raising site: raise the armed fault's exception if one fires."""
    if not _ENABLED:
        return
    for fault in _ACTIVE.get(site, ()):
        if fault._take(ctx):
            fault._raise()


def fires(site: str, **ctx) -> bool:
    """Boolean site: True if any armed fault fires (no raise)."""
    if not _ENABLED:
        return False
    hit = False
    for fault in _ACTIVE.get(site, ()):
        if fault._take(ctx):
            fault._raise()  # raising faults still raise here
            hit = True
    return hit


def _nan_like(value):
    import torch

    if isinstance(value, (tuple, list)):
        return type(value)(_nan_like(v) for v in value)
    return torch.full_like(value, float("nan"))


def corrupt(site: str, value, **ctx):
    """Corruption site: pass ``value`` through each firing fault's
    ``corrupt`` callable (default: replace every tensor with NaNs)."""
    if not _ENABLED:
        return value
    for fault in _ACTIVE.get(site, ()):
        if fault._take(ctx):
            fn = fault.corrupt if fault.corrupt is not None else _nan_like
            value = fn(value)
    return value


def mutate_drop_edges(dag):
    """``plan.drop_edge`` mutation: remove EVERY in-edge of the first task
    (smallest id) that has predecessors, returning ``(task_id, dropped
    pred ids)`` or None if the DAG is edge-free.

    Dropping all in-edges (not just one) makes detection a guarantee, not
    an accident of DAG shape: a single dropped edge can be transitively
    implied by the remaining edges, in which case the schedule is still
    correct and the verifier rightly stays quiet.  With indegree forced to
    zero no path can reach the task at all, so each of its former direct
    predecessors (every one a true conflict — the tracker only records
    conflicts) becomes an unordered conflicting pair.  Duck-typed over
    ``TaskDag``; must be applied to a freshly built DAG (before its bitset
    reachability is computed/cached)."""
    for tid in sorted(dag.tasks):
        preds = dag.preds.get(tid)
        if preds:
            dropped = sorted(preds)
            for p in dropped:
                dag.edges[p].discard(tid)
            preds.clear()
            return tid, dropped
    return None


__all__ = [
    "Fault",
    "KNOWN_SITES",
    "active",
    "corrupt",
    "fire",
    "fires",
    "inject",
    "mutate_drop_edges",
    "reset",
]
