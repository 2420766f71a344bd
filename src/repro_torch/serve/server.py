"""BatchServer: signature-bucketed batched serving of task-graph drains.

Requests accumulate between ticks; ``tick()`` groups them by *structural
signature* — (graph, operation, per-argument shape/dtype/partitions) — and
submits each group's root tasks to one dispatcher drain.  A homogeneous
group takes the stacked path (DESIGN.md §7): ONE batched launch list over a
pow2-padded batch axis, so a tick serving N requests of one signature costs
one launch, and a structurally repeated tick replays with zero Python
re-splitting and zero list builds (the drain memo's stacked key is
independent of the exact N inside a bucket).

Failure model (DESIGN.md §10): a failing drain never unwinds the serving
loop.  A chunk whose drain raises is BISECTED — log2 re-drains over pow2
halves (which replay from the drain memo's bucket programs) isolate the
poisoned request(s); healthy requests resolve in the same tick, only the
culprits fail, with a typed error (``DrainError``/``NumericalError``) on
their futures.  Transient failures consume a bounded per-request retry
budget with exponential tick backoff.  ``check_finite=True`` additionally
validates result lanes after every successful drain (one fused reduce over
the shared stacked epoch grid — no per-request de-grid), failing exactly
the non-finite lanes with ``NumericalError``.  Requests carry optional
deadlines (expired requests fail with ``DeadlineExceeded`` WITHOUT being
drained), and ``max_pending`` bounds the queue with explicit overload
shedding (``RejectedError``; reject-new or drop-oldest policy).

Async drain overlap (DESIGN.md §12): with ``overlap=True`` (the default)
``tick()`` is a pipeline — every bucket's stacked launch list is LAUNCHED
back-to-back with no device fence in between (CUDA launches are
asynchronous), ``check_finite`` reduces are issued eagerly per epoch but
read back only in a deferred validation pass at end-of-tick, and an
in-flight failure (a list that launched but failed before its results
were fenced) is contained exactly like a synchronous one: memo
invalidation via the drain handle, pristine-input rebuild, bisect
isolation, typed ``InflightError`` with the normal retry budget.
``overlap=False`` pins the fence-per-bucket behaviour (the A/B baseline).

Fences: a tick without ``check_finite`` never blocks on the card.  Request
ingest copies host inputs through pinned memory without blocking
(``core.data.host_to_device``), and nothing on the drain path reads a
device value back; the deferred probe read-back and the watchdog's poll
are the only host waits, and both are counted in ``host_idle_us``.

The generic surface is ``submit(op_name, arrays, ...)`` for any registered
Operation; ``lu``, ``lu_solve``, and ``cholesky`` are typed conveniences
that attach the right partitions and result extraction.
"""

from __future__ import annotations

import itertools
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import Dispatcher, GData, GTask
from ..core.data import resolve_device
from ..core.dispatcher import DrainHandle
from ..core.executors import drain_memo_pressure
from ..core.executors.sharded import mesh_device
from ..core.operation import OpRegistry
from ..errors import (
    CircuitOpenError,
    DeadlineExceeded,
    DrainError,
    DrainStalledError,
    InflightError,
    NumericalError,
    RejectedError,
    ResourceExhausted,
    ScheduleVerificationError,
    ServeError,
)
from ..linalg.cholesky import lower
from ..linalg.lu import _column, _unpack
from ..testing import faults

_rid = itertools.count()

#: errors a retry cannot fix — deterministic reproductions (NumericalError,
#: ScheduleVerificationError, single-request ResourceExhausted), already-
#: decided outcomes (DeadlineExceeded, RejectedError), or failures whose
#: retry would race live device state (DrainStalledError: the hung
#: computation still owns its resources, DESIGN.md §14) — failing fast
#: beats burning the retry budget on them
_NON_RETRYABLE = (
    NumericalError,
    DeadlineExceeded,
    RejectedError,
    ScheduleVerificationError,
    DrainStalledError,
    ResourceExhausted,
)


def _is_oom(e: BaseException) -> bool:
    """True iff ``e`` is a device out-of-memory failure: our typed
    ``ResourceExhausted`` (injected or pre-wrapped), PyTorch's
    ``torch.cuda.OutOfMemoryError`` (raised when a stacked grid or a
    gather-path stack is allocated, before or between launches), or a
    runtime error whose text says so."""
    if isinstance(e, (ResourceExhausted, torch.cuda.OutOfMemoryError)):
        return True
    s = str(e)
    return "RESOURCE_EXHAUSTED" in s or "out of memory" in s.lower()


class ServeFuture:
    """Per-request result handle: resolved at tick time, materialized lazily.

    ``result()`` raises if the request has not been drained yet (call
    ``BatchServer.tick()`` first) and re-raises the typed ``ServeError`` if
    the request failed; ``exception()`` mirrors ``concurrent.futures``:
    the error for a failed request, ``None`` for a resolved one.
    Extraction is lazy: resolving stores a thunk over the request's data
    handles, so a tick never pays per-request de-grid work for results
    nobody reads.
    """

    def __init__(self, rid: int, signature: tuple):
        self.rid = rid
        self.signature = signature
        self._thunk: Optional[Callable[[], Any]] = None
        self._error: Optional[BaseException] = None
        self._value: Any = None
        self._materialized = False

    @property
    def done(self) -> bool:
        return self._thunk is not None or self._error is not None

    def _resolve(self, thunk: Callable[[], Any]) -> None:
        if not self.done:
            self._thunk = thunk

    def _fail(self, error: BaseException) -> None:
        if not self.done:
            self._error = error

    def _pending_error(self) -> RuntimeError:
        op = self.signature[1] if len(self.signature) > 1 else "?"
        return RuntimeError(
            f"request rid={self.rid} (op={op!r}, graph={self.signature[0]!r}) "
            f"is not drained yet — call BatchServer.tick() to serve it"
        )

    def result(self) -> Any:
        if self._error is not None:
            raise self._error
        if self._thunk is None:
            raise self._pending_error()
        if not self._materialized:
            self._value = self._thunk()
            self._materialized = True
            self._thunk = lambda: self._value
        return self._value

    def exception(self) -> Optional[BaseException]:
        """The request's error (a ``ServeError`` subtype), or ``None`` if
        it resolved successfully.  Raises the pending ``RuntimeError`` if
        the request has not been drained yet."""
        if not self.done:
            raise self._pending_error()
        return self._error


@dataclass
class _Pending:
    future: ServeFuture
    op: object
    datas: List[GData]
    extract: Callable[[List[GData]], Any]
    # pristine inputs, kept so a retry can rebuild ``datas`` from scratch —
    # a failed drain may have partially overwritten the in-place results
    # (DESIGN.md §10).  These are the ingested root tensors: no kernel
    # writes into them (grids are fresh copies, GView.set and the fallback
    # path copy before writing), and none is a view of a grid
    arrays: List[torch.Tensor] = field(default_factory=list)
    parts: List[tuple] = field(default_factory=list)
    enqueue_t: float = 0.0
    deadline: Optional[float] = None  # absolute clock time, or None
    retries_left: int = 0
    attempts: int = 0  # failed drain attempts so far
    not_before: int = 0  # earliest tick number eligible (retry backoff)

    def rebuild_datas(self) -> None:
        self.datas = [
            GData(tuple(a.shape), partitions=p, dtype=a.dtype, value=a, device=a.device)
            for a, p in zip(self.arrays, self.parts)
        ]


@dataclass
class TickReport:
    """What one ``tick()`` did, per signature bucket and in total."""

    requests: int = 0  # completed this tick: resolved + failed + expired
    buckets: int = 0
    drains: int = 0
    launches: int = 0
    compiles: int = 0
    stacked_drains: int = 0
    memo_hits: int = 0
    memo_misses: int = 0
    per_bucket: List[dict] = field(default_factory=list)
    # failure/latency accounting (DESIGN.md §10)
    resolved: int = 0
    failed: int = 0
    expired: int = 0
    retried: int = 0
    bisected: int = 0  # failed chunks that entered bisection
    pending_after: int = 0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    # pipeline accounting (DESIGN.md §12)
    host_idle_us: float = 0.0  # host time blocked on the card (probes, watchdog)
    overlap_ratio: float = 1.0  # 1 - host_idle / tick wall time
    # self-healing accounting (DESIGN.md §14)
    breaker_state: str = "closed"  # worst across buckets after this tick
    breaker_trips: int = 0  # breakers that tripped OPEN this tick
    breaker_closes: int = 0  # breakers that re-CLOSED this tick
    breaker_fast_fails: int = 0  # queued requests failed fast (open bucket)
    watchdog_fires: int = 0  # chunks stalled past the watchdog budget
    oom_events: int = 0  # device-OOM launches (each halves a bucket cap)
    degraded_buckets: int = 0  # buckets below full max_batch after this tick
    health: str = "HEALTHY"  # server health after this tick


@dataclass
class _Launched:
    """One launched-but-unresolved chunk in the tick pipeline
    (DESIGN.md §12): its launch lists are in flight, its ``check_finite``
    probes (if any) are issued, nothing has been read back."""

    sig: tuple
    chunk: List[_Pending]
    dispatcher: Dispatcher
    handle: DrainHandle
    probes: Optional[List[list]]  # per member: [(device probe, lane|None)]


#: breaker state ordering for the tick report's worst-across-buckets field
_BREAKER_SEVERITY = {"closed": 0, "half_open": 1, "open": 2}


@dataclass
class _Breaker:
    """Per-signature circuit breaker (DESIGN.md §14).

    ``failures`` counts consecutive isolated drain failures for the bucket;
    ANY successful chunk resets it, so bisecting a single poisoned request
    out of a healthy chunk (successes interleave with the failing halves)
    never trips the breaker — only a bucket that keeps failing does.
    """

    state: str = "closed"  # closed | open | half_open
    failures: int = 0  # consecutive failures (successes reset)
    opened_tick: int = -1  # tick the breaker last tripped OPEN
    round_trips: int = 0  # completed open -> half_open -> closed cycles


@dataclass
class _Degrade:
    """Per-signature degradation level under memory pressure (DESIGN.md
    §14): the bucket's effective batch cap is ``max_batch >> level``.
    ``healthy`` counts OOM-free chunk drains since the last OOM; every
    ``degrade_recovery`` of them steps the level back down one."""

    level: int = 0
    healthy: int = 0


class BatchServer:
    """Queue -> signature buckets -> one stacked drain per bucket per tick.

    ``max_batch`` caps one drain's batch (requests beyond it drain as
    additional chunks in the same tick); it must be a power of two so full
    chunks match launch-list buckets exactly (a 48-cap would pad
    every full chunk to the 64 bucket — 33% junk lanes forever).

    ``max_pending`` bounds the queue: once reached, ``submit`` sheds per
    ``overload_policy`` — "reject" fails the NEW request's future with
    ``RejectedError``; "drop_oldest" evicts the oldest queued request
    (failing ITS future) and admits the new one.  ``max_retries`` is the
    default per-request retry budget for transient drain failures;
    ``retry_backoff`` scales the exponential tick backoff between
    attempts.  ``check_finite=True`` validates result lanes after every
    drain (NumericalError on the poisoned lanes only).  ``clock`` is
    injectable for deterministic deadline tests.

    ``overlap=True`` (default) pipelines the tick (DESIGN.md §12): all
    bucket launch lists run back-to-back and validation is deferred to
    end-of-tick, so the device is never idle between buckets;
    ``overlap=False`` fences each bucket before launching the next — bit-
    identical results, the interleaved-A/B baseline.  ``latency_window``
    bounds the rolling latency history (a ring buffer, so a long-running
    server's percentile cost stays O(window), not O(lifetime)).

    Self-healing (DESIGN.md §14): ``breaker_threshold`` consecutive
    isolated drain failures trip a signature bucket's circuit breaker OPEN
    (queued + incoming requests of that signature fail fast with
    ``CircuitOpenError``); after ``breaker_cooldown`` ticks the breaker
    half-opens and a single probe request decides re-close vs re-open.
    ``watchdog_s`` arms the hung-drain watchdog: a chunk whose fence is
    not ready within the budget fails its futures with
    ``DrainStalledError`` (memo invalidated, no retry — the hung
    computation still owns its device resources).  Device OOM on a launch
    halves the bucket's effective batch cap, sheds drain-memo entries,
    and re-drains split halves; ``degrade_recovery`` OOM-free drains step
    the cap back up.  ``retry_jitter_seed`` arms deterministic full-jitter
    on the retry backoff.  ``health()`` reports HEALTHY / DEGRADED /
    DRAINING; ``drain()`` flushes the queue and rejects new submits.

    ``device`` is where requests are ingested and drained: CUDA unless the
    caller names another (``device="cpu"`` runs the kernels' plain
    versions); without CUDA the default raises, it never falls back.
    ``mesh`` (a ``torch.distributed`` ``DeviceMesh``) serves the distributed
    graphs: requests go on the mesh's device, and their drains are never
    stacked.
    """

    def __init__(
        self,
        graph: str = "g2",
        mesh=None,
        max_batch: int = 64,
        max_pending: Optional[int] = None,
        overload_policy: str = "reject",
        max_retries: int = 1,
        retry_backoff: int = 1,
        check_finite: bool = False,
        overlap: bool = True,
        latency_window: int = 4096,
        clock: Callable[[], float] = time.monotonic,
        retry_jitter_seed: Optional[int] = None,
        watchdog_s: Optional[float] = None,
        breaker_threshold: int = 5,
        breaker_cooldown: int = 3,
        degrade_recovery: int = 8,
        device=None,
    ):
        self.device = resolve_device(mesh_device(mesh, device))
        if max_batch < 1 or max_batch & (max_batch - 1):
            raise ValueError(
                f"max_batch must be a power of two >= 1, got {max_batch}"
            )
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if overload_policy not in ("reject", "drop_oldest"):
            raise ValueError(
                f"overload_policy must be 'reject' or 'drop_oldest', "
                f"got {overload_policy!r}"
            )
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if retry_backoff < 1:
            raise ValueError(f"retry_backoff must be >= 1, got {retry_backoff}")
        if latency_window < 1:
            raise ValueError(
                f"latency_window must be >= 1, got {latency_window}"
            )
        if watchdog_s is not None and watchdog_s <= 0:
            raise ValueError(f"watchdog_s must be > 0, got {watchdog_s}")
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}"
            )
        if breaker_cooldown < 1:
            raise ValueError(
                f"breaker_cooldown must be >= 1, got {breaker_cooldown}"
            )
        if degrade_recovery < 1:
            raise ValueError(
                f"degrade_recovery must be >= 1, got {degrade_recovery}"
            )
        self.graph = graph
        self.mesh = mesh
        self.max_batch = max_batch
        self.max_pending = max_pending
        self.overload_policy = overload_policy
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.check_finite = check_finite
        self.overlap = bool(overlap)
        self._clock = clock
        # self-healing policy + state (DESIGN.md §14)
        self.watchdog_s = watchdog_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.degrade_recovery = degrade_recovery
        # full-jitter on the exponential retry backoff: None keeps the
        # deterministic schedule; a seed draws each delay uniformly from
        # [1, cap] so synchronized bucket retries don't stampede a
        # recovering device — seedable, hence reproducible in tests
        self._jitter_rng = (
            None if retry_jitter_seed is None else random.Random(retry_jitter_seed)
        )
        self._breakers: Dict[tuple, _Breaker] = {}
        self._degraded: Dict[tuple, _Degrade] = {}
        self._draining = False
        self._queues: Dict[tuple, List[_Pending]] = {}
        # rolling window of resolved-request latencies (ms) for p50/p99 —
        # a bounded ring buffer, NOT an unbounded list (a long-running
        # server would otherwise leak one float per resolved request)
        self._latencies: deque = deque(maxlen=latency_window)
        self._tick_lat: List[float] = []  # this tick's resolved latencies
        self.stats: Dict[str, int] = {
            "requests": 0,
            "ticks": 0,
            "drains": 0,
            "launches": 0,
            "compiles": 0,
            "memo_hits": 0,
            "memo_misses": 0,
            "stacked_drains": 0,
            "resolved": 0,
            "failed": 0,
            "expired": 0,
            "retried": 0,
            "shed": 0,
            "bisected": 0,
            "host_idle_us": 0,
            "breaker_trips": 0,
            "breaker_closes": 0,
            "breaker_fast_fails": 0,
            "watchdog_fires": 0,
            "oom_events": 0,
        }

    # -- request surface -------------------------------------------------------
    def submit(
        self,
        op_name: str,
        arrays: Sequence[Any],
        partitions: Sequence[Tuple[Tuple[int, int], ...]],
        extract: Optional[Callable[[List[GData]], Any]] = None,
        *,
        deadline: Optional[float] = None,
        max_retries: Optional[int] = None,
    ) -> ServeFuture:
        """Queue one request: ``op_name`` applied to ``arrays`` (one root
        task).  ``partitions`` gives each argument's partition levels;
        ``extract(datas)`` builds the result from the drained data handles
        (default: the last argument's value — the written-in-place result
        convention of the linalg families).

        ``deadline`` is seconds from now: a request still queued when it
        expires fails with ``DeadlineExceeded`` instead of being drained.
        ``max_retries`` overrides the server's transient-failure retry
        budget for this request.  Under overload (``max_pending`` reached)
        the request may be shed: the returned future then already carries
        ``RejectedError`` (policy "reject"), or the oldest queued request
        is evicted to make room (policy "drop_oldest")."""
        op = OpRegistry.get(op_name)
        if len(arrays) != len(partitions):
            raise ValueError(
                f"{len(arrays)} arrays vs {len(partitions)} partition specs"
            )
        datas = [
            GData(
                tuple(a.shape),
                partitions=parts,
                dtype=a.dtype if torch.is_tensor(a) else torch.float32,
                value=a,
                device=self.device,
            )
            for a, parts in zip(arrays, partitions)
        ]
        sig = (
            self.graph,
            op.name,
            tuple(
                (d.shape, str(d.dtype), tuple(d.partitions))
                for d in datas
            ),
        )
        fut = ServeFuture(next(_rid), sig)
        self.stats["requests"] += 1
        if self._draining:
            fut._fail(
                RejectedError(
                    f"request rid={fut.rid} rejected: server is draining "
                    f"(graceful shutdown in progress)"
                )
            )
            return fut
        br = self._breakers.get(sig)
        if br is not None and br.state == "open":
            self.stats["breaker_fast_fails"] += 1
            fut._fail(
                CircuitOpenError(
                    f"request rid={fut.rid} ({op.name}): signature bucket "
                    f"circuit-broken after {br.failures} consecutive drain "
                    f"failures; half-opens {self.breaker_cooldown} tick(s) "
                    f"after trip"
                )
            )
            return fut
        if self.max_pending is not None and self.pending() >= self.max_pending:
            if not self._shed_for(fut):
                return fut  # rejected: future already failed
        if extract is None:
            extract = lambda ds: ds[-1].value
        now = self._clock()
        self._queues.setdefault(sig, []).append(
            _Pending(
                fut,
                op,
                datas,
                extract,
                arrays=[d.value for d in datas],
                parts=[d.partitions for d in datas],
                enqueue_t=now,
                deadline=None if deadline is None else now + deadline,
                retries_left=(
                    self.max_retries if max_retries is None else max_retries
                ),
            )
        )
        return fut

    def _shed_for(self, fut: ServeFuture) -> bool:
        """Apply the overload policy; returns True if ``fut`` may enqueue."""
        self.stats["shed"] += 1
        if self.overload_policy == "reject":
            fut._fail(
                RejectedError(
                    f"request rid={fut.rid} rejected: queue at max_pending="
                    f"{self.max_pending} (policy 'reject')"
                )
            )
            return False
        # drop_oldest: evict the globally oldest queued request (min rid —
        # rids are assigned in submission order) and admit the new one
        sig = min(
            (q[0].future.rid, s) for s, q in self._queues.items() if q
        )[1]
        victim = self._queues[sig].pop(0)
        if not self._queues[sig]:
            del self._queues[sig]
        victim.future._fail(
            RejectedError(
                f"request rid={victim.future.rid} dropped: queue at "
                f"max_pending={self.max_pending} (policy 'drop_oldest')"
            )
        )
        return True

    def lu(
        self,
        a,
        partitions: Tuple[Tuple[int, int], ...] = ((4, 4),),
        **kw,
    ) -> ServeFuture:
        """Queue a pivot-free LU; resolves to (L, U) unpacked."""
        return self.submit(
            "getrf", [a], [partitions], extract=lambda ds: _unpack(ds[0].value), **kw
        )

    def cholesky(
        self,
        a,
        partitions: Tuple[Tuple[int, int], ...] = ((4, 4),),
        **kw,
    ) -> ServeFuture:
        """Queue a Cholesky factorization; resolves to the lower factor."""
        return self.submit(
            "potrf",
            [a],
            [partitions],
            extract=lambda ds: lower(ds[0].value),
            **kw,
        )

    def lu_solve(
        self,
        a,
        b,
        partitions: Tuple[Tuple[int, int], ...] = ((4, 4),),
        b_partitions: Tuple[Tuple[int, int], ...] = None,
        **kw,
    ) -> ServeFuture:
        """Queue ``a @ x == b`` (composed factor+solve, one root task);
        resolves to x.  ``b`` may be a vector or a matrix, as in
        ``run_lu_solve``."""
        if b.shape[0] != a.shape[0]:
            raise ValueError(
                f"shape mismatch: a {tuple(a.shape)} vs b {tuple(b.shape)}"
            )
        vec = b.ndim == 1
        b2 = b[:, None] if vec else b
        if b_partitions is None:
            b_partitions = tuple(
                (pr, 1 if vec else pc) for pr, pc in partitions
            )
        extract = (
            (lambda ds: _column(ds[1].value)) if vec else (lambda ds: ds[1].value)
        )
        return self.submit(
            "lu_solve", [a, b2], [partitions, b_partitions], extract=extract,
            **kw,
        )

    # -- serving loop ----------------------------------------------------------
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p99 (ms) over the rolling resolved-request latency window."""
        if not self._latencies:
            return {"p50_ms": 0.0, "p99_ms": 0.0, "samples": 0}
        arr = np.asarray(self._latencies)
        return {
            "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99)),
            "samples": len(arr),
        }

    def tick(self) -> TickReport:
        """Drain every eligible queued request: one stacked drain per
        signature bucket (chunked at ``max_batch``), resolve the futures.

        Pipelined (DESIGN.md §12): launch-all-buckets, deferred-validate,
        resolve.  With ``overlap`` on, every chunk's launch list (and its
        eagerly issued ``check_finite`` probes) is launched before ANY
        result is read back; the single deferred-validation pass at the
        end of the tick is the only point the host may block, and only
        when ``check_finite`` needs the probe values.  With ``overlap``
        off each chunk is finalized (fenced) before the next launches.

        Failure containment (DESIGN.md §10): the serving loop never
        unwinds.  Deadline-expired requests fail with ``DeadlineExceeded``
        without draining; a chunk whose drain raises is bisected to
        isolate the culprits (healthy requests resolve in this same tick);
        isolated transient failures consume the request's retry budget and
        re-queue IN FIFO ORDER with exponential tick backoff, carrying
        their retry count; exhausted or deterministic failures land on the
        future as a typed ``ServeError``.  In-flight failures (overlap on,
        after dispatch) follow the same path with ``InflightError`` and
        drain-memo invalidation — identical semantics, deferred detection."""
        tick_no = self.stats["ticks"]
        self.stats["ticks"] += 1
        t_tick = time.perf_counter()
        now = self._clock()
        report = TickReport()
        self._tick_lat = []
        # breaker cooldown sweep: an OPEN breaker whose cooldown has
        # elapsed half-opens — one probe request (below) decides its fate
        for br in self._breakers.values():
            if (
                br.state == "open"
                and tick_no >= br.opened_tick + self.breaker_cooldown
            ):
                br.state = "half_open"
        queues, self._queues = self._queues, {}
        held: Dict[tuple, List[_Pending]] = {}
        ready: Dict[tuple, List[_Pending]] = {}
        for sig, pend in queues.items():
            br = self._breakers.get(sig)
            if br is not None and br.state == "open":
                # fail-fast the whole bucket: no drain, no retry budget
                for p in pend:
                    report.breaker_fast_fails += 1
                    self._finish_fail(
                        p,
                        CircuitOpenError(
                            f"request rid={p.future.rid} ({p.op.name}): "
                            f"signature bucket circuit-broken"
                        ),
                        report,
                    )
                continue
            probe_taken = False
            for p in pend:
                if p.deadline is not None and now >= p.deadline:
                    self._finish_fail(
                        p,
                        DeadlineExceeded(
                            f"request rid={p.future.rid} ({p.op.name}) "
                            f"deadline expired before drain"
                        ),
                        report,
                        expired=True,
                    )
                elif p.not_before > tick_no:
                    held.setdefault(sig, []).append(p)  # retry backoff
                elif br is not None and br.state == "half_open" and probe_taken:
                    held.setdefault(sig, []).append(p)  # behind the probe
                else:
                    ready.setdefault(sig, []).append(p)
                    probe_taken = True  # half-open: FIRST ready = the probe
        report.buckets = len(ready)
        retried: Dict[tuple, List[_Pending]] = {}
        # phase 1 — launch: every chunk's launch list runs back-to-back;
        # with overlap on, no device fence separates the launches
        launched: Optional[List[_Launched]] = [] if self.overlap else None
        for sig, pend in ready.items():
            cap = self._bucket_cap(sig)  # degraded buckets drain smaller
            for lo in range(0, len(pend), cap):
                self._launch_chunk(
                    sig, pend[lo : lo + cap], report, retried,
                    tick_no, launched,
                )
        # phase 2/3 — deferred-validate + resolve (end-of-tick): the only
        # point this tick may block on the device, and only for probes
        if launched:
            for item in launched:
                self._finalize_chunk(item, report, retried, tick_no)
        # re-queue held + retried requests at the FRONT of their buckets,
        # merged by rid (== global FIFO submission order): they are older
        # than anything submitted after this tick
        for sig in set(held) | set(retried):
            front = sorted(
                held.get(sig, []) + retried.get(sig, []),
                key=lambda p: p.future.rid,
            )
            self._queues[sig] = front + self._queues.get(sig, [])
        report.pending_after = self.pending()
        if self._tick_lat:
            arr = np.asarray(self._tick_lat)
            report.p50_ms = float(np.percentile(arr, 50))
            report.p99_ms = float(np.percentile(arr, 99))
        wall = time.perf_counter() - t_tick
        if wall > 0:
            report.overlap_ratio = max(
                0.0, 1.0 - report.host_idle_us / (wall * 1e6)
            )
        report.degraded_buckets = sum(
            1 for deg in self._degraded.values() if deg.level > 0
        )
        report.breaker_state = max(
            (br.state for br in self._breakers.values()),
            key=_BREAKER_SEVERITY.__getitem__,
            default="closed",
        )
        report.health = self.health()
        for k in (
            "drains",
            "launches",
            "compiles",
            "memo_hits",
            "memo_misses",
            "stacked_drains",
            "resolved",
            "failed",
            "expired",
            "retried",
            "bisected",
            "breaker_trips",
            "breaker_closes",
            "breaker_fast_fails",
            "watchdog_fires",
            "oom_events",
        ):
            self.stats[k] += getattr(report, k)
        self.stats["host_idle_us"] += int(report.host_idle_us)
        return report

    # -- chunk serving with lane isolation (DESIGN.md §10, §12) ----------------
    def _launch_chunk(
        self,
        sig: tuple,
        chunk: List[_Pending],
        report: TickReport,
        retried: Dict[tuple, List[_Pending]],
        tick_no: int,
        launched: Optional[List[_Launched]],
    ) -> None:
        """Dispatch one chunk's drain (and its deferred-validation probes).

        With ``launched`` a list (overlap on) the chunk joins the tick
        pipeline and is finalized at end-of-tick; with ``launched=None``
        it is finalized — fenced and resolved — immediately."""
        try:
            d, handle = self._drain_chunk(chunk)
        except Exception as e:  # noqa: BLE001 — typed at the future boundary
            if _is_oom(e):
                # pressure, not poison (DESIGN.md §14): halve the bucket's
                # cap, shed memo entries, and re-drain as split halves —
                # no retry budget consumed, no breaker failure noted
                self._oom_degrade(sig, report)
                if len(chunk) > 1:
                    mid = len(chunk) // 2
                    self._launch_chunk(
                        sig, chunk[:mid], report, retried, tick_no, launched
                    )
                    self._launch_chunk(
                        sig, chunk[mid:], report, retried, tick_no, launched
                    )
                    return
                # a SINGLE request that still OOMs reproduces at any size:
                # typed terminal failure, never retried
                p = chunk[0]
                if isinstance(e, ResourceExhausted):
                    err = e
                else:
                    err = ResourceExhausted(
                        f"request rid={p.future.rid} ({p.op.name}) OOMs "
                        f"even as a singleton drain: {e}"
                    )
                    err.__cause__ = e
                self._finish_fail(p, err, report)
                return
            if len(chunk) == 1:
                self._fail_or_retry(sig, chunk[0], e, report, retried, tick_no)
                return
            # bisect: pow2 halves hit the drain memo's bucket programs, so
            # isolating k culprits in a chunk of C costs O(k log C) cheap
            # re-drains, not C singleton drains
            report.bisected += 1
            mid = len(chunk) // 2
            self._launch_chunk(
                sig, chunk[:mid], report, retried, tick_no, launched
            )
            self._launch_chunk(
                sig, chunk[mid:], report, retried, tick_no, launched
            )
            return
        probes = (
            self._dispatch_finite_probes(chunk) if self.check_finite else None
        )
        item = _Launched(sig, chunk, d, handle, probes)
        if launched is not None:
            launched.append(item)
        else:
            self._finalize_chunk(item, report, retried, tick_no)

    def _finalize_chunk(
        self,
        item: _Launched,
        report: TickReport,
        retried: Dict[tuple, List[_Pending]],
        tick_no: int,
    ) -> None:
        """Deferred-validate and resolve one launched chunk.

        The ONLY blocking step of a tick: reading back the ``check_finite``
        probe values (skipped entirely when validation is off — resolution
        is then fence-free and results stay lazy on their futures).  A
        failure here is an IN-FLIGHT failure (DESIGN.md §12): the kernels
        were launched, so every member's data is suspect — the drain
        handle's memo entries are invalidated, members rebuild from their
        pristine inputs, and isolation proceeds by synchronous
        (immediately finalized) half re-drains, typed ``InflightError`` at
        the single-request leaf."""
        chunk = item.chunk
        if self.watchdog_s is not None and not self._watchdog_fence(
            item, report, retried, tick_no
        ):
            return  # stalled: futures failed, memo invalidated
        try:
            faults.fire(
                "drain.inflight",
                rids=[p.future.rid for p in chunk],
                op=chunk[0].op.name,
                size=len(chunk),
                pending=not item.handle.is_ready(),
            )
            bad = (
                self._materialize_probes(item.probes, report)
                if item.probes is not None
                else ()
            )
        except Exception as e:  # noqa: BLE001 — typed at the future boundary
            item.handle.invalidate_memo()
            if len(chunk) == 1:
                self._fail_or_retry(
                    item.sig, chunk[0], e, report, retried, tick_no,
                    wrap=InflightError,
                )
                return
            report.bisected += 1
            for p in chunk:
                p.rebuild_datas()
            mid = len(chunk) // 2
            self._launch_chunk(
                item.sig, chunk[:mid], report, retried, tick_no, None
            )
            self._launch_chunk(
                item.sig, chunk[mid:], report, retried, tick_no, None
            )
            return
        self._note_chunk_success(item.sig, report)
        now = self._clock()
        for i, p in enumerate(chunk):
            if i in bad:
                self._finish_fail(
                    p,
                    NumericalError(
                        f"request rid={p.future.rid} ({p.op.name}): "
                        f"non-finite values in result lane"
                    ),
                    report,
                )
                continue
            datas, extract = p.datas, p.extract
            p.future._resolve(lambda ds=datas, ex=extract: ex(ds))
            report.resolved += 1
            report.requests += 1
            self._record_latency((now - p.enqueue_t) * 1e3)
        d = item.dispatcher
        est = d.executor.stats
        bucket_stats = {
            "signature": item.sig[1],
            "requests": len(chunk),
            "launches": int(est.get("launches", 0)),
            "compiles": int(est.get("compiles", 0)),
            "stacked": int(d.stats["stacked_drains"]),
            "memo_hits": int(d.stats["memo_hits"]),
            "memo_misses": int(d.stats["memo_misses"]),
        }
        report.per_bucket.append(bucket_stats)
        report.drains += 1
        report.launches += bucket_stats["launches"]
        report.compiles += bucket_stats["compiles"]
        report.stacked_drains += bucket_stats["stacked"]
        report.memo_hits += bucket_stats["memo_hits"]
        report.memo_misses += bucket_stats["memo_misses"]

    def _drain_chunk(
        self, chunk: List[_Pending]
    ) -> Tuple[Dispatcher, DrainHandle]:
        faults.fire(
            "serve.drain",
            rids=[p.future.rid for p in chunk],
            op=chunk[0].op.name,
            size=len(chunk),
        )
        d = Dispatcher(graph=self.graph, mesh=self.mesh)
        for p in chunk:
            d.submit_task(
                GTask(p.op, None, [dd.root_view() for dd in p.datas])
            )
        return d, d.run_async()

    def _dispatch_finite_probes(self, chunk: List[_Pending]) -> List[list]:
        """Issue (without blocking) the chunk's finiteness reduces.

        Lane-isolated and cheap: members of a stacked drain share one
        ``StackedEpoch``, so finiteness is ONE reduction over the
        ``(B, nr, nc, br, bc)`` epoch grid yielding a per-lane mask —
        nothing is de-gridded, healthy lanes stay lazily extracted.  The
        reduces are issued IMMEDIATELY after the chunk's own launch
        (before any later drain could run in place on this epoch's grid,
        DESIGN.md §12) but read back only at the deferred-validation
        fence in ``_finalize_chunk``."""
        epoch_probes: Dict[int, torch.Tensor] = {}
        probes: List[list] = []
        for p in chunk:
            member = []
            for dd in p.datas:
                lane = dd.lane
                if lane is not None:
                    ep, li = lane
                    probe = epoch_probes.get(id(ep))
                    if probe is None:
                        probe = torch.isfinite(ep.grid).flatten(1).all(1)
                        epoch_probes[id(ep)] = probe
                    member.append((probe, li))
                elif dd.in_grid_epoch:
                    member.append((torch.isfinite(dd.grid).all(), None))
                elif dd.has_value:
                    member.append((torch.isfinite(dd.value).all(), None))
            probes.append(member)
        return probes

    def _materialize_probes(
        self, probes: List[list], report: TickReport
    ) -> set:
        """Block on the deferred finiteness probes; returns the indices of
        chunk members with any non-finite result datum.  The blocked time
        is the tick's ``host_idle_us`` contribution — with overlap on it is
        paid ONCE, after every bucket has launched, instead of between
        buckets.  Device-side execution failures surface here (the probes
        depend on the kernels' outputs), which is exactly the in-flight
        failure path of ``_finalize_chunk``."""
        t0 = time.perf_counter()
        host: Dict[int, np.ndarray] = {}
        bad = set()
        for i, member in enumerate(probes):
            for probe, li in member:
                arr = host.get(id(probe))
                if arr is None:
                    arr = probe.cpu().numpy()
                    host[id(probe)] = arr
                ok = bool(arr[li]) if li is not None else bool(arr)
                if not ok:
                    bad.add(i)
                    break
        report.host_idle_us += (time.perf_counter() - t0) * 1e6
        return bad

    # -- self-healing: watchdog, breakers, degradation (DESIGN.md §14) ---------
    def _watchdog_fence(
        self,
        item: _Launched,
        report: TickReport,
        retried: Dict[tuple, List[_Pending]],
        tick_no: int,
    ) -> bool:
        """Bounded readiness fence over one launched chunk; True iff the
        chunk became ready within ``watchdog_s``.

        A CUDA event wait cannot be interrupted, so the budget is a
        polling deadline over ``handle.is_ready()``.  On timeout the
        drain's memo keys are invalidated (this execution can no longer
        vouch for them) and every member future fails with
        ``DrainStalledError`` — no bisect (the whole fence is stalled, not
        one request) and no retry (a re-drain would queue behind the very
        computation that stalled; only process restart reclaims the
        card, which is the honest limit of a host-side watchdog)."""
        chunk = item.chunk
        t0 = time.perf_counter()
        deadline = time.monotonic() + self.watchdog_s
        stalled = False
        try:
            # the stall site fires BEFORE the first readiness poll, so an
            # injected delay_s fault deterministically blows the budget
            faults.fire(
                "drain.stall",
                rids=[p.future.rid for p in chunk],
                op=chunk[0].op.name,
                size=len(chunk),
            )
            while not item.handle.is_ready():
                if time.monotonic() >= deadline:
                    stalled = True
                    break
                time.sleep(min(0.001, self.watchdog_s / 10))
            stalled = stalled or time.monotonic() >= deadline
        except Exception as e:  # noqa: BLE001 — a raising stall fault
            report.host_idle_us += (time.perf_counter() - t0) * 1e6
            item.handle.invalidate_memo()
            for p in chunk:
                self._fail_or_retry(
                    item.sig, p, e, report, retried, tick_no,
                    wrap=InflightError,
                )
            return False
        report.host_idle_us += (time.perf_counter() - t0) * 1e6
        if not stalled:
            return True
        report.watchdog_fires += 1
        item.handle.invalidate_memo()
        self._note_chunk_failure(item.sig, tick_no, report)
        for p in chunk:
            self._finish_fail(
                p,
                DrainStalledError(
                    f"request rid={p.future.rid} ({p.op.name}): drain fence "
                    f"not ready within the {self.watchdog_s:.3f}s watchdog "
                    f"budget ({len(chunk)}-request chunk)"
                ),
                report,
            )
        return False

    def _bucket_cap(self, sig: tuple) -> int:
        """The bucket's effective batch cap: ``max_batch`` halved once per
        degradation level (still a power of two), floored at 1."""
        deg = self._degraded.get(sig)
        if deg is None:
            return self.max_batch
        return max(1, self.max_batch >> deg.level)

    def _oom_degrade(self, sig: tuple, report: TickReport) -> None:
        """One device-OOM drain: halve the bucket's cap (until 1) and
        shed half the drain memo — launch lists for the old, larger
        chunk sizes are exactly the entries pressure wants back."""
        report.oom_events += 1
        deg = self._degraded.setdefault(sig, _Degrade())
        if (self.max_batch >> deg.level) > 1:
            deg.level += 1
        deg.healthy = 0
        drain_memo_pressure()

    def _note_chunk_failure(
        self, sig: tuple, tick_no: int, report: TickReport
    ) -> None:
        """Account one isolated drain failure against the bucket's breaker.

        Called at the single-request isolation leaf (and for a stalled
        chunk), NOT at every bisect level — so one poisoned request in a
        healthy chunk contributes one failure per tick, and its healthy
        bucket-mates' successes reset the count before it can accumulate.
        A failure during HALF_OPEN (the probe failed) re-trips immediately.
        """
        br = self._breakers.setdefault(sig, _Breaker())
        br.failures += 1
        if br.state == "half_open" or (
            br.state == "closed" and br.failures >= self.breaker_threshold
        ):
            br.state = "open"
            br.opened_tick = tick_no
            report.breaker_trips += 1

    def _note_chunk_success(self, sig: tuple, report: TickReport) -> None:
        """One chunk drained clean: reset the breaker's failure count
        (closing it if open/half-open — the probe succeeded) and advance
        the bucket's degradation recovery."""
        br = self._breakers.get(sig)
        if br is not None:
            br.failures = 0
            if br.state != "closed":
                br.state = "closed"
                br.round_trips += 1
                report.breaker_closes += 1
        deg = self._degraded.get(sig)
        if deg is not None:
            deg.healthy += 1
            if deg.healthy >= self.degrade_recovery:
                deg.level -= 1
                deg.healthy = 0
                if deg.level <= 0:
                    del self._degraded[sig]

    # -- health + graceful shutdown (DESIGN.md §14) ----------------------------
    def health(self) -> str:
        """Server health: DRAINING once ``drain()`` started, DEGRADED while
        any breaker is not closed or any bucket runs below its full batch
        cap, HEALTHY otherwise."""
        if self._draining:
            return "DRAINING"
        if any(br.state != "closed" for br in self._breakers.values()) or any(
            deg.level > 0 for deg in self._degraded.values()
        ):
            return "DEGRADED"
        return "HEALTHY"

    def breakers(self) -> Dict[tuple, Dict[str, Any]]:
        """Per-signature breaker snapshot (state, consecutive failures,
        completed open->closed round trips) for introspection and gates."""
        return {
            sig: {
                "state": br.state,
                "failures": br.failures,
                "round_trips": br.round_trips,
            }
            for sig, br in self._breakers.items()
        }

    def breaker_round_trips(self) -> int:
        """Total completed open -> half_open -> closed breaker cycles."""
        return sum(br.round_trips for br in self._breakers.values())

    def drain(self, max_ticks: int = 1024) -> List[TickReport]:
        """Graceful shutdown: reject all new submits, then tick until the
        queue (including backoff-held retries) is flushed.  Every queued
        future ends resolved or typed-failed.  ``max_ticks`` bounds the
        flush (a safety rail — retry budgets are finite, so the queue
        drains well before it); returns the per-tick reports."""
        self._draining = True
        reports: List[TickReport] = []
        while self.pending() and len(reports) < max_ticks:
            reports.append(self.tick())
        return reports

    def _fail_or_retry(
        self,
        sig: tuple,
        p: _Pending,
        e: Exception,
        report: TickReport,
        retried: Dict[tuple, List[_Pending]],
        tick_no: int,
        wrap: type = DrainError,
    ) -> None:
        """One isolated failing request: consume retry budget or fail typed.

        ``wrap`` types the terminal error for non-``ServeError`` causes:
        ``DrainError`` for synchronous drain failures, ``InflightError``
        when the failure surfaced at deferred (in-flight) resolution.
        Every call is one isolated drain failure, so it also feeds the
        bucket's breaker (DESIGN.md §14)."""
        self._note_chunk_failure(sig, tick_no, report)
        if not isinstance(e, _NON_RETRYABLE) and p.retries_left > 0:
            p.retries_left -= 1
            p.attempts += 1
            cap = self.retry_backoff * (2 ** (p.attempts - 1))
            # full jitter (armed via retry_jitter_seed): uniform in [1, cap]
            # instead of the deterministic cap, so a bucket's worth of
            # synchronized retries spreads across the backoff window
            delay = cap if self._jitter_rng is None else self._jitter_rng.randint(1, cap)
            p.not_before = tick_no + delay
            p.rebuild_datas()  # the failed drain may have mutated them
            retried.setdefault(sig, []).append(p)
            report.retried += 1
            return
        if isinstance(e, ServeError):
            err = e
        else:
            err = wrap(
                f"request rid={p.future.rid} ({p.op.name}) drain failed "
                f"after {p.attempts + 1} attempt(s): {e}"
            )
            err.__cause__ = e
        self._finish_fail(p, err, report)

    def _finish_fail(
        self,
        p: _Pending,
        err: ServeError,
        report: TickReport,
        expired: bool = False,
    ) -> None:
        p.future._fail(err)
        report.requests += 1
        if expired:
            report.expired += 1
        else:
            report.failed += 1

    def _record_latency(self, ms: float) -> None:
        # the rolling window is a maxlen deque: appends evict the oldest
        # sample in O(1), so a long-running server never accumulates
        self._latencies.append(ms)
        # per-tick percentiles over THIS tick's resolved set, tracked
        # separately (the rolling window may already have evicted part of
        # a large tick's own samples); ``tick`` takes their percentiles
        # once, at its end
        self._tick_lat.append(ms)
