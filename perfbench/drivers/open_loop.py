"""Independent users: requests offered to the program's request server on a
schedule, whatever it has answered (an open loop).

Traffic parameters: ``rate`` (requests a second), ``pool`` (distinct
matrices made on the device; each request draws one and brings its own
right-hand side) and ``max_batch`` (the server's cap).

The window holds rate x seconds arrivals, placed as a Poisson process
holding that many (sorted uniform times) drawn from ``ARRIVAL_SEED``:
every run offers the same arrivals, and the run's seed changes only the
inputs (the matrices, the right-hand sides and which matrix each request
draws), so seeds change the values of the work and not its amount or its
timing.  Set-up ends by serving the window's busiest ``WARM_S`` seconds of
arrivals on inputs of their own, so the allocator has grown to the load's
size before the window.  Each request is timed from when it was due to
when its answer was ready on the card: a device event after each tick,
placed on the host's clock once the run is over, so nothing waits on the
card to take the time.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable, List, Sequence

import numpy as np
import torch

from perfbench.record import Record
from perfbench.trace import profiled

POLL_S = 50e-6  # the loop's wait while it has nothing to do
WARMUP_ROUNDS = 2  # ticks at each lane count the server can reach, before the window
GRACE_S = 60.0  # serving goes on this long past the last arrival; what is left then has failed
# ticks the loop lets run on the card before it waits for the oldest: one
# runs while the host launches the next (the server's own pipelining), and
# the card's queue of launched work stays bounded instead of growing
# without end; a server loop that keeps the card fed and no more
MAX_INFLIGHT_TICKS = 2
ARRIVAL_SEED = 20260  # the arrivals' own stream: the same in every run
TRACE_S = 2.0  # arrivals in the profiled stretch of a --trace 1 run
WARM_S = 5.0  # the window's busiest stretch of arrivals, served once in set-up


def schedule(count: int, seconds: float, rng: np.random.Generator) -> List[float]:
    """``count`` arrival times in [0, seconds): a Poisson process on that
    interval conditioned on holding ``count`` arrivals."""
    return sorted(rng.uniform(0.0, seconds, count).tolist())


def busiest(due: Sequence[float], seconds: float) -> List[float]:
    """The arrivals of ``due`` (sorted) in its busiest stretch of
    ``seconds``, as times from that stretch's start."""
    best, j = (0, 0), 0
    for i in range(len(due)):
        while j < len(due) and due[j] < due[i] + seconds:
            j += 1
        if j - i > best[1] - best[0]:
            best = (i, j)
    lo, hi = best
    return [d - due[lo] for d in due[lo:hi]]


def drive(due: Sequence[float], submit: Callable[[int], None], tick: Callable[[], object],
          pending: Callable[[], int], ready: Callable[[object], bool], clock: Callable[[], float],
          wait: Callable[[float], None], max_inflight: int, grace_s: float) -> float:
    """Offer request k at ``start + due[k]`` (``submit(k)``), and tick
    whenever requests wait and fewer than ``max_inflight`` ticks are
    unfinished (``ready`` of a tick's event).  Runs until every request is
    offered and none waits, or ``grace_s`` past the last arrival.  Returns
    ``start``."""
    start = clock()
    end = start + (due[-1] if due else 0.0) + grace_s
    inflight: deque = deque()
    i = 0
    while i < len(due) or pending():
        now = clock()
        if now > end:
            break
        while i < len(due) and start + due[i] <= now:
            submit(i)
            i += 1
        while inflight and ready(inflight[0]):
            inflight.popleft()
        if pending() and len(inflight) < max_inflight:
            inflight.append(tick())
        elif i < len(due) and not pending():
            wait(max(0.0, min(start + due[i] - clock(), POLL_S)))
        else:
            wait(POLL_S)
    return start


def inputs(ctx) -> None:
    """The run's arrivals (the same for every seed: the window's, the
    profiled stretch's, and set-up's replay of the window's busiest
    stretch) and its inputs from its seed: the pool of matrices, a
    right-hand side a request, and which matrix each request draws."""
    t = ctx.traffic
    rng = np.random.default_rng(ARRIVAL_SEED)
    ctx.due = schedule(round(t["rate"] * ctx.seconds), ctx.seconds, rng)
    ctx.due_traced = schedule(round(t["rate"] * TRACE_S), TRACE_S, rng)
    ctx.due_warm = busiest(ctx.due, WARM_S)
    count = len(ctx.due) + len(ctx.due_traced) + len(ctx.due_warm)
    ctx.pool = None  # a pool made before (control.py makes one a seed) goes first
    ctx.pool = ctx.op.make_pool(ctx.cfg, t["pool"], ctx.generator(0), ctx.device)
    ctx.rhs = ctx.op.make_rhs(ctx.cfg, count, ctx.generator(1), ctx.device)
    ctx.picks = torch.randint(t["pool"], (count,), generator=ctx.generator(2, "cpu")).tolist()


def prepare(ctx) -> None:
    t = ctx.traffic
    inputs(ctx)
    ctx.srv, ctx.submit = ctx.op.server(ctx.cfg, t, ctx.device)
    warm = ctx.op.make_rhs(ctx.cfg, t["max_batch"], ctx.generator(3), ctx.device)
    lanes = 1
    while lanes <= t["max_batch"]:
        for _ in range(WARMUP_ROUNDS):
            futs = [ctx.submit(ctx.srv, ctx.pool[k % t["pool"]], warm[k]) for k in range(lanes)]
            ctx.srv.tick()
            for f in futs:
                f.result()
            ctx.dev.sync()
        lanes *= 2
    _serve(ctx, Record(), len(ctx.due) + len(ctx.due_traced), ctx.due_warm, [])


def _serve(ctx, rec: Record, first: int, due: Sequence[float], reports: list) -> dict:
    """Requests ``first + k`` due at ``due[k]`` through the server; returns
    each answered request's (due time, tick event)."""
    clock, dev, srv = ctx.clock, ctx.dev, ctx.srv
    futs, waiting, done, events = {}, [], {}, []

    def submit(k: int) -> None:
        t0 = clock()
        i = first + k
        futs[i] = (ctx.submit(srv, ctx.pool[ctx.picks[i]], ctx.rhs[i]), k)
        waiting.append(i)
        rec.host_request_s += clock() - t0

    def tick():
        t0 = clock()
        reports.append(srv.tick())
        still = []
        for i in waiting:
            f, k = futs[i]
            if not f.done:
                still.append(i)
                continue
            del futs[i]
            if f.exception() is None:
                rec.answers.append((ctx.picks[i], i, f.result()))
                done[i] = (k, len(events))
            else:
                ctx.errors.append(f"request {i}: {type(f.exception()).__name__}: {f.exception()}")
        waiting[:] = still
        events.append(dev.event())
        rec.host_request_s += clock() - t0
        return events[-1]

    start = drive(due, submit, tick, srv.pending, lambda ev: ev.query(), clock, time.sleep,
                  MAX_INFLIGHT_TICKS, GRACE_S)
    dev.sync()
    return {i: start + due[k] for i, (k, _) in done.items()}, {i: events[e] for i, (_, e) in done.items()}


def run(ctx, seconds: float, trace: bool) -> Record:
    rec = Record()
    reports: list = []
    ctx.dev.anchor()
    due_at, event_of = _serve(ctx, rec, 0, ctx.due, reports)
    n = len(ctx.due)
    ready = {i: ctx.dev.time_of(ev) for i, ev in event_of.items()}
    rec.latencies_ms = [(ready[i] - due_at[i]) * 1e3 if i in ready else math.inf for i in range(n)]
    rec.window_s = (max(ready.values()) - min(due_at.values())) if ready else 0.0
    rec.attempted = n
    rec.completed = len(ready)
    rec.failed = n - len(ready)
    rec.resolved = sum(r.resolved for r in reports)
    rec.drains = sum(r.drains for r in reports)
    if trace:
        host = rec.host_request_s
        (traced, _), rec.trace = profiled(lambda: _serve(ctx, rec, n, ctx.due_traced, []), ctx.device)
        rec.host_request_s = host
        rec.traced_answers = len(traced)
    return rec


def release(ctx) -> None:
    ctx.srv = ctx.submit = None
