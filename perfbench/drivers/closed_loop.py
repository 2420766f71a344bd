"""One client that calls the program's entry and waits for each answer
before the next (a closed loop).

Traffic parameter: ``pool`` (distinct matrices made on the device).  The
answers kept for the comparison are as many as fit in ``KEEP_BYTES``, and
a ``--trace 1`` run profiles the calls of ``TRACE_S`` seconds after the
window.
"""

from __future__ import annotations

import random

import torch

from perfbench.record import Record
from perfbench.trace import profiled

MAX_CALLS = 8192  # right-hand sides and picks made ahead; calls beyond reuse them
WARMUP_CALLS = 3  # before the window: the first drain (planning, capture), then replays
KEEP_BYTES = 10 << 28  # answers kept on the device for the comparison: every solve of a window, ten factors
TRACE_S = 0.25  # the profiled stretch of a --trace 1 run: calls until this has passed


class Keeper:
    """The answers kept for the comparison: the first, the last and a
    uniform sample drawn from ``seed`` of those between (reservoir sampling,
    so the window's length need not be known), as many in all as
    ``KEEP_BYTES`` holds of the first answer's size, and at least three."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.kept = []
        self.first = self.last = None
        self.sample = 0
        self.seen = 0

    def add(self, item) -> None:
        if self.first is None:
            self.first = item
            out = item[-1]
            self.sample = max(1, KEEP_BYTES // (out.numel() * out.element_size()) - 2)
            return
        if self.last is not None:
            if self.seen < self.sample:
                self.kept.append(self.last)
            else:
                j = self.rng.randrange(self.seen + 1)
                if j < self.sample:
                    self.kept[j] = self.last
            self.seen += 1
        self.last = item

    def items(self) -> list:
        return [x for x in (self.first, *self.kept, self.last) if x is not None]


def memo_hits() -> int:
    from repro_torch.core.executors import drain_memo_stats

    return drain_memo_stats()["hits"]


def inputs(ctx) -> None:
    """The run's inputs from its seed: the pool of matrices, the
    right-hand sides, and which matrix each call takes."""
    t = ctx.traffic
    ctx.pool = None  # a pool made before (control.py makes one a seed) goes first
    ctx.pool = ctx.op.make_pool(ctx.cfg, t["pool"], ctx.generator(0), ctx.device)
    ctx.rhs = ctx.op.make_rhs(ctx.cfg, MAX_CALLS, ctx.generator(1), ctx.device)
    ctx.picks = torch.randint(t["pool"], (MAX_CALLS,), generator=ctx.generator(2, "cpu")).tolist()


def prepare(ctx) -> None:
    t = ctx.traffic
    inputs(ctx)
    ctx.call = ctx.op.entry(ctx.cfg, ctx.device)
    warm = ctx.op.make_rhs(ctx.cfg, 1, ctx.generator(3), ctx.device)
    for k in range(WARMUP_CALLS):
        ctx.call(ctx.pool[k % t["pool"]], None if warm is None else warm[0])
        ctx.dev.sync()


def run(ctx, seconds: float, trace: bool) -> Record:
    clock, dev = ctx.clock, ctx.dev
    rec = Record()
    keep = Keeper(ctx.seed)

    def one(i: int) -> float:
        """Call i, waited for; returns the host time of the entry call."""
        j, r = ctx.picks[i % MAX_CALLS], i % MAX_CALLS
        t0 = clock()
        try:
            out = ctx.call(ctx.pool[j], None if ctx.rhs is None else ctx.rhs[r])
        except Exception as e:  # noqa: BLE001 - a failed call is counted, the loop goes on
            ctx.errors.append(f"call {i}: {type(e).__name__}: {e}")
            out = None
        host = clock() - t0
        dev.sync()
        if out is None:
            rec.failed += 1
        else:
            keep.add((j, r, out))
        return host

    hits = memo_hits()
    start = clock()
    i = 0
    while True:
        rec.entry_host_s.append(one(i))
        i += 1
        end = clock()
        if end - start >= seconds:
            break
    rec.window_s = end - start
    rec.memo_hits = memo_hits() - hits
    rec.attempted = i
    rec.completed = i - rec.failed
    if trace:
        def stretch() -> int:
            t0, k = clock(), 0
            while k == 0 or clock() - t0 < TRACE_S:
                one(i + k)
                k += 1
            return k

        n, rec.trace = profiled(stretch, ctx.device)
        rec.traced_answers = n
        rec.attempted += n
    rec.answers = keep.items()
    return rec


def release(ctx) -> None:
    ctx.call = None
