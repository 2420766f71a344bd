"""The open loop times each request from when it was due, on a fake clock:
a server that stalls shows in the 95th percentile, also for the requests
that could not even be offered while it stalled."""

import math

import numpy as np
import pytest

from perfbench.device import HostEvent
from perfbench.reduce import p95
from perfbench.registry import Registry

DRIVER = Registry().driver("open_loop")


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def wait(self, s):
        self.t += max(s, 1e-6)


class FakeServer:
    """Answers every waiting request in a tick of ``tick_s``; the tick at
    ``stall_at`` (seconds after the start) takes ``stall_s`` instead."""

    def __init__(self, clock, tick_s=1e-3, stall_at=None, stall_s=0.0):
        self.clock, self.tick_s, self.stall_at, self.stall_s = clock, tick_s, stall_at, stall_s
        self.waiting, self.ready, self.start = [], {}, clock()

    def submit(self, k):
        self.waiting.append(k)

    def tick(self):
        stall = self.stall_at is not None and self.clock() - self.start >= self.stall_at
        self.clock.t += self.stall_s if stall else self.tick_s
        if stall:
            self.stall_at = None
        ev = HostEvent(self.clock())
        for k in self.waiting:
            self.ready[k] = ev.t
        self.waiting = []
        return ev

    def pending(self):
        return len(self.waiting)


def serve(srv, clock, due):
    start = DRIVER.drive(due, srv.submit, srv.tick, srv.pending, lambda ev: ev.query(), clock, clock.wait,
                         max_inflight=2, grace_s=10.0)
    return [(srv.ready[k] - (start + d)) * 1e3 if k in srv.ready else math.inf for k, d in enumerate(due)]


def test_steady_server():
    clock = Clock()
    due = [k * 0.01 for k in range(200)]
    lat = serve(FakeServer(clock), clock, due)
    assert max(lat) < 1.5 and p95(lat) >= 1.0  # one tick, counted from the due time


def test_a_stall_shows_in_the_tail():
    clock = Clock()
    due = [k * 0.01 for k in range(200)]  # 2 s of requests, one each 10 ms
    lat = serve(FakeServer(clock, stall_at=0.5, stall_s=0.3), clock, due)
    # about 30 requests fell due while the tick stalled: they wait for it
    # though none could be offered during it
    assert 100 < p95(lat) < 300
    assert sum(x > 50 for x in lat) >= 25


def test_a_request_never_answered_counts_above_every_limit():
    assert p95([1.0] * 10 + [math.inf]) == math.inf
    assert p95([float(k) for k in range(1, 101)]) == 95.0


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_schedule_keeps_its_count(seed):
    rng = np.random.default_rng(seed)
    due = DRIVER.schedule(500, 2.0, rng)
    assert len(due) == 500 and due == sorted(due) and 0 <= due[0] and due[-1] < 2.0
