"""95th percentile (nearest rank), over every request due in the window, of
the time from when it was due to when its answer was ready on the card; a
request that failed or never came ranks above every other (an infinite
percentile is left out of the result line, and the run's checks fail)."""

from perfbench.reduce import p95


def read(rec):
    return p95(rec.latencies_ms) if rec.latencies_ms else None
