"""Arithmetic that more than one metric reader shares."""

from __future__ import annotations

import math
from typing import Optional, Sequence

from perfbench.peaks import FP32_ACCURATE_FLOPS_PER_S, bound_s
from perfbench.record import Record


def p95(values: Sequence[float]) -> float:
    """The nearest-rank 95th percentile (an infinite value ranks last)."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)] if s else math.nan


def tile_roofline(rec: Record) -> Optional[float]:
    """% of the tile kernels' device time in the profiled stretch that
    their least time takes: for each of the algorithm's tasks the larger of
    its FLOPs at the fp32-accurate peak and its bytes at HBM's, summed over
    the answers the stretch produced, over the device time of the kernels
    the tasks name (matched by name in the trace)."""
    if rec.trace is None or not rec.traced_answers:
        return None
    names = {k for k, _, _, _ in rec.tasks}
    device_s = sum(t for k, (_, t) in rec.trace.kernels.items() if k in names)
    if device_s <= 0:
        return None
    least = sum(n * bound_s(f, b) for _, n, f, b in rec.tasks) * rec.traced_answers
    return 100.0 * least / device_s


def idle_share(rec: Record) -> Optional[float]:
    """% of the profiled stretch's wall time in which no operation ran on
    the device."""
    if rec.trace is None or rec.trace.window_s <= 0 or rec.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def solve_mfu(rec: Record) -> Optional[float]:
    """% of the fp32-accurate peak that the operation's algorithmic FLOPs
    reach over the window's time per answer."""
    if not rec.completed or rec.window_s <= 0:
        return None
    return 100.0 * rec.flops_per_answer * rec.completed / rec.window_s / FP32_ACCURATE_FLOPS_PER_S
