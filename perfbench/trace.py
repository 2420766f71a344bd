"""One profiled stretch of a run, reduced to what the per-layer metrics
read: the device's busy time (the union of its operations' intervals, as
``chip_smoke.py``'s ``device_busy`` takes it, here clipped to the stretch
and not to first-kernel-to-last-kernel, which hides the gaps between
solutions), device time by kernel, and the idle gaps named by what the
host was doing meanwhile."""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

STRETCH = "perfbench.stretch"
# the kernel torch.cuda._sleep launches before the stretch: a session's
# first device events can go missing, so one that no count reads goes first
WARMUP_KERNEL = "spin_kernel"
KERNEL = re.compile(r"(\w+)_kernel\b")
TOP = 10


@dataclass
class Trace:
    window_s: float  # the stretch, on the profiler's clock
    busy_s: float  # union of device intervals inside it
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)  # short name -> (launches, s)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def short_name(name: str) -> str:
    """``gemmnn`` for ``void gemmnn_kernel<64>(Segs, ...)``; other device
    operations by their first 48 characters."""
    m = KERNEL.search(name)
    return m.group(1) if m else name[:48]


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals covering the same points."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def gaps(busy: List[Tuple[float, float]], s0: float, e0: float) -> List[Tuple[float, float]]:
    """The parts of [s0, e0] that ``busy`` (merged) leaves uncovered."""
    out, t = [], s0
    for s, e in busy:
        if s > t:
            out.append((t, min(s, e0)))
        t = max(t, e)
    if t < e0:
        out.append((t, e0))
    return [(s, e) for s, e in out if e > s]


def name_gaps(idle: List[Tuple[float, float]], host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds of idle time by the innermost host event (shortest) running
    at each gap's middle; "host, no op recorded" where none is."""
    host = sorted(host)
    by: Dict[str, float] = {}
    active: list = []
    i = 0
    for s, e in sorted(idle, key=lambda g: (g[0] + g[1]) / 2):
        mid = (s + e) / 2
        while i < len(host) and host[i][0] <= mid:
            hs, he, name = host[i]
            heapq.heappush(active, (he - hs, he, name))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        label = active[0][2] if active else "host, no op recorded"
        by[label] = by.get(label, 0.0) + (e - s) / 1e6
    return by


def reduce(events) -> Trace:
    """A ``Trace`` from a profiler session's events (``prof.events()``)."""
    from torch.autograd import DeviceType

    span = [ev for ev in events if ev.name == STRETCH and ev.device_type == DeviceType.CPU]
    if not span:
        raise RuntimeError(f"the profile holds no {STRETCH} span")
    s0, e0 = span[0].time_range.start, span[0].time_range.end
    device, host = [], []
    kernels: Dict[str, Tuple[int, float]] = {}
    for ev in events:
        s, e = max(ev.time_range.start, s0), min(ev.time_range.end, e0)
        if ev.device_type == DeviceType.CUDA:
            # a record_function span shows on the device's timeline too,
            # as an annotation over the whole stretch: no operation
            if WARMUP_KERNEL in ev.name or e <= s or ev.name == STRETCH or getattr(ev, "is_user_annotation", False):
                continue
            device.append((s, e))
            k = short_name(ev.name)
            n, t = kernels.get(k, (0, 0.0))
            kernels[k] = (n + 1, t + (e - s) / 1e6)
        elif ev.device_type == DeviceType.CPU and ev.name != STRETCH and e > s:
            host.append((s, e, ev.name))
    busy = union(device)
    idle = name_gaps(gaps(busy, s0, e0), host)
    return Trace(
        window_s=(e0 - s0) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        kernels=kernels,
        device_ops=sorted(((k, t) for k, (_, t) in kernels.items()), key=lambda x: -x[1])[:TOP],
        idle_gaps=sorted(idle.items(), key=lambda x: -x[1])[:TOP],
    )


def profiled(run: Callable[[], object], device: torch.device):
    """``run()`` inside a profiler session, within the ``STRETCH`` span,
    ended by a device synchronise; returns (its result, ``Trace``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        if cuda:
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize(device)
        with record_function(STRETCH):
            out = run()
            if cuda:
                torch.cuda.synchronize(device)
    return out, reduce(prof.events())
