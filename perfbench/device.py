"""Synchronising with the device and placing device events on the host's
clock, alike on the card and (for the CPU tests) on the host."""

from __future__ import annotations

import time
from typing import Callable

import torch


class HostEvent:
    """A stand-in for a CUDA event where work runs on the host: done when
    recorded."""

    def __init__(self, t: float):
        self.t = t

    def query(self) -> bool:
        return True


class Device:
    def __init__(self, device: torch.device, clock: Callable[[], float] = time.perf_counter):
        self.device = device
        self.cuda = device.type == "cuda"
        self.clock = clock
        self._ref = None
        self._t_ref = 0.0

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def event(self):
        """An event recorded now on the current stream."""
        if not self.cuda:
            return HostEvent(self.clock())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def anchor(self) -> None:
        """Tie the device's event clock to the host's: an event, finished,
        read against the host clock right after."""
        self._ref = self.event()
        self.sync()
        self._t_ref = self.clock()

    def time_of(self, ev) -> float:
        """Host-clock time at which finished event ``ev`` was reached."""
        if isinstance(ev, HostEvent):
            return ev.t
        return self._t_ref + self._ref.elapsed_time(ev) / 1e3
