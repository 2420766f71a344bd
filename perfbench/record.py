"""What one run leaves for the metric readers and the comparison."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from perfbench.trace import Trace


@dataclass
class Record:
    setup_s: float = math.nan  # process start to the first timed operation
    window_s: float = 0.0  # the measured window, first call to last answer
    attempted: int = 0  # calls made, or requests due, in the window
    completed: int = 0  # of those, answered
    failed: int = 0  # of those, raised, refused or never answered
    # one client: host seconds from each entry call to its return
    entry_host_s: List[float] = field(default_factory=list)
    memo_hits: int = 0  # the program's drain-memo hits over the window
    # served: each request due in the window, due to ready on the card
    # (infinite for one that failed or never came)
    latencies_ms: List[float] = field(default_factory=list)
    host_request_s: float = 0.0  # served: host seconds in submit, tick, result
    resolved: int = 0  # served: TickReport.resolved over the window
    drains: int = 0  # served: TickReport.drains over the window
    trace: Optional[Trace] = None  # the profiled stretch (--trace 1)
    traced_answers: int = 0  # answers the profiled stretch produced
    # the algorithm's tasks: (kernel, tasks, FLOPs a task, bytes a task)
    tasks: List[Tuple[str, int, float, float]] = field(default_factory=list)
    flops_per_answer: float = 0.0  # the operation's algorithmic FLOPs
    # answers kept for the comparison: (pool index, rhs index, answer)
    answers: List[tuple] = field(default_factory=list)
