"""Inline executor — the paper's cpuBLAS wrapper analog.

Tasks submitted here are "immediately executed and their completions are
reported back to the dispatcher" (paper §2.2).  Each leaf runs eagerly with
the torch backend; no batching, no launch-list caching.  This is the G1 configuration
leaf and also the reference semantics for every other executor.
"""

from __future__ import annotations

from typing import List

from ..task import GTask, TaskState
from .base import Executor


class InlineExecutor(Executor):
    name = "inline"

    def __init__(self, backend: str = "torch", **kw):
        super().__init__(**kw)
        self.backend = backend

    def execute_wave(self, wave: List[GTask]) -> int:
        for task in wave:
            self.run_task(task)
        return len(wave)

    def run_task(self, task: GTask) -> None:
        task.state = TaskState.RUNNING
        fn = task.op.leaf_fn(self.backend)
        ins = [v.get() for v in task.args]
        outs = fn(*ins)
        if not isinstance(outs, tuple):
            outs = (outs,)
        wviews = task.outputs()
        assert len(outs) == len(wviews), (task.op.name, len(outs), len(wviews))
        for view, arr in zip(wviews, outs):
            view.set(arr)
        task.state = TaskState.FINISHED
        self.stats["tasks"] += 1
        self._finished(task)
