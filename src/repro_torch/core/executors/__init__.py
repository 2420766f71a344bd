from .base import Executor, group_wave
from .inline import InlineExecutor
from .jit_wave import (
    CudaExecutor,
    WaveExecutor,
    clear_compile_cache,
    drain_memo_stats,
)
from .wave_program import SchedulePlan, build_program, plan_schedule

__all__ = [
    "CudaExecutor",
    "Executor",
    "InlineExecutor",
    "SchedulePlan",
    "WaveExecutor",
    "build_program",
    "clear_compile_cache",
    "drain_memo_stats",
    "group_wave",
    "plan_schedule",
]
