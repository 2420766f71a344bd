from .base import Executor, group_wave
from .captured import CapturedProgram, CaptureError
from .inline import InlineExecutor
from .jit_wave import (
    CudaExecutor,
    WaveExecutor,
    clear_compile_cache,
    drain_memo_pressure,
    drain_memo_stats,
    program_cache_stats,
    release_captured,
    set_drain_memo_capacity,
)
from .sharded import ShardExecutor, row_sharding
from .wave_program import SchedulePlan, build_program, plan_schedule

__all__ = [
    "CaptureError",
    "CapturedProgram",
    "CudaExecutor",
    "Executor",
    "InlineExecutor",
    "SchedulePlan",
    "ShardExecutor",
    "WaveExecutor",
    "build_program",
    "clear_compile_cache",
    "drain_memo_pressure",
    "drain_memo_stats",
    "group_wave",
    "plan_schedule",
    "program_cache_stats",
    "release_captured",
    "row_sharding",
    "set_drain_memo_capacity",
]
