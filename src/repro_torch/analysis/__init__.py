"""Static analysis over schedules and dependence DAGs (DESIGN.md §11).

- ``hazards``: re-derive RAW/WAR/WAW dependences from task footprints and
  cross-check the ``DepTracker`` DAG (missing edge = race, spurious edge =
  lost parallelism).
- ``verify``:  prove a ``SchedulePlan``'s fusion/slot/scatter invariants.

Runtime wiring: ``Dispatcher(verify=True)`` or ``REPRO_VERIFY=1`` runs both
passes on every non-replay drain; memo replays re-execute a verified
capture and skip verification entirely.
"""

from .hazards import (
    Conflict,
    HazardReport,
    LostParallelismWarning,
    analyze_hazards,
    recompute_conflicts,
)
from .verify import clear_verified_cache, verifier_stats, verify_plan

__all__ = [
    "Conflict",
    "HazardReport",
    "LostParallelismWarning",
    "analyze_hazards",
    "clear_verified_cache",
    "recompute_conflicts",
    "verifier_stats",
    "verify_plan",
]
