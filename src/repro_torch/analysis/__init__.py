"""Static analysis over schedules, dependence DAGs and the op registry
(DESIGN.md §11).

- ``hazards``:  re-derive RAW/WAR/WAW dependences from task footprints and
  cross-check the ``DepTracker`` DAG (missing edge = race, spurious edge =
  lost parallelism).
- ``verify``:   prove a ``SchedulePlan``'s fusion/slot/scatter invariants
  and stacked-lane disjointness.
- ``lint_ops``: AST + signature contract checks over every registered
  Operation (split purity, mode/arity, leaf coherence).

Runtime wiring: ``Dispatcher(verify=True)`` or ``REPRO_VERIFY=1`` runs the
hazard and plan passes on every non-replay drain; memo replays re-execute a verified
capture and skip verification entirely.
"""

from .hazards import (
    Conflict,
    HazardReport,
    LostParallelismWarning,
    analyze_hazards,
    recompute_conflicts,
)
from .lint_ops import LintIssue, lint_operation, lint_or_raise, lint_registry
from .verify import (
    clear_verified_cache,
    verifier_stats,
    verify_plan,
    verify_stacked_members,
)

__all__ = [
    "Conflict",
    "HazardReport",
    "LintIssue",
    "LostParallelismWarning",
    "analyze_hazards",
    "clear_verified_cache",
    "lint_operation",
    "lint_or_raise",
    "lint_registry",
    "recompute_conflicts",
    "verifier_stats",
    "verify_plan",
    "verify_stacked_members",
]
