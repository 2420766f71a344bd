"""Test-support subsystems that ship with the runtime (not under tests/):
deterministic fault injection (``repro_torch.testing.faults``) is imported
by production code at named sites, so recovery paths are exercisable on
demand from tests and chaos drills alike (DESIGN.md §10)."""

from . import faults

__all__ = ["faults"]
