#!/usr/bin/env python
"""CLI gate: lint every Operation registered by the PyTorch port
(``src/repro_torch``; DESIGN.md §11), on the CPU.

    python scripts/torch_lint_ops.py                     # full registry
    python scripts/torch_lint_ops.py --no-execute        # static-only
    python scripts/torch_lint_ops.py getrf trsml         # named subset

Exit status 0 iff every checked op is clean; issues print one per line.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    # runnable from a clean checkout without PYTHONPATH
    repo_src = os.path.join(os.path.dirname(__file__), "..", "src")
    if os.path.isdir(repo_src) and repo_src not in sys.path:
        sys.path.insert(0, os.path.abspath(repo_src))

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "ops", nargs="*", help="op names to lint (default: full registry)"
    )
    parser.add_argument(
        "--no-execute",
        action="store_true",
        help="skip the leaf smoke evaluation (pure static checks)",
    )
    args = parser.parse_args(argv)

    import repro_torch.linalg.ops  # noqa: F401 — populates the registry
    from repro_torch.analysis import lint_registry
    from repro_torch.core.operation import OpRegistry

    names = args.ops or OpRegistry.names()
    issues = lint_registry(names, execute=not args.no_execute)
    bad = {i.op for i in issues}
    for name in names:
        print(f"  {'FAIL' if name in bad else 'ok  '} {name}")
    if issues:
        print(f"\n{len(issues)} issue(s):")
        for issue in issues:
            print(f"  {issue}")
        return 1
    print(f"ops lint OK ({len(names)} operations, 0 issues)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
