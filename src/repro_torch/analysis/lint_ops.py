"""Operation-algebra linter: static contract checks over the registry (the
JAX package's ``analysis/lint_ops.py``, over the port's ``OpRegistry``).

Every Operation promises the hook contract in ``core/operation.py``; the
runtime silently assumes it.  Three of those promises are checkable without
running a drain (DESIGN.md §11), and breaking any of them produces bugs
that end-to-end numerics may not catch:

    L1  **Split purity.**  A ``memoizable=True`` split must be a pure
        function of argument *geometry* — the drain memo replays captured
        schedules on fresh data, so a split that reads ``.value`` (or the
        resident ``.grid``, or wall clock / RNG state) makes replay wrong.
        Checked by AST walk over ``split`` and every same-module helper it
        calls (the composed-op pattern: ``LuSolveOp.split`` delegates to
        ``_expand_*``).
    L2  **Mode/arity consistency.**  ``default_modes(n)`` must yield one
        ``Access`` per leaf argument, and at least one write mode — the
        leaf convention returns one array per write-mode argument, so an
        all-READ op has no output and a mode/arity mismatch scatters
        results to the wrong blocks.
    L3  **Leaf/batched-leaf signature coherence.**  The torch and cuda
        leaves must take the same argument count, ``batched_leaf_fn`` must
        be buildable, and (with ``execute=True``) a smoke evaluation on
        tiny CPU blocks must return exactly one same-shape tensor per write
        argument, for both the plain and the batched form.  On CPU tensors
        the cuda leaves run their plain versions, so the smoke evaluation
        runs the torch leaves; the CUDA kernels are held to them by
        ``chip_smoke.py`` on the card.

``lint_registry`` runs all checks over every registered op;
``lint_or_raise`` wraps the result in ``repro_torch.errors.LintError`` for
programmatic gates (``scripts/torch_lint_ops.py`` is the CLI).
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.operation import Operation, OpRegistry
from ..core.task import Access
from ..errors import LintError

#: attribute reads that make a split value-dependent: the root array
#: itself (``.value``/``._value``), the resident grid epoch, or the
#: stacked-lane state.  Geometry attributes (region, level, partitions,
#: shape) are exactly what a pure split IS allowed to read.
_IMPURE_ATTRS = frozenset(
    {"value", "_value", "grid", "_grid", "lane", "_lane"}
)
#: module roots whose use inside a split means external state (time, RNG)
_IMPURE_MODULES = frozenset({"random", "time", "os"})
#: array libraries whose ``random`` namespace is an RNG
_RNG_ROOTS = ("np", "numpy", "torch")


@dataclass(frozen=True)
class LintIssue:
    op: str
    check: str  # "L1" | "L2" | "L3"
    detail: str

    def __str__(self) -> str:
        return f"{self.op}: [{self.check}] {self.detail}"


class _PurityVisitor(ast.NodeVisitor):
    """Collect impure constructs in one function's AST."""

    def __init__(self):
        self.hits: List[str] = []

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr in _IMPURE_ATTRS:
            self.hits.append(f"reads .{node.attr}")
        # numpy/torch RNG or wall clock through a module attribute chain
        root = node
        chain = [node.attr]
        while isinstance(root.value, ast.Attribute):
            root = root.value
            chain.append(root.attr)
        if isinstance(root.value, ast.Name):
            base = root.value.id
            if base in _IMPURE_MODULES:
                self.hits.append(f"calls {base}.{'.'.join(reversed(chain))}")
            if base in _RNG_ROOTS and "random" in chain:
                self.hits.append(f"uses {base} RNG")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # zero-argument ``.get()`` is the GView value read; dict.get(key)
        # style calls always carry arguments and stay legal
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and not node.args
            and not node.keywords
        ):
            self.hits.append("calls .get() (GView value read)")
        self.generic_visit(node)


def _callee_functions(fn: Callable, tree: ast.AST) -> List[Callable]:
    """Same-module plain functions ``fn``'s body calls by name — the
    composed-split helper pattern; one level of resolution, recursion is
    handled by the caller's visited set."""
    module = inspect.getmodule(fn)
    if module is None:
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            target = getattr(module, node.func.id, None)
            if inspect.isfunction(target):
                out.append(target)
    return out


def _split_purity_issues(op: Operation) -> List[LintIssue]:
    split = type(op).split
    if split is Operation.split:  # leaf-only op: nothing to check
        return []
    issues: List[LintIssue] = []
    seen = set()
    stack: List[Callable] = [split]
    while stack:
        fn = stack.pop()
        code = getattr(fn, "__code__", None)
        if code is None or code in seen:
            continue
        seen.add(code)
        try:
            src = textwrap.dedent(inspect.getsource(fn))
            tree = ast.parse(src)
        except (OSError, TypeError, SyntaxError):
            issues.append(
                LintIssue(op.name, "L1", f"split source unavailable ({fn})")
            )
            continue
        visitor = _PurityVisitor()
        visitor.visit(tree)
        where = fn.__name__
        issues.extend(
            LintIssue(
                op.name,
                "L1",
                f"memoizable split is value-dependent: {where} {hit}",
            )
            for hit in visitor.hits
        )
        stack.extend(_callee_functions(fn, tree))
    return issues


def _leaf_arity(fn: Callable) -> Optional[int]:
    try:
        params = inspect.signature(fn).parameters.values()
    except (ValueError, TypeError):
        return None
    if any(
        p.kind
        in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        for p in params
    ):
        return None
    return len(
        [
            p
            for p in params
            if p.kind
            in (
                inspect.Parameter.POSITIONAL_ONLY,
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
            )
        ]
    )


def _smoke_blocks(n_args: int, size: int = 4):
    """Tiny well-conditioned CPU blocks every algebra leaf accepts: strictly
    diagonally dominant square blocks (factorizable pivot-free, invertible
    triangles) with distinct off-diagonal content per argument."""
    blocks = []
    for a in range(n_args):
        rng = np.random.default_rng(a)
        m = rng.uniform(-0.1, 0.1, (size, size)).astype(np.float32)
        np.fill_diagonal(m, 2.0 + a)
        blocks.append(torch.from_numpy(m))
    return blocks


def lint_operation(op: Operation, execute: bool = False) -> List[LintIssue]:
    """All L1–L3 issues for one Operation (empty list == clean)."""
    issues: List[LintIssue] = []

    # L1: split purity (only meaningful for memoizable ops — a
    # memoizable=False op has *declared* its split value-dependent)
    if op.memoizable:
        issues.extend(_split_purity_issues(op))

    # L2: modes vs leaf arity
    try:
        leaf = op.leaf_fn("torch")
    except NotImplementedError:
        issues.append(LintIssue(op.name, "L2", "no torch leaf_fn"))
        return issues
    n = _leaf_arity(leaf)
    if n is None:
        issues.append(
            LintIssue(op.name, "L2", "torch leaf arity is not statically fixed")
        )
        return issues
    modes = list(op.default_modes(n))
    if len(modes) != n:
        issues.append(
            LintIssue(
                op.name,
                "L2",
                f"default_modes({n}) yields {len(modes)} modes for a "
                f"{n}-argument leaf",
            )
        )
        return issues
    if not all(isinstance(m, Access) for m in modes):
        issues.append(LintIssue(op.name, "L2", "non-Access entry in modes"))
        return issues
    write_pos = [i for i, m in enumerate(modes) if m.writes]
    if not write_pos:
        issues.append(
            LintIssue(
                op.name,
                "L2",
                "no write-mode argument: the leaf convention returns one "
                "array per write arg, so this op can produce no output",
            )
        )

    # L3: torch/cuda/batched signature coherence
    try:
        cuda_leaf = op.leaf_fn("cuda")
    except NotImplementedError:
        cuda_leaf = None
    if cuda_leaf is not None:
        cn = _leaf_arity(cuda_leaf)
        if cn is not None and cn != n:
            issues.append(
                LintIssue(
                    op.name,
                    "L3",
                    f"cuda leaf takes {cn} args, torch leaf takes {n}",
                )
            )
    try:
        batched = op.batched_leaf_fn("torch")
    except Exception as e:  # noqa: BLE001 — any failure is the finding
        issues.append(
            LintIssue(op.name, "L3", f"batched_leaf_fn('torch') failed: {e}")
        )
        batched = None

    if execute and write_pos and not issues:
        blocks = _smoke_blocks(n)
        try:
            outs = leaf(*blocks)
        except Exception as e:  # noqa: BLE001
            issues.append(
                LintIssue(op.name, "L3", f"torch leaf smoke eval raised: {e}")
            )
            return issues
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        if len(outs) != len(write_pos):
            issues.append(
                LintIssue(
                    op.name,
                    "L3",
                    f"leaf returns {len(outs)} arrays for {len(write_pos)} "
                    f"write-mode args {write_pos}",
                )
            )
            return issues
        for out, a in zip(outs, write_pos):
            if tuple(out.shape) != tuple(blocks[a].shape):
                issues.append(
                    LintIssue(
                        op.name,
                        "L3",
                        f"leaf output for arg {a} has shape "
                        f"{tuple(out.shape)} != block {tuple(blocks[a].shape)}",
                    )
                )
        if batched is not None:
            stacked = [torch.stack([b, b]) for b in blocks]
            try:
                bouts = batched(*stacked)
            except Exception as e:  # noqa: BLE001
                issues.append(
                    LintIssue(op.name, "L3", f"batched smoke eval raised: {e}")
                )
                return issues
            if not isinstance(bouts, (tuple, list)):
                bouts = (bouts,)
            if len(bouts) != len(write_pos) or any(
                tuple(o.shape) != tuple(s.shape)
                for o, s in zip(bouts, (stacked[a] for a in write_pos))
            ):
                issues.append(
                    LintIssue(
                        op.name,
                        "L3",
                        "batched leaf output count/shape mismatch vs "
                        "write-mode args",
                    )
                )
    return issues


def lint_registry(
    names: Optional[Sequence[str]] = None, execute: bool = False
) -> List[LintIssue]:
    """Lint every registered Operation (or the named subset)."""
    issues: List[LintIssue] = []
    for name in names if names is not None else OpRegistry.names():
        issues.extend(lint_operation(OpRegistry.get(name), execute=execute))
    return issues


def lint_or_raise(
    names: Optional[Sequence[str]] = None, execute: bool = False
) -> int:
    """Raise ``LintError`` on any issue; returns the op count checked."""
    checked = list(names if names is not None else OpRegistry.names())
    issues = lint_registry(checked, execute=execute)
    if issues:
        raise LintError(issues)
    return len(checked)


__all__ = [
    "LintIssue",
    "lint_operation",
    "lint_or_raise",
    "lint_registry",
]
