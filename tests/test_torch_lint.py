"""The port's operation linter on the CPU: the port's copies of
tests/test_analysis.py's linter cases (``test_registry_lints_clean`` and the
``test_lint_*`` cases) over the port's ``OpRegistry``, with each faulty
operation written against the port's ``Operation``, and the CLI run clean."""

import subprocess
import sys
from pathlib import Path

from repro_torch.analysis import lint_operation, lint_or_raise, lint_registry
from repro_torch.core import Access, GTask, Operation
from repro_torch.errors import LintError


def test_registry_lints_clean():
    import repro_torch.linalg.ops  # noqa: F401 — populate

    assert lint_registry(execute=True) == []
    assert lint_or_raise() >= 10


class _ValueDependentSplitOp(Operation):
    name = "_lint_bad_split"

    def default_modes(self, n):
        return [Access.READWRITE] * n

    def split(self, task, submit):
        v = task.args[0]
        if v.data.value[0, 0] > 0:  # reads values in a memoizable split
            submit(GTask(self, task, [v]))


class _RngSplitOp(Operation):
    name = "_lint_rng_split"

    def split(self, task, submit):
        import random

        if random.random() > 0.5:
            submit(GTask(self, task, [task.args[0]]))


class _TorchRngSplitOp(Operation):
    name = "_lint_torch_rng_split"

    def split(self, task, submit):
        import torch

        if torch.random.initial_seed() % 2:
            submit(GTask(self, task, [task.args[0]]))


class _BadModesOp(Operation):
    name = "_lint_bad_modes"

    def default_modes(self, n):
        return [Access.READ] * (n + 1)  # arity mismatch

    def leaf_fn(self, backend):
        return lambda a, b: a + b


class _ReadOnlyOp(Operation):
    name = "_lint_read_only"

    def default_modes(self, n):
        return [Access.READ] * n  # no write arg: no output

    def leaf_fn(self, backend):
        return lambda a: a


class _WrongOutputCountOp(Operation):
    name = "_lint_wrong_out"

    def default_modes(self, n):
        return [Access.READWRITE, Access.READ]

    def leaf_fn(self, backend):
        return lambda a, b: (a, b)  # two outputs for one write arg


class _CudaArityOp(Operation):
    name = "_lint_cuda_arity"

    def default_modes(self, n):
        return [Access.READ, Access.READWRITE]

    def leaf_fn(self, backend):
        if backend == "cuda":
            return lambda a, b, c: b  # one argument more than the torch leaf
        return lambda a, b: b


def test_lint_flags_value_dependent_split():
    issues = lint_operation(_ValueDependentSplitOp())
    assert any(i.check == "L1" and ".value" in i.detail for i in issues)
    # declaring the split value-dependent silences L1 (the contract is met)
    op = _ValueDependentSplitOp()
    op.memoizable = False
    assert not [i for i in lint_operation(op) if i.check == "L1"]


def test_lint_flags_rng_split():
    issues = lint_operation(_RngSplitOp())
    assert any(i.check == "L1" and "random" in i.detail for i in issues)


def test_lint_flags_torch_rng_split():
    issues = lint_operation(_TorchRngSplitOp())
    assert any(i.check == "L1" and "torch RNG" in i.detail for i in issues)


def test_lint_flags_mode_arity_mismatch():
    issues = lint_operation(_BadModesOp())
    assert any(i.check == "L2" for i in issues)


def test_lint_flags_all_read_op():
    issues = lint_operation(_ReadOnlyOp())
    assert any(i.check == "L2" and "no write-mode" in i.detail for i in issues)


def test_lint_flags_wrong_output_count():
    issues = lint_operation(_WrongOutputCountOp(), execute=True)
    assert any(i.check == "L3" and "returns 2" in i.detail for i in issues)


def test_lint_flags_cuda_leaf_arity():
    issues = lint_operation(_CudaArityOp())
    assert any(i.check == "L3" and "cuda leaf takes 3" in i.detail for i in issues)


def test_lint_error_formatting():
    issues = lint_operation(_BadModesOp())
    err = LintError(issues)
    assert err.issues == issues
    assert "_lint_bad_modes" in str(err) and "[L2]" in str(err)


def test_lint_cli_runs_clean():
    repo = Path(__file__).resolve().parents[1]
    for args in (["--no-execute"], []):
        out = subprocess.run([sys.executable, str(repo / "scripts" / "torch_lint_ops.py"), *args],
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "ops lint OK" in out.stdout
