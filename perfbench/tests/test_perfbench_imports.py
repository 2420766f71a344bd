"""No module that a run loads is JAX's or the JAX package's, compared by
whole top-level names; the references load nothing of the port; and
without a card the command exits non-zero and prints no result."""

import json
import subprocess
import sys

from perfbench.harness import FORBIDDEN
from perfbench.registry import HERE

ROOT = HERE.parent

# a whole tiny run of each cell's code on the CPU, then every module name
RUN = f"""
import json, sys, torch
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from perfbench.tests.conftest import tiny_files, tiny_manifest
from perfbench import harness
from perfbench.registry import Registry, HERE
from pathlib import Path
import tempfile
tmp = Path(tempfile.mkdtemp())
tiny_files(tmp)
m, reg = tiny_manifest(), Registry([tmp, HERE])
for cell in ("t-lu", "t-potrf", "t-served"):
    for trace in (False, True):
        assert harness.run_cell(m, reg, cell, 5, 0.2, trace, torch.device("cpu"), 0.0)["correct"]
print(json.dumps(sorted(sys.modules)))
"""

REFERENCES = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}]
from perfbench.registry import Registry
reg = Registry()
for name in ("lu_solve", "cholesky"):
    reg.reference(name)
print(json.dumps(sorted(sys.modules)))
"""


def modules(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    tops = {m.split(".")[0] for m in modules(RUN)}
    assert "repro_torch" in tops and "perfbench" in tops
    assert not tops & set(FORBIDDEN)


def test_references_load_nothing_of_the_program():
    tops = {m.split(".")[0] for m in modules(REFERENCES)}
    assert not tops & {"repro_torch", *FORBIDDEN}


def test_names_compare_whole():
    """``repro_torch`` begins with ``repro`` and is allowed; ``repro`` is not."""
    from perfbench.harness import forbidden_modules

    names = ["repro_torch", "repro_torch.linalg", "reprox", "jaxtyping", "perfbench", "repro", "repro.core",
             "jax.numpy", "jaxlib", "flax.linen"]
    assert forbidden_modules(names) == ["flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_without_a_card_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", "lu-stream",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == "", (out.returncode, out.stdout)
