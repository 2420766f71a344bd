"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never run on the CPU unless the caller asks for it."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch.linalg import run_cholesky

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
sys.modules["jax"] = None  # any import of jax now fails
import repro_torch
from repro_torch.core import spd_matrix
from repro_torch.linalg import run_cholesky
a = spd_matrix(32, seed=1, device="cpu")
for g in ("g1", "g2", "g2p"):
    L = run_cholesky(a, graph=g, partitions=((2, 2),), device="cpu", verify=True)
    assert float((L @ L.T - a).abs().max()) < 2e-4
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m == "repro" or m.startswith("repro.") or m.startswith("jax")))
assert bad == [], bad
print("isolated")
"""


def test_port_runs_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)(\.|\s|$|,)|from\s+(jax|jaxlib|repro)(\.|\s))", re.M
)


def test_no_jax_or_repro_imports_in_port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.eye(8, dtype=np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        run_cholesky(a)
    with pytest.raises(RuntimeError, match="cuda"):
        tcore.spd_matrix(8)
    with pytest.raises(RuntimeError, match="cuda"):
        tcore.GData((8, 8), value=a)
    assert run_cholesky(a, partitions=((2, 2),), device="cpu").device.type == "cpu"
