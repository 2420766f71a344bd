"""The port stands alone: it imports neither JAX nor the JAX package (its
serving layer, fault registry, LM models, configs and LM serving engine
included), and its entry points, the ``BatchServer``, ``build_model`` and
``ServeEngine`` among them, never run on the CPU unless the caller asks
for it."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch.linalg import run_cholesky, run_lu_batched, run_lu_solve_batched
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serve import BatchServer
from repro_torch.serving import ServeEngine

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
import numpy as np
from repro_torch.core import dd_matrix
from repro_torch.serve import BatchServer
from repro_torch.testing import faults
srv = BatchServer(graph="g2p", device="cpu")
def submit():
    return [srv.lu_solve(dd_matrix(32, seed=s, device="cpu"), np.ones(32, np.float32),
                         partitions=((2, 2),)) for s in range(3)]
futs = submit()
with faults.inject("serve.drain", RuntimeError("probe"), times=1):
    rep = srv.tick()  # the failed chunk bisects, and both halves resolve
assert (rep.resolved, rep.bisected) == (3, 1), rep
futs += submit()
rep = srv.tick()
assert (rep.resolved, rep.stacked_drains) == (3, 1), rep
assert all(f.exception() is None for f in futs)
import torch
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, Request, ServeEngine
cfg = get_arch("starcoder2-7b").reduced()
model = build_model(cfg, device="cpu")
h, _ = model({"tokens": torch.arange(12)[None]})
assert h.shape == (1, 12, cfg.d_model) and bool(torch.isfinite(h).all())
eng = ServeEngine(cfg, model, EngineConfig(slots=2, max_seq=16), device="cpu")
for i in range(2):
    eng.submit(Request(rid=i, prompt=np.arange(3 + i), max_new_tokens=3))
assert len(eng.run_until_drained()) == 2 and eng.decode_steps == 2
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
    with pytest.raises(RuntimeError, match="cuda"):
        run_lu_batched([a, a], partitions=((2, 2),))
    with pytest.raises(RuntimeError, match="cuda"):
        run_lu_solve_batched([a, a], [a[0], a[1]], partitions=((2, 2),))
    with pytest.raises(RuntimeError, match="cuda"):
        BatchServer()
    cfg = get_arch("starcoder2-7b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, build_model(cfg, device="cpu"))
    assert run_cholesky(a, partitions=((2, 2),), device="cpu").device.type == "cpu"
    assert BatchServer(device="cpu").device.type == "cpu"
