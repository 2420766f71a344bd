"""Fixtures of the benchmark's CPU tests: a registry whose first root is a
temporary folder of tiny configurations and traffic, searched before the
benchmark's own files, and a manifest with cells over them."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest

from perfbench.registry import HERE, Registry

ROOT = HERE.parent
# tiny stand-ins of the benchmark's cells: name -> (config, traffic, the cell they stand in for)
TINY = {
    "t-lu": ("tiny-lu", "tiny-closed", "lu-stream"),
    "t-potrf": ("tiny-potrf", "tiny-closed", "potrf-stream"),
    "t-served": ("tiny-lu", "tiny-open", "lu-served"),
}


def write(root: Path, kind: str, name: str, data) -> None:
    (root / kind).mkdir(parents=True, exist_ok=True)
    text = data if isinstance(data, str) else json.dumps(data)
    (root / kind / f"{name}{'.py' if isinstance(data, str) else '.json'}").write_text(text)


def tiny_files(root: Path) -> None:
    """Tiny configurations (the real ones at n = 32 in tiles of 4) and
    traffic mixes for each driver, in ``root``."""
    reg = Registry()
    lu = dict(reg.config("sgesv-nopiv-n4096-fp32"), name="tiny-lu", n=32, tile=4)
    po = dict(reg.config("potrf-n8192-fp32"), name="tiny-potrf", n=32, tile=4)
    write(root, "configs", "tiny-lu", lu)
    write(root, "configs", "tiny-potrf", po)
    write(root, "traffic", "tiny-closed", {"driver": "closed_loop", "pool": 3})
    write(root, "traffic", "tiny-open", {"driver": "open_loop", "rate": 60, "pool": 3, "max_batch": 4})


def tiny_manifest() -> dict:
    """The benchmark's manifest with the tiny cells added beside the ones
    they stand in for (in every metric's ``workloads`` too)."""
    m = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    for cell, (config, traffic, like) in TINY.items():
        if config not in {c["name"] for c in m["configs"]}:
            m["configs"].append({"name": config, "source": "test", "file": "none", "reduced": [], "why": "test"})
        m["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "test"})
        for metric in m["end_to_end"] + m["per_layer"]:
            if like in metric.get("workloads", []):
                metric["workloads"].append(cell)
    return m


@pytest.fixture()
def tiny(tmp_path, monkeypatch):
    """(manifest, registry) with the tiny cells; the registry searches
    ``tmp_path`` first, and its drivers profile short stretches."""
    tiny_files(tmp_path)
    reg = Registry([tmp_path, HERE])
    monkeypatch.setattr(reg.driver("closed_loop"), "TRACE_S", 0.05)
    monkeypatch.setattr(reg.driver("open_loop"), "TRACE_S", 0.1)
    return tiny_manifest(), reg


@pytest.fixture(autouse=True)
def _fresh_program():
    """Each test starts from empty drain memos and captured programs."""
    from repro_torch.core.executors import clear_compile_cache

    clear_compile_cache()
    yield
    clear_compile_cache()
