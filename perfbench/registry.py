"""Finding a configuration, a traffic mix, an operation, a driver, a work
count, a reference or a metric by its name.

Each lives in a file of its own under one of the registry's roots:

    configs/<config>.json       the problem as it is run, its source and cuts
    traffic/<mix>.json          parameters of one driver (the load)
    drivers/<driver>.py         a general load generator (``prepare``, ``run``)
    operations/<operation>.py   inputs from the seed and the program's entry
    work/<operation>.py         the algorithm's tasks, FLOPs and bytes
    reference/<operation>.py    the plain reference (no ``repro_torch``)
    metrics/<metric>.py         ``read(record)``: one metric's value or None

A later cell, configuration or metric is added as new files; no file here
changes.  Roots are searched in order, so a test can put new files in a
temporary directory ahead of the benchmark's own.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, Sequence, Tuple

HERE = Path(__file__).resolve().parent


class Registry:
    def __init__(self, roots: Sequence[Path] = (HERE,)):
        self.roots = [Path(r) for r in roots]
        self._modules: Dict[Tuple[str, str], ModuleType] = {}

    def path(self, kind: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            p = root / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under {[str(r) for r in self.roots]}")

    def data(self, kind: str, name: str) -> dict:
        """``<kind>/<name>.json``."""
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str) -> ModuleType:
        """``<kind>/<name>.py``, loaded once, as ``perfbench.<kind>.<name>``
        with the characters a module name cannot hold replaced."""
        key = (kind, name)
        mod = self._modules.get(key)
        if mod is None:
            path = self.path(kind, name, ".py")
            modname = f"perfbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
            spec = importlib.util.spec_from_file_location(modname, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[modname] = mod
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return mod

    def config(self, name: str) -> dict:
        return self.data("configs", name)

    def traffic(self, name: str) -> dict:
        return self.data("traffic", name)

    def operation(self, name: str) -> ModuleType:
        return self.module("operations", name)

    def driver(self, name: str) -> ModuleType:
        return self.module("drivers", name)

    def work(self, name: str) -> ModuleType:
        return self.module("work", name)

    def reference(self, name: str) -> ModuleType:
        return self.module("reference", name)

    def metric(self, name: str) -> ModuleType:
        return self.module("metrics", name)
