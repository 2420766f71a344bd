"""``BENCHMARK.json``: loading it, the rules its names and units keep, and
the metrics each cell reports."""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
BETTER = ("lower", "higher")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("device_trace", "host_clock")
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(root: Path) -> dict:
    """The manifest at ``root/BENCHMARK.json``, checked (``problems``)."""
    manifest = json.loads((Path(root) / "BENCHMARK.json").read_text())
    found = problems(manifest)
    if found:
        raise ValueError("BENCHMARK.json: " + "; ".join(found))
    return manifest


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def problems(m: dict) -> List[str]:
    """Every rule of the manifest that ``m`` breaks, as messages."""
    out = []

    def name_ok(kind, value):
        if not (isinstance(value, str) and NAME.fullmatch(value)):
            out.append(f"{kind} {value!r} is not a name (letters, digits, _ . -, at most 64, not starting with . or -)")

    def keys_ok(kind, entry, allowed, optional=()):
        extra = set(entry) - allowed - set(optional)
        missing = allowed - set(entry)
        if extra or missing:
            out.append(f"{kind} {entry.get('name')!r}: keys {sorted(extra)} not allowed, {sorted(missing)} missing")

    configs = {c.get("name"): c for c in m.get("configs", [])}
    cells = {w.get("name"): w for w in m.get("workloads", [])}
    for c in m.get("configs", []):
        keys_ok("config", c, CONFIG_KEYS)
        name_ok("config", c.get("name"))
        for k in c.get("reduced", []):
            name_ok("reduced key", k)
        if not _line(c.get("source")) or not _line(c.get("why")):
            out.append(f"config {c.get('name')!r}: source and why are one line of 1 to 200 characters")
    for w in m.get("workloads", []):
        keys_ok("workload", w, CELL_KEYS)
        for k in ("name", "config", "traffic"):
            name_ok(f"workload {k}", w.get(k))
        if w.get("config") not in configs:
            out.append(f"workload {w.get('name')!r} names no configuration of the manifest")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')!r}: chips is 1 or 4")
        if not _line(w.get("why")):
            out.append(f"workload {w.get('name')!r}: why is one line of 1 to 200 characters")
    pairs = [(w.get("config"), w.get("traffic")) for w in m.get("workloads", [])]
    if len(set(pairs)) != len(pairs):
        out.append("a pair of configuration and traffic appears twice")
    e2e = m.get("end_to_end", [])
    layer = m.get("per_layer", [])
    for metric in e2e + layer:
        kind = "end_to_end" if metric in e2e else "per_layer"
        keys_ok(kind, metric, E2E_KEYS if kind == "end_to_end" else LAYER_KEYS, optional=("workloads",))
        name_ok("metric", metric.get("name"))
        if not (isinstance(metric.get("unit"), str) and UNIT.fullmatch(metric["unit"])):
            out.append(f"metric {metric.get('name')!r}: unit {metric.get('unit')!r} (1 to 16 of letters, digits, _ / % . -)")
        if metric.get("better") not in BETTER:
            out.append(f"metric {metric.get('name')!r}: better is lower or higher")
        if metric.get("source") not in (E2E_SOURCES if kind == "end_to_end" else SOURCES):
            out.append(f"metric {metric.get('name')!r}: source {metric.get('source')!r} not allowed")
        for cell in metric.get("workloads", []):
            if cell not in cells:
                out.append(f"metric {metric.get('name')!r} lists {cell!r}, which is no workload")
    for metric in e2e:
        bound = metric.get("bound")
        if not (isinstance(bound, (int, float)) and 0.01 <= bound <= 0.25):
            out.append(f"metric {metric.get('name')!r}: bound {bound!r} outside [0.01, 0.25]")
    e2e_names = {x.get("name") for x in e2e}
    for metric in layer:
        if metric.get("moves") not in e2e_names:
            out.append(f"metric {metric.get('name')!r} moves {metric.get('moves')!r}, no end-to-end metric")
        if not _line(metric.get("layer")):
            out.append(f"metric {metric.get('name')!r}: layer is one line of 1 to 200 characters")
    names = [x.get("name") for x in m.get("configs", [])]
    names_w = [x.get("name") for x in m.get("workloads", [])]
    names_m = [x.get("name") for x in e2e + layer]
    for kind, ns in (("configuration", names), ("workload", names_w), ("metric", names_m)):
        if len(set(ns)) != len(ns):
            out.append(f"two {kind}s share a name")
    if "setup_s" not in e2e_names:
        out.append("setup_s is missing from end_to_end")
    return out


def cell(m: dict, name: str) -> dict:
    """The workload called ``name``."""
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {[w['name'] for w in m['workloads']]})")


def reported(m: dict, cell_name: str, trace: bool) -> Dict[str, dict]:
    """The metrics a run of ``cell_name`` prints: its end-to-end metrics
    without tracing, its per-layer metrics with it.  A metric without a
    ``workloads`` list belongs to every cell that reports the end-to-end
    metric it moves (or, for an end-to-end metric, to every cell)."""
    e2e = {x["name"]: x for x in m["end_to_end"] if cell_name in x.get("workloads", [cell_name])}
    if not trace:
        return e2e
    return {x["name"]: x for x in m["per_layer"]
            if cell_name in x.get("workloads", [cell_name] if x["moves"] in e2e else [])}
