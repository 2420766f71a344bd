"""BENCHMARK.json keeps the benchmark's rules: names, units, keys, bounds,
and a reader file for every metric it names."""

import copy
import json

import pytest

from perfbench import manifest as mf
from perfbench.registry import HERE, Registry

ROOT = HERE.parent


def load():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keeps_the_rules():
    m = mf.load(ROOT)
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "perfbench/run.py"] and m["paths"] == ["perfbench"]


@pytest.mark.parametrize("name,ok", [
    ("lu-stream", True), ("dispatch_ms.stream", True), ("_x9", True), ("a" * 64, True),
    ("a" * 65, False), ("has space", False), ("a/b", False), ("a,b", False), (".hidden", False),
    ("-dash", False), ("muµ", False), ("", False),
])
def test_names(name, ok):
    assert bool(mf.NAME.fullmatch(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("ms", True), ("%", True), ("tokens/s", True), ("count", True), ("s", True),
    ("tokens per second", False), ("x" * 17, False), ("µs", False), ("", False),
])
def test_units(unit, ok):
    assert bool(mf.UNIT.fullmatch(unit)) is ok


@pytest.mark.parametrize("break_it,message", [
    (lambda m: m["workloads"][0].update(name="bad name"), "is not a name"),
    (lambda m: m["per_layer"][0].update(unit="per second"), "unit"),
    (lambda m: m["end_to_end"][0].update(bound=0.5), "bound"),
    (lambda m: m["end_to_end"][0].update(bound=0.001), "bound"),
    (lambda m: m["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda m: m["per_layer"][0].update(why="no such key"), "not allowed"),
    (lambda m: m["workloads"].append(dict(m["workloads"][0], name="again")), "appears twice"),
    (lambda m: m["end_to_end"].pop(), "setup_s"),
    (lambda m: m["workloads"][0].update(chips=2), "chips"),
    (lambda m: m["per_layer"][0]["workloads"].append("no-cell"), "no workload"),
])
def test_a_broken_manifest_is_refused(break_it, message):
    m = copy.deepcopy(load())
    break_it(m)
    assert any(message in p for p in mf.problems(m)), mf.problems(m)


def test_every_name_has_its_files():
    m, reg = mf.load(ROOT), Registry()
    for metric in m["end_to_end"] + m["per_layer"]:
        assert callable(reg.metric(metric["name"]).read)
    for c in m["configs"]:
        cfg = reg.config(c["name"])
        assert (ROOT / c["file"]).is_file() and cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"]) and cfg["limits"]
        op = reg.operation(cfg["operation"])
        assert reg.work(op.WORK).tasks and reg.reference(op.REFERENCE)
    for w in m["workloads"]:
        assert callable(reg.driver(reg.traffic(w["traffic"])["driver"]).run)


def test_reported_metrics_per_cell():
    m = mf.load(ROOT)
    for w in m["workloads"]:
        e2e, layer = mf.reported(m, w["name"], False), mf.reported(m, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(x["moves"] in e2e for x in layer.values())
    assert set(mf.reported(m, "lu-served", False)) == {"request_p95_ms", "setup_s"}
