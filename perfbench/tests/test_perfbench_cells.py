"""Whole runs of tiny cells on the CPU (the harness's look for a card left
out): a sound run is correct, a configuration, a traffic mix and a metric
added as new files are found by name, and a run over a broken timed path
comes out not correct."""

import json
import math

import pytest
import torch

from perfbench import harness
from perfbench import manifest as mf
from perfbench.registry import HERE, Registry

from .conftest import write

SEED = 2**31 + 11  # over 32 signed bits, as the driver's seeds are
CPU = torch.device("cpu")


def run(m, reg, cell, trace=False, seconds=0.3):
    r = harness.run_cell(m, reg, cell, SEED, seconds, trace, CPU, 0.0)
    json.loads(json.dumps(r, allow_nan=False))  # a plain JSON line
    return r


@pytest.mark.parametrize("cell", ["t-lu", "t-potrf", "t-served"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(tiny, cell, trace):
    m, reg = tiny
    r = run(m, reg, cell, trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "cpu"
    want = mf.reported(m, cell, trace)
    assert set(r["metrics"]) <= set(want)
    if not trace:
        assert set(r["metrics"]) == set(want)  # the end-to-end metrics are host clocks, read on the CPU too
    else:
        # no device here: a reader with nothing to read reports nothing
        assert not {"tile_roofline.stream", "idle_share.stream", "tile_roofline.served"} & set(r["metrics"])
        assert r["device"]["busy_s"] == 0.0 and "breakdown" in r


def test_files_added_by_name_are_found(tmp_path, tiny):
    """A new configuration, traffic mix and per-layer metric, each a new
    file in a folder of its own, run as a new cell: no file is edited."""
    m, _ = tiny
    before = {p: p.stat().st_mtime_ns for p in HERE.rglob("*") if p.is_file() and "__pycache__" not in str(p)}
    new = tmp_path / "added"
    reg0 = Registry()
    write(new, "configs", "new-lu", dict(reg0.config("sgesv-nopiv-n4096-fp32"), name="new-lu", n=24, tile=4))
    write(new, "traffic", "new-mix", {"driver": "closed_loop", "pool": 2})
    write(new, "metrics", "answers_per_s.new",
          '"""Answers a second over the window."""\n\n\ndef read(rec):\n'
          '    return rec.completed / rec.window_s if rec.window_s else None\n')
    m["configs"].append({"name": "new-lu", "source": "test", "file": "none", "reduced": [], "why": "test"})
    m["workloads"].append({"name": "new-cell", "config": "new-lu", "traffic": "new-mix", "chips": 1,
                           "why": "test"})
    m["per_layer"].append({"name": "answers_per_s.new", "unit": "1/s", "better": "higher", "source": "host_clock",
                           "layer": "the whole solve", "moves": "solution_ms", "workloads": ["new-cell"]})
    m["end_to_end"][0]["workloads"].append("new-cell")
    assert not mf.problems(m)
    reg = Registry([new, *reg0.roots])
    assert run(m, reg, "new-cell")["correct"]
    r = run(m, reg, "new-cell", trace=True)
    assert r["correct"] and r["metrics"]["answers_per_s.new"]["value"] > 0
    after = {p: p.stat().st_mtime_ns for p in HERE.rglob("*") if p.is_file() and "__pycache__" not in str(p)}
    assert after == before


# -- faults planted under the timed path ----------------------------------------
def unchanged_lu(entry):
    """The solve returns its state unchanged: x is b as it came in."""
    return lambda cfg, device: (lambda a, b: b.clone())


def altered_lu(entry):
    """One answer altered where it is produced: one entry of the fifth solve."""
    def make(cfg, device):
        call, n = entry(cfg, device), [0]

        def f(a, b):
            x = call(a, b)
            n[0] += 1
            if n[0] == 5:
                x = x.clone()
                x[3] *= 1.01
            return x
        return f
    return make


def unchanged_potrf(entry):
    return lambda cfg, device: (lambda a, b=None: torch.tril(a))


def altered_potrf(entry):
    def make(cfg, device):
        call = entry(cfg, device)

        def f(a, b=None):
            x = call(a, b).clone()
            x[5, 2] *= 1.01
            return x
        return f
    return make


class Proxy:
    """A future whose answer is replaced by ``answer(x)``."""

    def __init__(self, fut, answer):
        self.fut, self.answer = fut, answer

    def __getattr__(self, name):
        return getattr(self.fut, name)

    def result(self):
        return self.answer(self.fut.result())


def served(wrap):
    def patch(server):
        def make(cfg, traffic, device):
            srv, submit = server(cfg, traffic, device)
            count = [0]

            def sub(s, a, b):
                count[0] += 1
                return Proxy(submit(s, a, b), wrap(count[0], b))
            return srv, sub
        return make
    return patch


def half_left_out(k, b):
    """Half of each batch left out: every other request's lane is not
    computed, so its in-place right-hand side comes back as it went in."""
    return (lambda x: b.clone()) if k % 2 else (lambda x: x)


def one_altered(k, b):
    def f(x):
        if k % 16 == 15:  # one in the window, past the warm-up
            x = x.clone()
            x[1] += 1e-3 * x.abs().max()
        return x
    return f


@pytest.mark.parametrize("fault", [None, altered_potrf])
def test_large_answers_are_sampled(tiny, monkeypatch, fault):
    """Where the answers would not all fit in ``KEEP_BYTES``, the first, the
    last and a sample drawn from the seed between are compared, and an
    answer altered on every call still fails."""
    m, reg = tiny
    monkeypatch.setattr(reg.driver("closed_loop"), "KEEP_BYTES", 3 * 32 * 32 * 4)  # three tiny factors
    if fault:
        op = reg.operation("cholesky")
        monkeypatch.setattr(op, "entry", fault(op.entry))
    r = run(m, reg, "t-potrf", seconds=1.0)
    assert r["attempted"] > 3 and r["checks"]["answers_checked"]["value"] == 3, r
    assert r["correct"] is (fault is None), r["checks"]


def test_keeper_keeps_the_first_the_last_and_a_seeded_sample(monkeypatch):
    driver = Registry().driver("closed_loop")
    monkeypatch.setattr(driver, "KEEP_BYTES", 6 * 4 * 4)  # six answers of four floats

    def kept(seed, count):
        keep = driver.Keeper(seed)
        for k in range(count):
            keep.add((0, k, torch.zeros(4)))
        return [k for _, k, _ in keep.items()]

    a = kept(7, 100)
    assert len(a) == 6 and a[0] == 0 and a[-1] == 99 and len(set(a)) == 6
    assert kept(7, 100) == a and kept(8, 100) != a
    assert kept(7, 4) == [0, 1, 2, 3]  # fewer than fit: every one


@pytest.mark.parametrize("cell,attr,fault", [
    ("t-lu", "entry", unchanged_lu),
    ("t-lu", "entry", altered_lu),
    ("t-potrf", "entry", unchanged_potrf),
    ("t-potrf", "entry", altered_potrf),
    ("t-served", "server", served(half_left_out)),
    ("t-served", "server", served(one_altered)),
    ("t-served", "server", served(lambda k, b: lambda x: b.clone())),
])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, attr, fault):
    m, reg = tiny
    op = reg.operation(reg.config(mf.cell(m, cell)["config"])["operation"])
    monkeypatch.setattr(op, attr, fault(getattr(op, attr)))
    r = run(m, reg, cell)
    assert r["correct"] is False, r["checks"]
    failed = [n for n, c in r["checks"].items() if n != "answers_checked" and not c["value"] <= c["limit"]]
    assert failed and all(math.isfinite(float(c["limit"])) for c in r["checks"].values())
