"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line (``run.py`` is the command)."""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from perfbench import manifest as mf
from perfbench.device import Device
from perfbench.registry import Registry

# top-level module names that may not be loaded in a run's process: JAX,
# its libraries, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Optional[List[str]] = None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name (before the first
    dot), taken whole, is one of ``FORBIDDEN``."""
    return sorted({m for m in (list(sys.modules) if names is None else names) if m.split(".")[0] in FORBIDDEN})


@dataclass
class Context:
    """What a driver works with: the cell's files, the device, the seed."""

    cfg: dict
    traffic: dict
    op: object
    registry: Registry
    device: torch.device
    dev: Device
    seed: int
    seconds: float
    clock: Callable[[], float] = time.perf_counter
    errors: List[str] = field(default_factory=list)

    def generator(self, stream: int, device: Optional[str] = None) -> torch.Generator:
        """A generator on ``device`` (the run's by default) seeded from the
        run's seed and ``stream``: the same seed gives the same inputs."""
        g = torch.Generator(device=device or self.device)
        g.manual_seed((self.seed * 1_000_003 + stream) % (1 << 63))
        return g


def device_info(device: torch.device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}


def compare(ctx: Context, answers: List[tuple], precision: str = "float64") -> Dict[str, float]:
    """The operation's compared numbers over ``answers`` ((pool index, rhs
    index, answer) each) against the plain reference; with ``precision``
    other than float64, the control's: the reference's own answers to the
    same inputs in that precision."""
    if not answers:
        return {}
    picks = [j for j, _, _ in answers]
    rhs = None
    if ctx.rhs is not None:
        rhs = ctx.rhs[torch.tensor([r for _, r, _ in answers], dtype=torch.long, device=ctx.rhs.device)]
    return ctx.op.compare(ctx.cfg, ctx.registry, ctx.pool, picks, rhs, [x for _, _, x in answers], precision)


def run_cell(m: dict, registry: Registry, cell_name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, err=sys.stderr) -> dict:
    """Run ``cell_name`` once and return its result line (a dict whose last
    key, ``checks``, holds each compared number beside its limit)."""
    cell = mf.cell(m, cell_name)
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    op = registry.operation(cfg["operation"])
    driver = registry.driver(traffic["driver"])
    work = registry.work(op.WORK)
    dev = Device(device)
    ctx = Context(cfg, traffic, op, registry, device, dev, seed, seconds)
    if dev.cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)

    driver.prepare(ctx)
    dev.sync()
    # what set-up made (plans, captured programs, inputs) is kept out of
    # the collector's later passes, as a server does after its warm-up
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    rec = driver.run(ctx, seconds, trace)
    gc.unfreeze()
    rec.setup_s = setup_s
    rec.tasks = work.tasks(cfg["n"], cfg["tile"], cfg.get("rhs_columns", 0))
    rec.flops_per_answer = work.algorithmic_flops(cfg["n"], cfg.get("rhs_columns", 0))
    info = device_info(device, cell["chips"])
    if trace and rec.trace is not None:
        info["busy_s"] = rec.trace.busy_s
        info["window_s"] = rec.trace.window_s

    # the program's state goes before the reference runs
    driver.release(ctx)
    if dev.cuda:
        from repro_torch.core.executors import release_captured

        release_captured()
    answers, rec.answers = rec.answers, []
    numbers = compare(ctx, answers)
    checks: Dict[str, dict] = {}
    for name, limit in cfg["limits"].items():
        checks[name] = {"value": numbers.get(name, math.inf), "limit": limit}
    checks["failed"] = {"value": rec.failed, "limit": 0}
    checks["answers_checked"] = {"value": len(answers), "limit": 1}
    correct = all(c["value"] <= c["limit"] for n, c in checks.items() if n != "answers_checked") and bool(answers)

    metrics = {}
    for name, spec in mf.reported(m, cell_name, trace).items():
        value = registry.metric(name).read(rec)
        if value is not None and math.isfinite(value):
            metrics[name] = {"value": value, "unit": spec["unit"]}
    result = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed, "metrics": metrics,
              "device": info}
    if trace and rec.trace is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in rec.trace.device_ops],
                               "idle_gaps": [list(x) for x in rec.trace.idle_gaps]}
    result["checks"] = checks
    for e in ctx.errors[:20]:
        print(f"error: {e}", file=err)
    return result


def report(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output (a check's infinite or NaN number as its
    text: JSON has none)."""
    for c in result["checks"].values():
        if isinstance(c["value"], float) and not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])
    for name, c in result["checks"].items():
        rel = ">=" if name == "answers_checked" else "<="
        print(f"check {name} = {c['value']!r} (must be {rel} {c['limit']!r})", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
