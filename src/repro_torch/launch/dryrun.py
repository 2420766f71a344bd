"""Multi-pod dry run (the JAX package's ``launch/dryrun.py``).

For every supported (architecture x input-shape) cell, trace the step
program on the production mesh, (16, 16) = 256 ranks single-pod and
(2, 16, 16) = 512 ranks multi-pod, with fake tensors (no allocation), and
report:

    the peak of live bytes     -> fits-in-HBM proof (``memory_stats``)
    trace_cost's FLOPs/bytes   -> the roofline (``roofline.analyze``)
    trace_cost's collectives   -> collective bytes a rank, by kind

The reference lowers and compiles the step for 512 abstract devices; the
port fakes the job instead: a ``fake`` process group (torch's
``FakeStore``) of 256 or 512 ranks, joined as rank 0, under which the
production ``DeviceMesh`` is built and every collective returns at once.
The parameters, optimizer state, batch and caches are fake CUDA tensors of
this rank's block shapes (``FakeTensorMode``: shapes and dtypes, no
storage), and the plan's eager step (``StepPlan.fn``, not ``jitted()``,
whose CUDA graph is the counterpart of the reference's ``.compile()``) runs
once on them.  Nothing of production size is allocated, and no card is
needed.

Results land in ``results/torch_dryrun/<mesh>/<arch>__<shape>.json``
(``--out``), never under ``benchmarks/``, which holds the JAX package's.

Usage:
    python -m repro_torch.launch.dryrun --arch starcoder2-7b --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --all --mesh both

A cell the port refuses (a ``NotImplementedError`` of the model or the
plans) is reported as ``FAIL`` with the port's message, and the sweep goes
on; the process exits nonzero naming the failed cells, as the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import time
import traceback
import weakref
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, SHAPES, cell_supported, get_arch, get_shape
from ..configs.base import ArchConfig, ShapeConfig
from ..tree import leaves, tree_map
from . import roofline as rl

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch_dryrun"
MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3, 700.00 W (read on the card, torch 2.11.0+cu128)
HBM_BYTES = 85_017_493_504
# The fake tensors' device.  A CPU build of torch runs no autograd on fake
# CUDA tensors (the engine asks for a CUDA device guard), so the step is
# traced on fake CPU tensors, on which the model takes the card's GEMM
# forms (``models/model.py`` ``_on_card``): the card's ops, shapes and
# dtypes.
DEVICE = "cpu"


@contextmanager
def fake_job(world: int):
    """A ``fake`` default process group of ``world`` ranks, joined as rank
    0, torn down on exit.  Refuses to start over a group already running."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running: a dry run fakes its own job (run it in a process "
                           "of its own)")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(mesh_name: str, shape: Optional[Tuple[int, ...]] = None):
    """The production mesh of ``mesh_name`` (``MESHES``) over the job, or a
    ("data", "model") / ("pod", "data", "model") mesh of ``shape``."""
    from .mesh import make_production_mesh

    if shape is None:
        return make_production_mesh(multi_pod=(mesh_name == "multipod"), device_type=DEVICE)
    from torch.distributed.device_mesh import init_device_mesh

    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return init_device_mesh(DEVICE, tuple(shape), mesh_dim_names=names)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def workspace(func, args) -> int:
    """Bytes a card kernel allocates inside an op, beside its outputs, that
    no dispatched op shows (measured per op with the card's allocator:
    ``scripts/dryrun_memory_gap.py``): CUDA's softmax backward forms
    ``grad * output`` whole, laid out as ``grad``, and copies it to a
    contiguous tensor when it is not; ``logsumexp`` holds ``self - max``
    whole."""
    name = func._schema.name.split("::")[-1]
    if name == "_softmax_backward_data":
        return _nbytes(args[0]) * (1 if args[0].is_contiguous() else 2)
    if name == "logsumexp":
        return _nbytes(args[0])
    return 0


class LiveBytes(TorchDispatchMode):
    """The bytes of live storage and their peak over the ops dispatched
    under it: each storage an op returns counts from that op until its
    last reference dies (a weak reference's callback), as the caching
    allocator holds a block; ``track`` adds the tensors that were live
    before (the step's arguments), and an op's ``workspace`` counts beside
    its outputs while it runs.  Each tensor's bytes as they are (the
    card's allocator rounds a block up to 512 bytes: under a MB at a
    step's peak).

    (``torch.distributed._tools.mem_tracker.MemTracker`` counts the same
    way, but its module hooks register gradient hooks on every parameter a
    module call reads, and the port's functional calls pass cast tensors,
    which are not leaves, as parameters: it raises.)"""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, Any] = {}

    def track(self, tensors) -> None:
        from .sharding import local

        for t in tensors:
            if not torch.is_tensor(t):
                continue
            st = local(t).untyped_storage()
            key = st._cdata
            if key in self._refs:
                continue
            n = st.nbytes()
            self._refs[key] = weakref.ref(st, functools.partial(self._free, key, n))
            self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int, _ref) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ws = workspace(func, args)
        out = func(*args, **(kwargs or {}))
        self.track(out if isinstance(out, (list, tuple)) else (out,))
        self.peak = max(self.peak, self.live + ws)
        return out


def _storages(tree) -> Dict[int, int]:
    """{storage address: bytes} of a tree's tensors (DTensors: their local
    blocks), each storage once."""
    from .sharding import local

    out = {}
    for t in leaves(tree):
        if torch.is_tensor(t):
            st = local(t).untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def memory_stats(peak: int, args, result) -> Dict[str, int]:
    """The reference's ``memory_analysis`` fields from the peak of live
    bytes (``LiveBytes``) over a step run on ``args``: argument
    (parameters, optimizer state, batch, caches), output (the result's new
    tensors), alias (the result's tensors that are arguments, updated in
    place), temp (the peak beyond arguments and outputs) and total (the
    peak: argument + temp + output; the aliased bytes are the arguments',
    not counted twice)."""
    arg = _storages(args)
    res = _storages(result)
    argument = sum(arg.values())
    output = sum(v for k, v in res.items() if k not in arg)
    alias = sum(v for k, v in res.items() if k in arg)
    total = max(peak, argument + output)
    return {
        "argument_size_in_bytes": argument,
        "output_size_in_bytes": output,
        "alias_size_in_bytes": alias,
        "temp_size_in_bytes": total - argument - output,
        "total": total,
    }


def _parse_overrides(pairs):
    """['score_dtype=bf16', 'microbatches=8'] -> dict with typed values."""
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        if v in ("false", "False"):
            v = False
        out[k] = v
    return out


def fake_args(plan):
    """The arguments of a plan over a mesh as fake tensors of this rank's
    blocks (DTensors of the plan's placements over a mesh of more than one
    rank), from the plan's meta trees; call under ``FakeTensorMode``."""
    from . import sharding as sh

    split = plan.mesh.size() > 1

    def block(spec: torch.Tensor, s) -> torch.Tensor:
        shape = tuple(spec.shape)
        local = list(shape)
        for d, i in sh.dim_splits(s.mesh, s.spec) if split else ():
            local[d] //= s.mesh.shape[i]
        t = torch.empty(local, dtype=spec.dtype, device=DEVICE)
        return sh.place(t, s, shape) if split else t

    return tuple(tree_map(block, a, s) for a, s in zip(plan.args, plan.in_shardings))


def trace_step(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Tuple[Any, Any, Dict[str, int]]:
    """Build the step plan over ``mesh`` and run its eager step once on fake
    arguments: (plan, ``TraceCost``, memory stats)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from .steps import make_step
    from .trace_cost import trace_cost

    if cfg.use_pallas:
        raise NotImplementedError(
            "use_pallas: the no-cache attention would reach the hand-written flash kernel (flash_attention_sm90 / "
            "flash_attention, kernels/csrc), which is loaded through ctypes and has no fake implementation; "
            "dry-run with use_pallas off")
    plan = make_step(cfg, mesh, shape, device=DEVICE)
    with FakeTensorMode():
        args = fake_args(plan)
        mem = LiveBytes()
        mem.track(leaves(args))
        with mem:
            cost, result = trace_cost(plan.fn, *args)
        stats = memory_stats(mem.peak, args, result)
    return plan, cost, stats


def run_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeConfig], mesh_name: str, tag: str = "",
             overrides=None, mesh_shape: Optional[Tuple[int, ...]] = None, out: Optional[Path] = RESULTS):
    """Trace one cell over a faked job of the mesh's size (``mesh_name`` in
    ``MESHES``, or any name with ``mesh_shape``) and write its record under
    ``out/<mesh_name>/`` (``out=None``: write nothing).  Returns the record,
    or None for a cell the shape does not support."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    sh_cfg = get_shape(shape) if isinstance(shape, str) else shape
    if not cell_supported(cfg, sh_cfg):
        print(f"SKIP {cfg.name} x {sh_cfg.name}: needs sub-quadratic attention")
        return None
    dims = tuple(mesh_shape) if mesh_shape is not None else MESHES[mesh_name]
    chips = math.prod(dims)
    with fake_job(chips):
        mesh = make_mesh(mesh_name, mesh_shape)
        t0 = time.time()
        plan, cost, mem = trace_step(cfg, sh_cfg, mesh)
        t_trace = time.time() - t0
    r = rl.analyze(cfg, sh_cfg, mesh_name, chips, cost, memory_stats=mem)
    rec = json.loads(r.to_json())
    rec.update(
        step=plan.name,
        mesh_shape=list(dims),
        trace_s=round(t_trace, 1),
        ops=cost.ops,
        memory=mem,
        hbm_bytes=HBM_BYTES,
        fits=mem["total"] <= HBM_BYTES,
        rules_variant="default",
        overrides={k: str(v) for k, v in (overrides or {}).items()},
        tag=tag,
    )
    if out is not None:
        outdir = Path(out) / mesh_name
        outdir.mkdir(parents=True, exist_ok=True)
        stem = f"{cfg.name}__{sh_cfg.name}" + (f"__{tag}" if tag else "")
        (outdir / f"{stem}.json").write_text(json.dumps(rec, indent=1))
    print(
        f"OK {mesh_name} {cfg.name} x {sh_cfg.name}: trace={t_trace:.1f}s peak={mem['total'] / 1e9:.2f}GB "
        f"fits={rec['fits']} flops={cost.flops / 1e12:.2f}T coll={cost.coll_bytes / 1e9:.2f}GB "
        f"compute={r.compute_s * 1e3:.2f}ms memory={r.memory_s * 1e3:.2f}ms coll={r.collective_s * 1e3:.2f}ms "
        f"bottleneck={r.bottleneck} useful={r.useful_ratio:.2f} mfu_bound={r.mfu_bound:.3f}"
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(RESULTS), help="results directory (one folder a mesh)")
    ap.add_argument(
        "--override", action="append", default=[],
        help="cfg field override, e.g. --override score_dtype=bf16",
    )
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    records, failed = [], []
    for mesh_name in meshes:
        for a, s in cells:
            try:
                rec = run_cell(a, s, mesh_name, tag=args.tag, overrides=overrides, out=Path(args.out))
                if rec is not None:
                    records.append(rec)
            except Exception as e:  # noqa: BLE001 — report, keep sweeping
                failed.append((mesh_name, a, s, f"{type(e).__name__}: {e}"))
                print(f"FAIL {mesh_name} {a} x {s}: {type(e).__name__}: {e}")
                traceback.print_exc()
            gc.collect()
    if failed:
        raise SystemExit(f"{len(failed)} cells failed: {failed}")
    return records


if __name__ == "__main__":
    main()
