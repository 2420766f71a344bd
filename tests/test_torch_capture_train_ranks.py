"""The train plan's captured step over meshes of two and four gloo ranks on
the CPU: ``StepPlan.jitted()`` of a train plan over a split mesh is a
``CapturedCall`` with the mesh's group, whose first call records every
collective of the step (the backward's included) and checks that every
rank issues the same ones before the capture.

Each job starts its ranks as separate processes (this file run as a script,
``--rank R --world W``) that meet through a ``file://`` init method under
the test's temporary directory; the jobs of world sizes 1, 2 and 4 run side
by side, each under ``JOB_TIMEOUT_S``, beside the JAX package's granite plan
on two fake CPU devices (``test_torch_launch_ranks.JAX_SCRIPT``).  On the
CPU the captured step runs eagerly, and its first call is checked as the
card's warm-up is, so these tests reach the recording, the cross-rank
check and the state a failed check leaves.

- The reduced starcoder2-7b (also without sequence parallelism, where a
  split block enters through ``copy_to``) and granite-moe-1b-a400m (2
  layers, remat ``full``, so the backward recomputes each layer) on (2, 1),
  (1, 2) and (2, 2), two steps each; world size 1 on a (1, 1) mesh is the
  reference.
- The recorded sequence (``CapturedCall.sequence``) is, in order, what the
  step called ``torch.distributed`` for (a second record, by wrapping its
  functions), and its count by operator and group equals one derived from
  the plan: from the placements, each data-axis split of a leaf gathered
  at each use and again in the recompute (remat ``full``), and its
  gradient reduce-scattered once (``_Gather.backward``); the per-leaf
  gradient all-reduces (``allred``), the metrics' and the grad norm's; and
  over ``model`` each sequence-parallel or Megatron Function's forward
  collective at every application and its backward's (``_GatherSeq``:
  reduce-scatter, ``_ScatterSeq``: all-gather, ``_CopyTo``: all-reduce)
  at each application outside a recompute, plus the helpers' own
  (``all_gather``, ``all_reduce``, ``mean_value``), counted as the step
  runs.
- The steps' metrics, first gradients and parameters equal world size 1's
  (starcoder2 on every mesh, granite on (1, 2)) and the JAX plan's
  (granite on (2, 1) and (1, 2)) at ``test_torch_launch_ranks``'s
  tolerances.
- A rank whose step issues one more collective raises ``CaptureError``
  naming ``train_step`` on every rank, and every rank's parameters and
  AdamW state are then as they were before the call.
"""

import argparse
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from collections import Counter
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_launch_ranks import (  # noqa: E402
    JAX_SCRIPT,
    JAX_TOL,
    METRIC_TOL,
    RANK_TOL,
    TP_TOL,
    B,
    S,
    _inputs,
)

JOB_TIMEOUT_S = 240
STEPS = 2
# name: (configuration, changes); without sequence parallelism a split
# block enters through ``copy_to``, whose backward all-reduces over ``model``
ARCHS = {"starcoder2-7b": ("starcoder2-7b", {}), "starcoder2-7b_nosp": ("starcoder2-7b", {"seq_parallel": False}),
         "granite": ("granite-moe-1b-a400m", {})}
MESHES = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 4: [(2, 2)]}
# torch.distributed's functions and the c10d operators they reach
C10D = {"all_gather_into_tensor": "_allgather_base_", "reduce_scatter_tensor": "_reduce_scatter_base_",
        "all_reduce": "allreduce_", "all_gather_object": "all_gather_object"}
AG, RS, AR = "_allgather_base_", "_reduce_scatter_base_", "allreduce_"
ROOT = Path(__file__).resolve().parents[1]


def _cfg(name):
    from repro_torch.configs import ARCHS as TARCHS

    arch, kw = ARCHS[name]
    return dataclasses.replace(TARCHS[arch].reduced(), remat="full", **kw)


def _desc(group):
    from repro_torch.core.executors.captured import group_desc

    return group_desc(group)


def _whole(x):
    from torch.distributed.tensor import DTensor

    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.detach().float().numpy().copy()  # a replicated leaf's full_tensor() is its storage


class _Calls:
    """The collectives ``torch.distributed``'s functions are called for, in
    order, from any thread: (c10d operator, dtype, group)."""

    def __init__(self, mp):
        self.calls = []
        for name, op in C10D.items():
            mp.setattr(dist, name, self._wrap(op, getattr(dist, name)))

    def _wrap(self, op, fn):
        def call(*args, **kw):
            t = next((a for a in args if torch.is_tensor(a)), None)
            if t is None and isinstance(args[0], list) and args[0] and torch.is_tensor(args[0][0]):
                t = args[0][0]
            group = kw.get("group") or dist.group.WORLD
            self.calls.append((op, None if t is None else str(t.dtype), _desc(group)))
            return fn(*args, **kw)

        return call

    def take(self):
        calls, self.calls = self.calls, []
        return calls


class _Applications:
    """The collectives over ``model`` that the model's SPMD Functions and
    helpers issue, counted where they are applied: each Function's forward
    collective at every application (the recompute's too), its backward's
    at each application outside a recompute (a recomputed graph is not
    differentiated), each helper's one."""

    def __init__(self, mp):
        from repro_torch.models import attention, model, moe, spmd

        self.counts, self.functions = Counter(), Counter()
        for cls, fwd, bwd in ((spmd._GatherSeq, AG, RS), (spmd._ScatterSeq, RS, AG), (spmd._CopyTo, None, AR),
                              (spmd._ReduceFrom, AR, None)):
            mp.setattr(cls, "forward", staticmethod(self._function(cls.forward, fwd, bwd)))
        for mod in (attention, model, moe):
            for name, op in (("all_gather", AG), ("all_reduce", AR), ("mean_value", AR)):
                if hasattr(mod, name):
                    mp.setattr(mod, name, self._helper(getattr(mod, name), op))

    def _function(self, fn, fwd, bwd):
        def forward(ctx, x, group, *rest):
            self.functions[fn.__qualname__.split(".")[0]] += 1
            if fwd:
                self.counts[(fwd, _desc(group))] += 1
            if bwd and torch._C._current_graph_task_id() == -1:  # not inside the backward's recompute
                self.counts[(bwd, _desc(group))] += 1
            return fn(ctx, x, group, *rest)

        return forward

    def _helper(self, fn, op):
        def call(*args, **kw):
            group = next(a for a in args if isinstance(a, dist.ProcessGroup))
            self.counts[(op, _desc(group))] += 1
            return fn(*args, **kw)

        return call


def _derived(cfg, plan, mesh, applied: Counter) -> Counter:
    """The step's collectives by (operator, group), derived from the plan's
    placements (module docstring) and ``applied`` (``_Applications``)."""
    from repro_torch.launch import sharding as sh

    names, sizes = sh.mesh_names(mesh), tuple(mesh.shape)
    desc = [_desc(mesh.get_group(i)) if sizes[i] > 1 else None for i in range(len(names))]
    m = names.index("model")
    red = [i for i, a in enumerate(names) if a in sh.train_rules(cfg).lookup("batch") and sizes[i] > 1]
    sp = sizes[m] > 1 and cfg.seq_parallel and S % sizes[m] == 0
    sums = red + [m] * sp
    out = Counter()
    for name, s in plan.in_shardings[0].items():
        split = {i for _, i in sh.dim_splits(mesh, s.spec) if sizes[i] > 1}
        uses = 2 if name == "embed" and cfg.tie_embeddings else 1  # the embedding and the tied head
        again = cfg.remat == "full" and name.startswith("stack.")
        for i in split - {m}:  # gathered at each use; the model block is used as it lies
            out[(AG, desc[i])] += uses * (1 + again)
            out[(RS, desc[i])] += uses
        for i in sums:
            if i not in split:  # the gradient rule (launch/steps.py allred)
                out[(AR, desc[i])] += 1
    for i in red:  # the metrics
        out[(AR, desc[i])] += 1
    for i, n in enumerate(sizes):  # the grad norm
        if n > 1:
            out[(AR, desc[i])] += 1
    out.update(applied)
    return out


def _setup(mesh, name, work: Path):
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model, to_port

    cfg = _cfg(name)
    plan = st.make_train_step(cfg, mesh, ShapeConfig("t", S, B, "train"), device="cpu")
    if cfg.n_experts:
        full = to_port(cfg, pickle.loads((work / "granite_params.pkl").read_bytes()), device="cpu")
    else:
        full = build_model(cfg, device="cpu", train=True).train_params()
    ps, _, bs = plan.in_shardings
    P, O = st.train_state(plan, {k: sh.shard(v.detach(), ps[k]).clone() for k, v in full.items()},
                          optim.AdamWConfig(state_dtype=cfg.optim_state_dtype))
    batch = st.place_params({k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}, bs)
    return cfg, plan, P, O, batch


def _train(mesh, name, work: Path):
    """Two steps of the plan's ``jitted()``: what its first call recorded
    and checked, what each call called ``torch.distributed`` for, the count
    derived from the plan, and the results."""
    from repro_torch.core.executors import captured
    from repro_torch.core.executors.sharded import mesh_group

    cfg, plan, P, O, batch = _setup(mesh, name, work)
    step = plan.jitted()
    agreed = []
    agree = captured.agree
    out = {"metrics": [], "calls": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(captured, "agree", lambda seq, group, name, device: (
            agreed.append((name, list(seq), _desc(group))), agree(seq, group, name, device))[1])
        calls = _Calls(mp)
        applied = _Applications(mp)
        for i in range(STEPS):
            P2, O2, met = step(P, O, batch)
            assert P2 is P and O2 is O
            out["calls"].append(calls.take())
            out["metrics"].append({k: float(v) for k, v in met.items()})
            if i == 0:
                out["grads"] = {k: _whole(v) / 0.1 for k, v in O["m"].items()}  # (1 - b1) g
                out["params1"] = {k: _whole(v) for k, v in P.items()}
                out["applied"], out["functions"] = Counter(applied.counts), Counter(applied.functions)
    split = mesh.size() > 1
    out.update(
        params={k: _whole(v) for k, v in P.items()}, agreed=agreed, compiles=step.compiles,
        eager=hasattr(step, "eager"), group=_desc(step.group) if step.group is not None else None,
        mesh_group=_desc(mesh_group(mesh)) if split else None, sequence=step.sequence,
        derived=_derived(cfg, plan, mesh, out["applied"]) if split else None,
    )
    return out


def _mismatch(mesh, work: Path):
    """The starcoder2 step with one more collective on rank 1 (an all-reduce
    over a group of rank 1 alone, so that nothing waits on it): the error
    each rank raises (None if none), and whether every leaf of its state
    is then as before the call."""
    from repro_torch.core.executors import CaptureError
    from repro_torch.launch import sharding as sh
    from repro_torch.tree import leaves

    solo = dist.new_group([1])  # every rank makes it, rank 1 alone uses it
    _, plan, P, O, batch = _setup(mesh, "starcoder2-7b", work)
    fn = plan.fn

    def more(*args):
        out = fn(*args)
        if dist.get_rank() == 1:
            dist.all_reduce(torch.zeros(1), group=solo)
        return out

    before = [sh.local(x).clone() for x in leaves((P, O))]
    msg = None
    try:
        dataclasses.replace(plan, fn=more).jitted()(P, O, batch)
    except CaptureError as e:
        msg = str(e)
    return {"error": msg, "kept": all(torch.equal(sh.local(x), b) for x, b in zip(leaves((P, O)), before))}


def _rank_main(rank: int, world: int, init: str, work: str, out: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)  # the jobs' ranks share the worker's cores
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=JOB_TIMEOUT_S))
    t0 = time.perf_counter()
    try:
        res = {"train": {}}
        for shape in MESHES[world]:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            for name in ARCHS:
                res["train"][(shape, name)] = _train(mesh, name, Path(work))
        if world > 1:
            res["mismatch"] = _mismatch(init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model")),
                                        Path(work))
        res["seconds"] = time.perf_counter() - t0
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _start(world: int, tmp: Path, work: Path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    outs = [tmp / f"rank{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--world", str(world),
                               "--init", str(tmp / "init"), "--work", str(work), "--out", str(outs[r])],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, outs


def _finish(world: int, procs, outs):
    deadline = time.monotonic() + JOB_TIMEOUT_S
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"world size {world}: the ranks did not finish within {JOB_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"world size {world}, rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [pickle.loads(o.read_bytes()) for o in outs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's ranks, beside the JAX package's granite plan on two fake
    devices (the same parameters and batch)."""
    import jax

    from repro.configs import ARCHS as JARCHS
    from repro.models import build_model as jbuild

    work = tmp_path_factory.mktemp("work")
    jcfg = JARCHS[ARCHS["granite"][0]].reduced()
    params = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    (work / "granite_params.pkl").write_bytes(pickle.dumps(params))
    (work / "granite_batch.pkl").write_bytes(pickle.dumps(_inputs(_cfg("granite"))))
    jobs = {w: _start(w, tmp_path_factory.mktemp(f"world{w}"), work) for w in MESHES}
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(work)], env=env, cwd=str(ROOT),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        log = jax_proc.communicate(timeout=300)[0]
    finally:
        done = {w: _finish(w, *jobs[w]) for w in jobs}
    assert jax_proc.returncode == 0, log[-4000:]
    done["jax"] = pickle.loads((work / "jax.pkl").read_bytes())
    return done


CELLS = [(w, shape, name) for w in (2, 4) for shape in MESHES[w] for name in ARCHS]


def _ranks(runs, world, shape, name):
    return [res["train"][(shape, name)] for res in runs[world]]


@pytest.mark.parametrize("world,shape,name", CELLS)
def test_train_plan_over_a_mesh_is_a_captured_call_with_the_mesh_group(runs, world, shape, name):
    """``jitted()`` has no eager form and holds the mesh's group; its first
    call checks one sequence on every rank, named ``train_step``, the same
    sequence it keeps; it compiles once.  At world size 1 it has no group
    and checks nothing."""
    (one,) = runs[1]
    ref = one["train"][((1, 1), name)]
    assert ref["group"] is None and ref["agreed"] == [] and ref["sequence"] is None and not ref["eager"]
    ranks = _ranks(runs, world, shape, name)
    for got in ranks:
        assert not got["eager"]
        assert got["group"] == got["mesh_group"] == (world, tuple(range(world)))
        assert got["compiles"] == 1
        assert [(n, g) for n, _, g in got["agreed"]] == [("train_step", got["group"])]
        assert got["agreed"][0][1] == got["sequence"]
        assert got["sequence"] == ranks[0]["sequence"]


@pytest.mark.parametrize("world,shape,name", CELLS)
def test_recorded_sequence_holds_the_backward_collectives(runs, world, shape, name):
    """The recorded sequence is, in order, what the first call called
    ``torch.distributed`` for before its check (whose ``all_gather_object``
    comes last), the second call calls the same, and its count by
    operator and group equals the one derived from the plan: the
    backward's reduce-scatters (``_Gather.backward`` and, over ``model``
    under sequence parallelism, ``_GatherSeq``'s) or, over ``model``
    alone without it, ``_CopyTo``'s all-reduces among them."""
    for got in _ranks(runs, world, shape, name):
        seq = [(op.split(".")[0], dtype, group) for op, dtype, group in got["sequence"]]
        first, second = got["calls"]
        assert first[-1][0] == "all_gather_object" and first[:-1] == seq
        assert second == seq
        counts = Counter((op, group) for op, _, group in seq)
        assert counts == got["derived"]
        # the backward's: reduce-scatters (a data split, or sequence parallelism), else _CopyTo's all-reduces
        assert sum(n for (op, _), n in counts.items() if op == RS) > 0 or got["functions"]["_CopyTo"] > 0


def test_derived_count_has_each_kind_of_collective(runs):
    """Across the meshes the derivation reaches every kind the step
    issues: the data axis's gathers, again in the recompute, and their
    reduce-scatters (the placements); the gradient, metric and grad-norm
    all-reduces; over ``model`` the sequence-parallel pairs and, without
    sequence parallelism, ``_CopyTo``'s backward all-reduces."""
    (r0,) = runs[4][:1]
    both = r0["train"][((2, 2), "starcoder2-7b")]
    data, model = (2, (0, 2)), (2, (0, 1))
    # remat ``full`` gathers every layer leaf twice: more gathers than reduce-scatters
    assert both["derived"][(AG, data)] > both["derived"][(RS, data)] > 0
    assert both["derived"][(AR, data)] > 0 and both["derived"][(AR, model)] > 0
    assert both["functions"]["_GatherSeq"] > 0 and both["functions"]["_ScatterSeq"] > 0
    plain = r0["train"][((2, 2), "starcoder2-7b_nosp")]
    assert plain["functions"]["_CopyTo"] > 0 and plain["functions"]["_GatherSeq"] == 0
    assert plain["applied"][(AR, model)] >= plain["functions"]["_CopyTo"]


@pytest.mark.parametrize("world,shape,name", [c for c in CELLS if c[2] != "granite" or c[1] == (1, 2)])
def test_captured_train_step_matches_world_size_one(runs, world, shape, name):
    """Each step's metrics, the first gradients and the parameters after
    the steps equal world size 1's (granite on (1, 2) only: on a data
    split each shard's tokens route with capacity sized on the shard)."""
    (one,) = runs[1]
    want = one["train"][((1, 1), name)]
    tol = TP_TOL if shape[1] > 1 else RANK_TOL
    for got in _ranks(runs, world, shape, name):
        for g, w in zip(got["metrics"], want["metrics"]):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], err_msg=k, **METRIC_TOL)
        for k in want["grads"]:
            np.testing.assert_allclose(got["grads"][k], want["grads"][k], err_msg=k, **RANK_TOL)
        for k in want["params"]:
            np.testing.assert_allclose(got["params"][k], want["params"][k], err_msg=k, **tol)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_captured_granite_step_matches_the_jax_plan(runs, shape):
    """The first step's loss and every parameter after it equal the JAX
    package's plan on two fake devices (an Auto-axis mesh), at
    ``JAX_TOL``; the step here runs with remat ``full``, the reference's
    without."""
    import jax

    from repro_torch.models import to_jax

    want = runs["jax"][shape]
    cfg = _cfg("granite")
    for res in runs[2]:
        got = res["train"][(shape, "granite")]
        np.testing.assert_allclose(got["metrics"][0]["loss"], want["loss"], **JAX_TOL)
        tree = to_jax(cfg, {k: torch.from_numpy(v) for k, v in got["params1"].items()})
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want["params"])):
            np.testing.assert_allclose(a, np.asarray(b, np.float32), **JAX_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_a_rank_with_other_collectives_raises_before_any_update(runs, world):
    """One more collective on rank 1: every rank raises ``CaptureError``
    naming ``train_step`` and rank 1, and every rank's parameters and
    AdamW state are as they were before the call."""
    for res in runs[world]:
        got = res["mismatch"]
        assert got["error"] is not None and got["error"].startswith("train_step: ")
        assert "rank 1 issues another collective sequence than rank 0" in got["error"]
        assert got["kept"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of a test job")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--work", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    _rank_main(args.rank, args.world, args.init, args.work, args.out)
