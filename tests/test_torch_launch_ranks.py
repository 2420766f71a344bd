"""The port's plans over meshes of two and four gloo ranks on the CPU.

Each job starts its ranks as separate processes (this file run as a script,
``--rank R --world W --mesh DxM``) that meet through a ``file://`` init
method under the test's temporary directory, run every case on a
``DeviceMesh`` of that shape and write their results to a file; a job has
its own time limit (``JOB_TIMEOUT_S``) and fails, killing its ranks,
instead of hanging.  Jobs run in the order (2, 1), (1, 1), (1, 2), (2, 2),
(1, 4): the (2, 1) job writes a checkpoint and a trainer's checkpoints that
the later ones restore.

World size 1 (a (1, 1) mesh: plain tensors, nothing gathered) is the
reference for the train, prefill and decode plans on reduced float32
configurations: every rank's gathered result agrees with it to
``RANK_TOL`` (the same fp32 arithmetic; gradient sums over the ranks in
another order), the step's metrics to ``METRIC_TOL`` (the gradient norm
sums the squares of each rank's blocks: rwkv6's, at 338, moves by 1.1e-5
relative), and a ``Trainer``'s parameters after three steps at lr 1e-3
to ``JAX_TOL`` (Adam divides each gradient element by its own size plus
eps, so an element near 0 moves apart: one embedding element of 16384
ends 3.1e-6 apart).  Where the ``model`` axis is larger than one the
ranks split the products over it (``models/spmd.py``): the row-parallel
products' partial sums, the vocab-split loss and the attention over a
cache split on seq round in another order than one device's single
products, so each leaf's first-step gradient is held to ``RANK_TOL`` on
every mesh, and there the parameters after the steps to ``TP_TOL`` and the
served logits and caches to ``TP_SERVE_TOL``, each a few times the largest
reading on the CPU: the parameters need atol 3.0e-6 at rtol 1e-4 (zamba2's
``mamba.wo``), the served results atol 2.5e-5 at rtol 1e-4 (zamba2's
Mamba2 state, whose elements reach 534 and which lies 4.2e-7 relative L2
from world size 1's), both read while the Mamba2 mixers ran whole on every
rank.  zamba2 runs in float64 (``F64``): its Mamba2 mixers split by heads
over ``model``, and the reduced model's first layers amplify a float32
rounding a thousandfold (one device's own first-step embedding gradient
moves past ``RANK_TOL`` in 2 elements under a relative noise of 1e-8 on
the parameters, in 280 under 3e-8), so in float32 these checks would
read the configuration's conditioning, not the split.  In float64 the
same tolerances hold the split's logic (the Mamba2 scan itself runs in
float32 in both packages, on the same inputs).  granite-moe-1b-a400m on (2, 1) routes each data shard's
tokens with capacity sized on the shard (the reference's ``_moe_ep``), so
there it is held against the JAX package's plan on two fake CPU devices
(an Auto-axis mesh in a subprocess with ``XLA_FLAGS=
--xla_force_host_platform_device_count=2``), as on (1, 2): the loss and
every leaf after one step to ``JAX_TOL``, the tolerance of
``tests/test_torch_train.py``'s train steps.
"""

import argparse
import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

JOB_TIMEOUT_S = 120
MESHES = ((2, 1), (1, 1), (1, 2), (2, 2), (1, 4))
B, S = 4, 16
RANK_TOL = dict(rtol=1e-5, atol=1e-6)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
JAX_TOL = dict(rtol=2e-4, atol=2e-5)
# where model > 1 (module docstring): the state after Adam steps, and served results
TP_TOL = dict(rtol=1e-4, atol=1e-5)
TP_SERVE_TOL = dict(rtol=1e-4, atol=5e-5)
F64 = {"compute_dtype": torch.float64, "param_dtype": torch.float64, "optim_state_dtype": torch.float64,
       "cache_dtype": torch.float64}
# (arch, steps, config changes): remat "full" gathers inside the
# rematerialised group, so the recompute gathers again
TRAIN_CASES = {
    "qwen3-32b": (2, {"remat": "full"}),
    "qwen3-32b_m2": (2, {"microbatches": 2}),
    "zamba2-2.7b": (2, {"remat": "full", **F64}),
    "rwkv6-3b": (2, {}),
    "gemma3-12b": (2, {}),
    "granite-moe-1b-a400m": (2, {"remat": "full"}),
}
DECODE_ARCHS = ("starcoder2-7b", "zamba2-2.7b")
SERVE_KW = {"zamba2-2.7b": F64}
GRANITE = "granite-moe-1b-a400m"
ROOT = Path(__file__).resolve().parents[1]


def _cfg(arch, **kw):
    import dataclasses

    from repro_torch.configs import ARCHS

    return dataclasses.replace(ARCHS[arch.split("_")[0]].reduced(), **kw)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        out = {"embeds": (rng.standard_normal((B, S, cfg.d_model)) * 0.1).astype(np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    out["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return out


def _whole(x):
    from torch.distributed.tensor import DTensor

    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.detach().float().numpy()


def _train(mesh, arch, steps, kw, params=None):
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model

    cfg = _cfg(arch, **kw)
    plan = st.make_train_step(cfg, mesh, ShapeConfig("t", S, B, "train"), device="cpu")
    full = params if params is not None else build_model(cfg, device="cpu", train=True).train_params()
    ps, _, bs = plan.in_shardings
    P, O = st.train_state(plan, {k: sh.shard(v.detach(), ps[k]).clone() for k, v in full.items()},
                          optim.AdamWConfig(state_dtype=cfg.optim_state_dtype))
    batch = st.place_params({k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}, bs)
    step = plan.jitted()
    metrics, grads = [], None
    for _ in range(steps):
        P2, O2, met = step(P, O, batch)
        assert P2 is P and O2 is O
        metrics.append({k: float(v) for k, v in met.items()})
        if grads is None:  # Adam's first moment after the first step: (1 - b1) g
            grads = {k: _whole(v) / 0.1 for k, v in O["m"].items()}
    split = {k: (sh.local(v).numel(), v.numel(), ps[k]) for k, v in P.items()}
    return {"metrics": metrics, "grads": grads, "params": {k: _whole(v) for k, v in P.items()},
            "compiles": step.compiles,
            "local": {k: (n, t, sh.is_split(s) and [sh.mesh_names(mesh)[i] for _, i in sh.dim_splits(mesh, s.spec)])
                      for k, (n, t, s) in split.items()}}


def _serve(mesh, arch):
    """starcoder2-7b (use_pallas on; a prefill into a cache attends without
    the flash kernel, as the reference's) and zamba2: a prefill of B x S,
    then four greedy decode steps from an empty cache of 2 S."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model

    cfg = _cfg(arch, use_pallas=True, **SERVE_KW.get(arch, {}))
    model = build_model(cfg, device="cpu")
    params = {k: v.detach() for k, v in model.train_params().items()}
    out = {}
    toks = torch.from_numpy(_inputs(cfg)["tokens"])
    pre = st.make_prefill_step(cfg, mesh, ShapeConfig("p", S, B, "prefill"), device="cpu")
    dec = st.make_decode_step(cfg, mesh, ShapeConfig("d", 2 * S, B, "decode"), device="cpu")
    for name, plan in (("prefill", pre), ("decode", dec)):
        if mesh.size() > 1:
            p_shard, *_ = plan.in_shardings
            P = st.place_params(params, p_shard)
        else:
            P = params
        cache = st.cache_specs(cfg, B, S if name == "prefill" else 2 * S)
        cache = _tree(lambda c: torch.zeros(c.shape, dtype=c.dtype), cache)
        c_shard = plan.in_shardings[2 if name == "prefill" else 1]
        b_shard = plan.in_shardings[1 if name == "prefill" else 2]
        if mesh.size() > 1:
            cache = st.place_params(cache, c_shard)
        fn = plan.jitted()
        if name == "prefill":
            batch = {"tokens": toks}
            batch = st.place_params(batch, b_shard) if mesh.size() > 1 else batch
            logits, cache = fn(P, batch, cache)
            out["prefill"] = {"logits": _whole(logits), "cache": _tree(_whole, cache)}
        else:
            tok = toks[:, :1]
            seq = []
            for pos in range(4):
                batch = {"tokens": tok}
                batch = st.place_params(batch, b_shard) if mesh.size() > 1 else batch
                logits, cache = fn(P, cache, batch, torch.tensor(pos, dtype=torch.int32))
                full = torch.from_numpy(_whole(logits))
                seq.append(full.numpy())
                tok = full.argmax(-1, keepdim=True).to(torch.int32)
            out["decode"] = {"logits": np.stack(seq), "cache": _tree(_whole, cache)}
    return out


def _tree(fn, tree):
    from repro_torch.tree import tree_map

    return tree_map(fn, tree)


def _checkpoint_cases(mesh, res, ckpt_dir: Path):
    """(2, 1) saves its trained qwen3 state (every rank gathers, rank 0
    writes); every later job restores it onto its own mesh."""
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model
    from repro_torch.train import Checkpointer

    cfg = _cfg("qwen3-32b")
    plan = st.make_train_step(cfg, mesh, ShapeConfig("t", S, B, "train"), device="cpu")
    ck = Checkpointer(str(ckpt_dir / "plain"))
    shape = tuple(mesh.shape)
    if shape == (2, 1):
        full = build_model(cfg, device="cpu", train=True).train_params()
        ps = plan.in_shardings[0]
        from repro_torch.launch import sharding as sh

        P, O = st.train_state(plan, {k: sh.shard(v.detach(), ps[k]).clone() for k, v in full.items()},
                              optim.AdamWConfig())
        step = plan.jitted()
        step(P, O, st.place_params({k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}, plan.in_shardings[2]))
        ck.save(7, {"params": P, "opt": O})
        res["saved"] = {"params": {k: _whole(v) for k, v in P.items()},
                        "m": {k: _whole(v) for k, v in O["m"].items()}}
    dist.barrier()
    target = {"params": plan.args[0], "opt": plan.args[1]}
    shardings = None if mesh.size() == 1 else {"params": plan.in_shardings[0], "opt": plan.in_shardings[1]}
    state, step_no = ck.restore(target, device="cpu", shardings=shardings)
    res["restored"] = {"step": step_no, "params": {k: _whole(v) for k, v in state["params"].items()},
                       "m": {k: _whole(v) for k, v in state["opt"]["m"].items()},
                       "local": {k: _local_numel(v) for k, v in state["params"].items()}}


def _local_numel(x):
    from repro_torch.launch import sharding as sh

    return sh.local(x).numel()


def _trainer_cases(mesh, res, ckpt_dir: Path):
    """qwen3 ``Trainer``: (2, 1) trains 2 steps (a checkpoint at 2); (1, 2)
    resumes it on its own mesh and trains the third; (1, 1) trains 3 steps
    straight."""
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = _cfg("qwen3-32b")
    shape = tuple(mesh.shape)
    d = str(ckpt_dir / ("trainer_one" if shape == (1, 1) else "trainer"))
    steps = {(2, 1): 2, (1, 1): 3, (1, 2): 3}.get(shape)
    if steps is None:
        return
    tr = Trainer(cfg, ShapeConfig("t", S, B, "train"), mesh,
                 TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=d, log_every=100),
                 opt_cfg=optim.AdamWConfig(lr=1e-3), device="cpu")
    out = tr.train()
    res["trainer"] = {"step": out["step"], "losses": [m["loss"] for m in out["metrics"]],
                      "params": {k: _whole(v) for k, v in out["params"].items()}}
    if shape == (2, 1):
        init = Trainer(cfg, ShapeConfig("t", S, B, "train"), mesh, TrainerConfig(ckpt_dir=str(ckpt_dir / "x")),
                       device="cpu").init_state()[0]
        res["trainer_init"] = {k: _whole(v) for k, v in init.items()}


def _batches(mesh, res):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset, sharded_batches
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st

    cfg = _cfg("qwen3-32b")
    plan = st.make_train_step(cfg, mesh, ShapeConfig("t", S, B, "train"), device="cpu")
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=3))
    it = sharded_batches(ds, "cpu", start_index=5, shardings=plan.in_shardings[2])
    got = [next(it) for _ in range(2)]
    res["batches"] = [{k: sh.local(v).numpy() for k, v in b.items()} for b in got]
    res["batches_whole"] = [{k: _whole(v) for k, v in b.items()} for b in got]


def _rank_main(rank: int, world: int, mesh_shape, init: str, out: str, work: str, case: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import to_port

    torch.set_num_threads(1)  # four ranks share the worker's cores
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=JOB_TIMEOUT_S))
    t0 = time.perf_counter()
    try:
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
        work = Path(work)
        if case != "plans":
            return _fault_main(rank, mesh, work, case, out)
        jparams = pickle.loads((work / "granite_params.pkl").read_bytes())
        res = {"coord": mesh.get_coordinate(), "train": {}}
        for name, (steps, kw) in TRAIN_CASES.items():
            params = to_port(_cfg(name), jparams, device="cpu") if name == GRANITE else None
            res["train"][name] = _train(mesh, name, steps, kw, params)
        g1 = _train(mesh, GRANITE, 1, {}, to_port(_cfg(GRANITE), jparams, device="cpu"))
        res["granite_one_step"] = g1
        res["serve"] = {arch: _serve(mesh, arch) for arch in DECODE_ARCHS}
        _checkpoint_cases(mesh, res, work)
        _trainer_cases(mesh, res, work)
        _batches(mesh, res)
        res["seconds"] = time.perf_counter() - t0
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _fault_main(rank: int, mesh, work: Path, case: str, out: str) -> None:
    """A qwen3 ``Trainer`` on (2, 1), as ``_trainer_cases``' (1, 1) one.
    ``fail``: 3 steps, a checkpoint at 2, the third step failing on rank 1
    alone (the trainer re-raises; rank 0's collectives then fail).
    ``resume``: the restarted job resumes at 2 and trains the third; then a
    trainer of 4 steps whose rank 1 alone is sent SIGTERM after step 1."""
    import signal

    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = _cfg("qwen3-32b")

    def trainer(d, steps):
        return Trainer(cfg, ShapeConfig("t", S, B, "train"), mesh,
                       TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=str(work / d), log_every=100),
                       opt_cfg=optim.AdamWConfig(lr=1e-3), device="cpu")

    if case == "fail":
        trainer("trainer_fail", 3).train(inject_failure=lambda step: rank == 1 and step == 2)
        raise AssertionError("the failed step did not raise")
    got = trainer("trainer_fail", 3).train()
    res = {"trainer": {"step": got["step"], "losses": [m["loss"] for m in got["metrics"]],
                       "params": {k: _whole(v) for k, v in got["params"].items()}}}
    tr = trainer("trainer_preempt", 4)
    got = tr.train(on_metrics=lambda step, m: rank == 1 and step == 1 and os.kill(os.getpid(), signal.SIGTERM))
    res["preempt"] = {"step": got["step"], "saved": tr.ckpt.all_steps()}
    with open(out, "wb") as f:
        pickle.dump(res, f)


def _launch(shape, tmp: Path, work: Path, case: str = "plans"):
    """Runs one job's ranks; [(exit code, log, result file)] by rank."""
    world = shape[0] * shape[1]
    src = str(ROOT / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH", "")]))
    outs = [tmp / f"rank{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--world", str(world),
                               "--mesh", f"{shape[0]}x{shape[1]}", "--init", str(tmp / "init"),
                               "--out", str(outs[r]), "--work", str(work), "--case", case],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + JOB_TIMEOUT_S
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"mesh {shape}, {case}: the ranks did not finish within {JOB_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, log, o) for p, log, o in zip(procs, logs, outs)]


def _job(shape, tmp: Path, work: Path, case: str = "plans"):
    ranks = _launch(shape, tmp, work, case)
    for r, (rc, log, _) in enumerate(ranks):
        assert rc == 0, f"mesh {shape}, {case}, rank {r} exited {rc}:\n{log[-4000:]}"
    return [pickle.loads(o.read_bytes()) for *_, o in ranks]


JAX_SCRIPT = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import optim
from repro.configs import ARCHS
from repro.configs.base import ShapeConfig
from repro.data.pipeline import DataConfig, SyntheticLMDataset, make_global_array
from repro.launch.steps import make_train_step
work = sys.argv[1]
params = pickle.load(open(f"{work}/granite_params.pkl", "rb"))
batch = pickle.load(open(f"{work}/granite_batch.pkl", "rb"))
cfg = ARCHS["granite-moe-1b-a400m"].reduced()
out = {}
for shape in ((2, 1), (1, 2)):
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    plan = make_train_step(cfg, mesh, ShapeConfig("t", %d, %d, "train"))
    p = jax.tree.map(jnp.asarray, params)
    o = optim.init(p, optim.AdamWConfig(state_dtype=cfg.optim_state_dtype))
    with mesh:
        p2, o2, met = plan.jitted()(p, o, jax.tree.map(jnp.asarray, batch))
    out[shape] = {"loss": float(met["loss"]), "params": jax.tree.map(np.asarray, p2)}
mesh = jax.make_mesh((2, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=%d, global_batch=%d, seed=3))
shards = []
for i in (5, 6):
    arr = make_global_array(ds.batch(i)["tokens"], NamedSharding(mesh, P("data", None)))
    shards.append([np.asarray(s.data) for s in sorted(arr.addressable_shards, key=lambda s: s.index[0].start)])
out["shards"] = shards
pickle.dump(out, open(f"{work}/jax.pkl", "wb"))
""" % (S, B, S, B)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import ARCHS as JARCHS
    from repro.models import build_model as jbuild

    work = tmp_path_factory.mktemp("work")
    jcfg = JARCHS[GRANITE].reduced()
    params = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    (work / "granite_params.pkl").write_bytes(pickle.dumps(params))
    (work / "granite_batch.pkl").write_bytes(pickle.dumps(_inputs(_cfg(GRANITE))))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(work)], env=env, cwd=str(ROOT),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {shape: _job(shape, tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}"), work) for shape in MESHES}
    log = jax_proc.communicate(timeout=300)[0]
    assert jax_proc.returncode == 0, log[-4000:]
    out["jax"] = pickle.loads((work / "jax.pkl").read_bytes())
    return out


@pytest.fixture(scope="module")
def faults(tmp_path_factory):
    """The (2, 1) trainer job failing on rank 1, then its restart."""
    work = tmp_path_factory.mktemp("faults")
    failed = _launch((2, 1), tmp_path_factory.mktemp("fail"), work, "fail")
    resumed = _job((2, 1), tmp_path_factory.mktemp("resume"), work, "resume")
    return failed, resumed


def _close(got, want, tol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _state_tol(mesh):
    """The tolerance of the state after the steps (module docstring)."""
    return TP_TOL if mesh[1] > 1 else RANK_TOL


def _serve_tol(mesh):
    """The tolerance of served logits and caches (module docstring)."""
    return TP_SERVE_TOL if mesh[1] > 1 else RANK_TOL


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("name", [n for n in TRAIN_CASES if n != GRANITE])
def test_train_plan_matches_world_size_one(runs, mesh, name):
    (one,) = runs[(1, 1)]
    want = one["train"][name]
    for res in runs[mesh]:
        got = res["train"][name]
        for g, w in zip(got["metrics"], want["metrics"]):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], err_msg=k, **METRIC_TOL)
        _close(got["grads"], want["grads"], RANK_TOL)
        _close(got["params"], want["params"], _state_tol(mesh))
        assert got["compiles"] == 1


def test_granite_on_the_model_axis_matches_world_size_one(runs):
    """EP over (1, 2) and (1, 4): each model rank runs its experts on every
    token (capacity sized on the same tokens), so the step is world size
    1's."""
    (one,) = runs[(1, 1)]
    want = one["train"][GRANITE]
    for res in runs[(1, 2)] + runs[(1, 4)]:
        got = res["train"][GRANITE]
        np.testing.assert_allclose(got["metrics"][-1]["loss"], want["metrics"][-1]["loss"], **RANK_TOL)
        _close(got["grads"], want["grads"], RANK_TOL)
        _close(got["params"], want["params"], TP_TOL)


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)])
def test_granite_matches_the_jax_plan_on_two_devices(runs, mesh):
    from repro_torch.models import to_jax

    want = runs["jax"][mesh]
    cfg = _cfg(GRANITE)
    import jax

    for res in runs[mesh]:
        got = res["granite_one_step"]
        np.testing.assert_allclose(got["metrics"][0]["loss"], want["loss"], **JAX_TOL)
        tree = to_jax(cfg, {k: torch.from_numpy(v) for k, v in got["params"].items()})
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want["params"])):
            np.testing.assert_allclose(a, np.asarray(b, np.float32), **JAX_TOL)
    if mesh == (2, 1):  # capacity per data shard: not the one-device step
        one = runs[(1, 1)][0]["granite_one_step"]["metrics"][0]["loss"]
        assert abs(runs[mesh][0]["granite_one_step"]["metrics"][0]["loss"] - one) > 1e-6


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_serve_plans_match_world_size_one(runs, mesh, arch):
    (one,) = runs[(1, 1)]
    for res in runs[mesh]:
        for kind in ("prefill", "decode"):
            got, want = res["serve"][arch][kind], one["serve"][arch][kind]
            np.testing.assert_allclose(got["logits"], want["logits"], **_serve_tol(mesh))
            from repro_torch.tree import leaves

            for a, b in zip(leaves(got["cache"]), leaves(want["cache"])):
                np.testing.assert_allclose(a, b, **_serve_tol(mesh))


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2), (1, 4)])
def test_each_rank_holds_only_its_block(runs, mesh):
    n_split = 0
    for res in runs[mesh]:
        for name, (n, total, axes) in res["train"]["qwen3-32b"]["local"].items():
            prod = int(np.prod([dict(zip(("data", "model"), mesh))[a] for a in axes])) if axes else 1
            assert n * prod == total, name
            n_split += bool(axes)
    assert n_split > 0


def test_sharded_batches_are_the_jax_shards(runs):
    from repro.configs import ARCHS as JARCHS
    from repro.data import pipeline as jpipe

    jcfg = JARCHS["qwen3-32b"].reduced()
    ds = jpipe.SyntheticLMDataset(jpipe.DataConfig(vocab=jcfg.vocab, seq_len=S, global_batch=B, seed=3))
    for r, res in enumerate(runs[(2, 1)]):
        for i, got in enumerate(res["batches"]):
            want = ds.batch(5 + i)
            np.testing.assert_array_equal(got["tokens"], runs["jax"]["shards"][i][r])
            np.testing.assert_array_equal(got["labels"], want["labels"][r * B // 2:(r + 1) * B // 2])
            np.testing.assert_array_equal(res["batches_whole"][i]["tokens"], want["tokens"])
    for res in runs[(1, 2)]:  # rows over "data" only: both model ranks hold the whole batch
        np.testing.assert_array_equal(res["batches"][0]["tokens"], ds.batch(5)["tokens"])


@pytest.mark.parametrize("mesh", [(1, 1), (1, 2), (2, 2), (1, 4)])
def test_checkpoint_restores_onto_another_mesh(runs, mesh):
    saved = runs[(2, 1)][0]["saved"]
    for res in runs[mesh]:
        got = res["restored"]
        assert got["step"] == 7
        for k in saved["params"]:
            np.testing.assert_array_equal(got["params"][k], saved["params"][k])
            np.testing.assert_array_equal(got["m"][k], saved["m"][k])
        if mesh != (1, 1):
            assert sum(got["local"].values()) < sum(v.size for v in saved["params"].values())


def test_trainer_resumes_across_meshes(runs):
    """2 steps on (2, 1), resumed on (1, 2) for the third, against 3 steps
    on one device; the sharded init is the one-device init bit for bit."""
    (one,) = runs[(1, 1)]
    want = one["trainer"]
    assert want["step"] == 3 and len(want["losses"]) == 3
    for res in runs[(2, 1)]:
        assert res["trainer"]["step"] == 2
        np.testing.assert_allclose(res["trainer"]["losses"], want["losses"][:2], **RANK_TOL)
    for res in runs[(1, 2)]:
        assert res["trainer"]["step"] == 3 and len(res["trainer"]["losses"]) == 1
        np.testing.assert_allclose(res["trainer"]["losses"], want["losses"][2:], **RANK_TOL)
        _close(res["trainer"]["params"], want["params"], JAX_TOL)
    from repro_torch.models import build_model

    init = build_model(_cfg("qwen3-32b"), device="cpu", train=True).train_params()
    for k, v in runs[(2, 1)][0]["trainer_init"].items():
        np.testing.assert_array_equal(v, init[k].detach().numpy())


def test_trainer_failing_on_one_rank_ends_the_job_and_resumes(runs, faults):
    """A step failing on rank 1 alone ends the job without a hang (every
    rank exits with an error within the job's limit, the checkpoint of step
    2 complete); the restarted job resumes at 2 and ends where 3 steps on
    one device end (the tolerances of ``test_trainer_resumes_across_meshes``)."""
    failed, resumed = faults
    for r, (rc, log, _) in enumerate(failed):
        assert rc != 0, f"rank {r} exited 0:\n{log[-4000:]}"
    assert "injected failure at step 2" in failed[1][1]
    want = runs[(1, 1)][0]["trainer"]
    for res in resumed:
        got = res["trainer"]
        assert got["step"] == 3 and len(got["losses"]) == 1
        np.testing.assert_allclose(got["losses"], want["losses"][2:], **RANK_TOL)
        _close(got["params"], want["params"], JAX_TOL)


def test_sigterm_on_one_rank_stops_every_rank_after_the_same_step(faults):
    _, resumed = faults
    for res in resumed:
        assert res["preempt"] == {"step": 1, "saved": [1]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of a test job")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--work", required=True)
    ap.add_argument("--case", default="plans", choices=("plans", "fail", "resume"))
    args = ap.parse_args()
    _rank_main(args.rank, args.world, tuple(int(x) for x in args.mesh.split("x")), args.init, args.out, args.work,
               args.case)
