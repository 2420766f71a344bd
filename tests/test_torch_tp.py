"""Compute split over the ``model`` axis (``models/spmd.py`` ``TP``): the
port's train, prefill and decode plans over gloo ranks on the CPU, held
against world size 1, against the JAX package's plans, and traced.

Each job starts its ranks as separate processes (this file run as a script,
``--rank R --world W --mesh DxM``) that meet through a ``file://`` init
method under the test's temporary directory; the jobs (1, 1), (1, 2),
(2, 2), (1, 4) and a ("pod", "data", "model") = (2, 2, 1) one run side by
side, each under ``JOB_TIMEOUT_S``.  The tolerances are
``tests/test_torch_launch_ranks.py``'s: against world size 1, every rank's
step metrics to ``METRIC_TOL`` and each leaf's first-step gradient to
``RANK_TOL``; the parameters after the steps to ``TP_TOL`` and the served
logits, KV caches and recurrent states to ``TP_SERVE_TOL``, as that file
holds them where ``model`` is larger than one (the partial sums over
``model`` round in another order than one device's products); the JAX
plans to ``JAX_TOL``.  zamba2 is held to world size 1 in float64 (``F64``),
for that file's reason: the reduced model's first Mamba2 layers, split by
heads here, amplify a float32 rounding a thousandfold.

- Train steps (2 steps, every leaf after them, the loss and metrics of
  each) on reduced float32 configurations, ``TRAIN_CASES``: qwen3-32b,
  where heads, KV heads, ``mlp`` and vocab all split; qwen3 with 2 KV heads
  on (1, 4), where the queries split and ``wk``/``wv`` stay whole (each rank
  projects the KV head its query head reads); starcoder2-7b with 3 heads,
  1 KV head and d_model 48 on (1, 2), where attention stays whole and the
  MLP splits (starcoder2-7b's 36 heads on a 16-way ``model``); gemma3-12b,
  local windows of 4 and a tied embedding split on vocab; zamba2, the
  shared block and the Mamba2 mixers split by heads; rwkv6-3b, both halves
  of the block split, and rwkv6 with d_model 48 (3 heads) on (1, 2), where
  the time-mix stays whole and the channel-mix splits on ``mlp`` (rwkv6-3b's
  40 heads on a 16-way ``model``); zamba2 and rwkv6 without sequence
  parallelism (f and g, the whole leaves' gradients summed over ``model``);
  granite, EP under sequence parallelism; granite with 3 experts on (2, 2),
  which do not divide ``model`` while the rows split over ``data`` (slots
  and capacity of the global batch; a capacity factor of 0.5, so that
  the capacity drops tokens and the slots' order decides which); granite on (pod 2, data 2, model 1)
  with B = 2, EP where the batch does not divide the batch axes (the
  reference replicates it; the port's rows split over ``pod``); a vocab of
  255, where the embedding and the head stay whole; qwen3 with
  ``seq_parallel`` off.
- One step of qwen3, granite, zamba2 and rwkv6 on (1, 2) against the JAX
  package's plan on an Auto-axis mesh of two fake CPU devices (a
  subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=2``):
  the loss and every leaf, zamba2 at Adam's eps 1e-6 in both packages
  (``tests/test_torch_launch.py``).
- Serving, ``SERVE_ARCHS``: a prefill of S tokens into a cache of 2 S (the
  prefill plan of 2 S fed the shorter prompt), then three decode steps at
  positions S, S + 1, S + 2 and one at per-row positions, against world
  size 1: logits, KV caches and recurrent states; each rank's KV cache
  block holds 2 S / model positions, and its ``ssm``, ``conv_x`` and
  ``wkv`` blocks H / model heads where H divides ``model``.
- The cache's placement where the resolver puts its batch dim off the
  rows' axes, on a mock mesh.
- Structure, through ``launch/dryrun.py`` on a fake (1, 4) job and a fake
  (1, 1) one, reduced qwen3's, zamba2's and rwkv6's train steps: every
  all-gather over the ``model`` group moves a (S / 4, B, D) chunk of
  activations (no leaf the resolver splits on ``model`` is gathered); the
  attention and MLP products' FLOPs a rank, and each mixer product's but
  those of the whole leaves, are exactly a quarter of world size 1's.
"""

import argparse
import dataclasses
import math
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

JOB_TIMEOUT_S = 240
# (data, model), and one ("pod", "data", "model") job
MESHES = ((1, 1), (1, 2), (2, 2), (1, 4), (2, 2, 1))
B, S = 4, 16
RANK_TOL = dict(rtol=1e-5, atol=1e-6)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
JAX_TOL = dict(rtol=2e-4, atol=2e-5)
TP_TOL = dict(rtol=1e-4, atol=1e-5)
TP_SERVE_TOL = dict(rtol=1e-4, atol=5e-5)
# zamba2 against world size 1 (module docstring)
F64 = {"compute_dtype": torch.float64, "param_dtype": torch.float64, "optim_state_dtype": torch.float64,
       "cache_dtype": torch.float64}
# name: (arch, config changes, meshes[, global batch])
TRAIN_CASES = {
    "qwen3": ("qwen3-32b", {"remat": "full"}, ((1, 2), (2, 2), (1, 4))),
    "qwen3_kv2": ("qwen3-32b", {"n_kv": 2}, ((1, 4),)),
    "qwen3_no_sp": ("qwen3-32b", {"seq_parallel": False}, ((1, 2), (1, 4))),
    "starcoder2_whole_attn": ("starcoder2-7b", {"n_heads": 3, "n_kv": 1, "d_model": 48}, ((1, 2),)),
    "gemma3": ("gemma3-12b", {"local_window": 4}, ((1, 2), (1, 4))),
    "zamba2": ("zamba2-2.7b", {"remat": "full", **F64}, ((1, 2), (1, 4))),
    "granite": ("granite-moe-1b-a400m", {}, ((1, 2), (1, 4))),
    "vocab255": ("qwen3-32b", {"vocab": 255}, ((1, 2),)),
    "rwkv6": ("rwkv6-3b", {}, ((1, 2), (1, 4))),
    "rwkv6_whole_tm": ("rwkv6-3b", {"d_model": 48}, ((1, 2),)),
    "zamba2_no_sp": ("zamba2-2.7b", {"seq_parallel": False, **F64}, ((1, 2),)),
    "rwkv6_no_sp": ("rwkv6-3b", {"seq_parallel": False}, ((1, 2),)),
    "granite_e3": ("granite-moe-1b-a400m", {"n_experts": 3, "capacity_factor": 0.5}, ((2, 2),)),
    "granite_pod": ("granite-moe-1b-a400m", {}, ((2, 2, 1),), 2),
}
JAX_CASES = ("qwen3-32b", "granite-moe-1b-a400m", "zamba2-2.7b", "rwkv6-3b")
# Adam's eps a JAX case takes in both packages (``tests/test_torch_launch.py``)
JAX_EPS = {"zamba2-2.7b": 1e-6}
# name: (arch, config changes)
SERVE_ARCHS = {"starcoder2-7b": ("starcoder2-7b", {}), "zamba2-2.7b": ("zamba2-2.7b", F64),
               "qwen3_kv2": ("qwen3-32b", {"n_kv": 2}), "rwkv6-3b": ("rwkv6-3b", {}),
               "rwkv6_whole_tm": ("rwkv6-3b", {"d_model": 48})}
# the recurrent states' heads dim (after the groups' and the rows')
STATE_HEADS = {"ssm": 2, "conv_x": 3, "wkv": 2}
ROOT = Path(__file__).resolve().parents[1]


def _cfg(arch, **kw):
    from repro_torch.configs import ARCHS

    return dataclasses.replace(ARCHS[arch.split("_")[0]].reduced(), **kw)


def _serve_cfg(name):
    arch, kw = SERVE_ARCHS[name]
    return _cfg(arch, **kw)


def _inputs(cfg, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        out = {"embeds": (rng.standard_normal((batch, S, cfg.d_model)) * 0.1).astype(np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab, (batch, S)).astype(np.int32)}
    out["labels"] = rng.integers(0, cfg.vocab, (batch, S)).astype(np.int32)
    return out


def _whole(x):
    from torch.distributed.tensor import DTensor

    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.detach().float().numpy()


def _tree(fn, tree):
    from repro_torch.tree import tree_map

    return tree_map(fn, tree)


def _train_case(mesh, cfg, steps, params=None, batch_size=B, eps=1e-8):
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model

    ocfg = optim.AdamWConfig(state_dtype=cfg.optim_state_dtype, eps=eps)
    plan = st.make_train_step(cfg, mesh, ShapeConfig("t", S, batch_size, "train"), ocfg, device="cpu")
    full = params if params is not None else build_model(cfg, device="cpu", train=True).train_params()
    ps, _, bs = plan.in_shardings
    P, O = st.train_state(plan, {k: sh.shard(v.detach(), ps[k]).clone() for k, v in full.items()}, ocfg)
    batch = st.place_params({k: torch.from_numpy(v) for k, v in _inputs(cfg, batch=batch_size).items()}, bs)
    step = plan.jitted()
    metrics, grads = [], None
    for _ in range(steps):
        _, _, met = step(P, O, batch)
        metrics.append({k: float(v) for k, v in met.items()})
        if grads is None:  # Adam's first moment after the first step: (1 - b1) g
            grads = {k: _whole(v) / 0.1 for k, v in O["m"].items()}
    gathered = []
    if plan.mesh.size() > 1:  # the model-split leaves every rank computes on as blocks
        ctx = st.moe_ctx_for(cfg, mesh, sh.train_rules(cfg), ps, batch_size)
        names = sh.mesh_names(mesh)
        gathered = [k for k, sp in ctx.params.splits.items()
                    if any(g is mesh.get_group(names.index("model")) for _, g, *_ in sp)]
    return {"metrics": metrics, "grads": grads, "params": {k: _whole(v) for k, v in P.items()},
            "model_gathered": gathered}


def _serve(mesh, name):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model

    cfg = _serve_cfg(name)
    params = {k: v.detach() for k, v in build_model(cfg, device="cpu").train_params().items()}
    toks = torch.from_numpy(_inputs(cfg)["tokens"])
    split = mesh.size() > 1
    pre = st.make_prefill_step(cfg, mesh, ShapeConfig("p", 2 * S, B, "prefill"), device="cpu")
    dec = st.make_decode_step(cfg, mesh, ShapeConfig("d", 2 * S, B, "decode"), device="cpu")
    place = (lambda t, s: st.place_params(t, s)) if split else (lambda t, s: t)
    P = place(params, pre.in_shardings[0])
    cache = place(_tree(lambda c: torch.zeros(c.shape, dtype=c.dtype), st.cache_specs(cfg, B, 2 * S)),
                  pre.in_shardings[2])
    logits, cache = pre.jitted()(P, place({"tokens": toks}, pre.in_shardings[1]), cache)
    out = {"prefill": _whole(logits), "decode": []}
    fns = [dec.jitted(), dec.jitted()]  # a scalar position, then per-row ones
    tok = torch.from_numpy(out["prefill"]).argmax(-1, keepdim=True).to(torch.int32)
    for pos in (S, S + 1, S + 2, [S + 3, S + 7, S + 11, 2 * S - 1]):
        pos = torch.tensor(pos, dtype=torch.int32)
        logits, cache = fns[pos.dim()](P, cache, place({"tokens": tok}, dec.in_shardings[2]), pos)
        full = _whole(logits)
        out["decode"].append(full)
        tok = torch.from_numpy(full).argmax(-1, keepdim=True).to(torch.int32)
    kv = [c for c in cache["layers"] + [cache.get("shared", {})] if "k" in c]
    out["kv"] = [{k: _whole(c[k]) for k in ("k", "v")} for c in kv]
    out["kv_block"] = tuple(sh.local(kv[0]["k"]).shape) if kv else None
    # the recurrent states: each leaf whole, and (its name, local shape, global shape)
    rec = [c for c in cache["layers"] if "k" not in c]
    out["states"] = [{k: _whole(t) for k, t in c.items()} for c in rec]
    out["state_blocks"] = [(k, tuple(sh.local(t).shape), tuple(t.shape)) for c in rec for k, t in c.items()]
    return out


def _rank_main(rank: int, world: int, mesh_shape, init: str, out: str, work: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import to_port

    torch.set_num_threads(1)  # the jobs' ranks share the worker's cores
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=JOB_TIMEOUT_S))
    t0 = time.perf_counter()
    try:
        names = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
        one = mesh_shape == (1, 1)
        res = {"train": {}, "jax": {}, "serve": {}}
        for name, (arch, kw, meshes, *batch) in TRAIN_CASES.items():
            if one or mesh_shape in meshes:
                res["train"][name] = _train_case(mesh, _cfg(arch, **kw), 2, batch_size=batch[0] if batch else B)
        if mesh_shape == (1, 2):
            for arch in JAX_CASES:
                jparams = pickle.loads((Path(work) / f"{arch}_params.pkl").read_bytes())
                cfg = _cfg(arch)
                res["jax"][arch] = _train_case(mesh, cfg, 1, to_port(cfg, jparams, device="cpu"),
                                               eps=JAX_EPS.get(arch, 1e-8))
        if len(mesh_shape) == 2:
            res["serve"] = {name: _serve(mesh, name) for name in SERVE_ARCHS}
        res["seconds"] = time.perf_counter() - t0
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _launch(shape, tmp: Path, work: Path):
    world = math.prod(shape)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    outs = [tmp / f"rank{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--world", str(world),
                               "--mesh", "x".join(map(str, shape)), "--init", str(tmp / "init"),
                               "--out", str(outs[r]), "--work", str(work)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, outs


def _collect(shape, procs, outs, deadline):
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"mesh {shape}: the ranks did not finish within {JOB_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"mesh {shape}, rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [pickle.loads(o.read_bytes()) for o in outs]


JAX_SCRIPT = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import optim
from repro.configs import ARCHS
from repro.configs.base import ShapeConfig
from repro.launch.steps import make_train_step
work = sys.argv[1]
out = {}
mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
for arch in sys.argv[2:]:
    params = pickle.load(open(f"{work}/{arch}_params.pkl", "rb"))
    batch = pickle.load(open(f"{work}/{arch}_batch.pkl", "rb"))
    cfg = ARCHS[arch].reduced()
    ocfg = optim.AdamWConfig(state_dtype=cfg.optim_state_dtype, eps=%r.get(arch, 1e-8))
    plan = make_train_step(cfg, mesh, ShapeConfig("t", %d, %d, "train"), opt_cfg=ocfg)
    p = jax.tree.map(jnp.asarray, params)
    o = optim.init(p, ocfg)
    with mesh:
        p2, o2, met = plan.jitted()(p, o, jax.tree.map(jnp.asarray, batch))
    out[arch] = {"loss": float(met["loss"]), "params": jax.tree.map(np.asarray, p2)}
pickle.dump(out, open(f"{work}/jax.pkl", "wb"))
""" % (JAX_EPS, S, B)


STRUCTURE_ARCHS = ("qwen3-32b", "zamba2-2.7b", "rwkv6-3b")


def _structure_case():
    """Reduced qwen3's, zamba2's and rwkv6's train steps traced on a fake
    (1, 4) job and a fake (1, 1) one: the model group's all-gathers, the
    attention and MLP products' forward FLOPs, and each product of the
    recurrent mixers' forwards (``proj``), in order: its FLOPs and its
    weight's shape."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import rwkv, ssm, transformer

    out = {}
    for arch in STRUCTURE_ARCHS:
        cfg = _cfg(arch)
        out[arch] = {}
        for shape in ((1, 1), (1, 4)):
            flops = {"attention": 0, "mlp": 0}
            products = []
            gathers = []

            def counted(name, fn):
                def run(*a, **k):
                    with FlopCounterMode(display=False) as f:
                        r = fn(*a, **k)
                    flops[name] += f.get_total_flops()
                    return r
                return run

            def product(x, w):
                products.append((2 * x.numel() // x.shape[-1] * w.numel(), tuple(w.shape)))
                return saved_proj(x, w)

            class Gathers(TorchDispatchMode):
                def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                    if func.namespace == "c10d" and func._schema.name.split("::")[-1] == "_allgather_base_":
                        group = dist.ProcessGroup.unbox(args[2])
                        gathers.append((group is model_group, tuple(args[1].shape)))
                    return func(*args, **(kwargs or {}))

            saved = transformer.attention_apply, transformer.mlp_apply
            saved_proj = ssm.proj
            transformer.attention_apply = counted("attention", saved[0])
            transformer.mlp_apply = counted("mlp", saved[1])
            ssm.proj = rwkv.proj = product
            try:
                with dryrun.fake_job(shape[0] * shape[1]):
                    mesh = dryrun.make_mesh("tiny", shape)
                    model_group = mesh.get_group(1)
                    with Gathers():
                        dryrun.trace_step(cfg, ShapeConfig("t", S, B, "train"), mesh)
            finally:
                transformer.attention_apply, transformer.mlp_apply = saved
                ssm.proj = rwkv.proj = saved_proj
            out[arch][shape] = {"flops": flops, "products": products, "model_gathers": [s for m, s in gathers if m],
                                "gathers": len(gathers)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import ARCHS as JARCHS
    from repro.models import build_model as jbuild

    work = tmp_path_factory.mktemp("work")
    for arch in JAX_CASES:
        params = jax.tree.map(np.asarray, jbuild(JARCHS[arch].reduced()).init(jax.random.PRNGKey(0)))
        (work / f"{arch}_params.pkl").write_bytes(pickle.dumps(params))
        (work / f"{arch}_batch.pkl").write_bytes(pickle.dumps(_inputs(_cfg(arch))))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(work), *JAX_CASES], env=env, cwd=str(ROOT),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    structure = subprocess.Popen([sys.executable, __file__, "--case", "structure", "--out", str(work / "st.pkl")],
                                 env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    jobs = {shape: _launch(shape, tmp_path_factory.mktemp("mesh" + "x".join(map(str, shape))), work)
            for shape in MESHES}
    deadline = time.monotonic() + JOB_TIMEOUT_S
    out = {}
    try:
        for shape, (procs, outs) in jobs.items():
            out[shape] = _collect(shape, procs, outs, deadline)
        for name, p in (("jax", jax_proc), ("structure", structure)):
            log = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
            assert p.returncode == 0, f"{name}:\n{log[-4000:]}"
    finally:
        for p in [jax_proc, structure] + [p for procs, _ in jobs.values() for p in procs]:
            if p.poll() is None:
                p.kill()
                p.wait()
    out["jax"] = pickle.loads((work / "jax.pkl").read_bytes())
    out["structure"] = pickle.loads((work / "st.pkl").read_bytes())
    return out


def _close(got, want, tol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("name,mesh", [(n, m) for n, (_, _, ms, *_) in TRAIN_CASES.items() for m in ms])
def test_train_step_matches_world_size_one(runs, name, mesh):
    """The loss and metrics of each step, each leaf's gradient of the first
    step (Adam's first moment) to ``RANK_TOL``; the parameters after the two
    steps to ``TP_TOL``: the row-parallel partial sums round in another
    order than one device's products, and Adam's second step divides each
    element by its own size, so an element whose gradient cancels to near 0
    moves apart (as the JAX package's arithmetic of the same step does)."""
    (one,) = runs[(1, 1)]
    want = one["train"][name]
    for res in runs[mesh]:
        got = res["train"][name]
        for g, w in zip(got["metrics"], want["metrics"]):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], err_msg=k, **METRIC_TOL)
        _close(got["grads"], want["grads"], RANK_TOL)
        _close(got["params"], want["params"], TP_TOL)


@pytest.mark.parametrize("name,mesh", [(n, m) for n, (_, _, ms, *_) in TRAIN_CASES.items() for m in ms])
def test_no_model_split_leaf_is_gathered_over_model(runs, name, mesh):
    """No leaf is gathered over ``model``: every leaf the resolver splits
    there, the Mamba2 and RWKV6 mixers' included, is used as its block."""
    for res in runs[mesh]:
        got = res["train"][name]["model_gathered"]
        assert not got, got


@pytest.mark.parametrize("arch", JAX_CASES)
def test_train_step_matches_the_jax_plan_on_two_devices(runs, arch):
    import jax

    from repro_torch.models import to_jax

    want = runs["jax"][arch]
    cfg = _cfg(arch)
    for res in runs[(1, 2)]:
        got = res["jax"][arch]
        np.testing.assert_allclose(got["metrics"][0]["loss"], want["loss"], **JAX_TOL)
        tree = to_jax(cfg, {k: torch.from_numpy(v) for k, v in got["params"].items()})
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want["params"])):
            np.testing.assert_allclose(a, np.asarray(b, np.float32), **JAX_TOL)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("name", list(SERVE_ARCHS))
def test_serve_plans_match_world_size_one(runs, mesh, name):
    """Every step's logits, the K/V caches and the recurrent states to
    ``TP_SERVE_TOL`` (the attention over a cache split on seq sums each
    block's share apart, the mixers' row-parallel products their heads'
    parts); each rank's KV cache block holds 2 S / model positions and its
    ``ssm``, ``conv_x`` and ``wkv`` blocks H / model heads where H divides
    ``model``, every other state dim whole."""
    (one,) = runs[(1, 1)]
    want = one["serve"][name]
    cfg = _serve_cfg(name)
    H = cfg.ssm_heads if cfg.family == "hybrid" else cfg.d_model // cfg.rwkv_head_size
    for res in runs[mesh]:
        got = res["serve"][name]
        np.testing.assert_allclose(got["prefill"], want["prefill"], **TP_SERVE_TOL)
        for g, w in zip(got["decode"], want["decode"]):
            np.testing.assert_allclose(g, w, **TP_SERVE_TOL)
        for a, b in zip(got["kv"], want["kv"]):
            _close(a, b, TP_SERVE_TOL)
        for a, b in zip(got["states"], want["states"]):
            _close(a, b, TP_SERVE_TOL)
        if got["kv"]:  # (G, B / data, 2 S / model, Hkv, hd): the seq dim on model
            assert got["kv_block"][1:3] == (B // mesh[0], 2 * S // mesh[1]), got["kv_block"]
        assert len(got["state_blocks"]) == len(want["state_blocks"])
        for k, loc, glob in got["state_blocks"]:
            blk = list(glob)
            blk[1] //= mesh[0]
            if k in STATE_HEADS and H % mesh[1] == 0:
                blk[STATE_HEADS[k]] //= mesh[1]
            assert loc == tuple(blk), (k, loc, glob)


def test_cache_shardings_place_the_batch_on_the_rows():
    """Where the resolver places a cache's batch dim off the rows' axes (on
    (pod 3, data 2) with B = 2 it takes ``data``, while the rows, which
    ``pod`` does not divide, are whole), the cache's batch dim follows the
    rows; the KV caches' seq dim takes the axes the rows leave, and the
    recurrent states keep only their ``heads`` split."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.models.transformer import cache_logical

    class Mesh:
        def __init__(self, **sizes):
            self.axis_names, self.shape = tuple(sizes), dict(sizes)

    cfg = _cfg("zamba2-2.7b")  # KV caches (the shared block), Mamba2 states
    for mesh, rows, seq in ((Mesh(pod=3, data=2, model=2), (), ("pod", "data", "model")),
                            (Mesh(pod=2, data=3, model=2), ("pod",), ("data", "model"))):
        rules = sh.serve_rules(cfg)
        specs = st.cache_specs(cfg, 2, 24)
        assert sh.batch_axes(mesh, rules, 2) == rows
        resolver = sh.tree_pspecs(cache_logical(cfg), specs, mesh, rules)
        got = st._cache_shardings(cfg, specs, mesh, rules, rows)
        # the first mesh: the resolver's batch dim is off the rows; the second agrees
        assert (sh.spec_axes(resolver["shared"]["k"][1]) != rows) == (rows == ())
        for key in ("k", "v"):
            assert got["shared"][key].spec == sh.P(None, sh._lead(rows), seq, None, None), got["shared"][key].spec
        layer = got["layers"][0]
        assert layer["ssm"].spec == sh.P(None, sh._lead(rows), "model", None, None), layer["ssm"].spec
        assert layer["conv_x"].spec == sh.P(None, sh._lead(rows), None, "model", None), layer["conv_x"].spec
        for key in ("conv_b", "conv_c"):
            assert layer[key].spec == sh.P(None, sh._lead(rows), None, None, None), layer[key].spec
    rw = _cfg("rwkv6-3b")
    mesh = Mesh(pod=3, data=2, model=2)
    got = st._cache_shardings(rw, st.cache_specs(rw, 2, 24), mesh, sh.serve_rules(rw), ())["layers"][0]
    assert got["wkv"].spec == sh.P(None, None, "model", None, None), got["wkv"].spec
    for key in ("shift_tm", "shift_cm"):  # whole: the resolver would put embed on data
        assert got[key].spec == sh.P(None, None, None), got[key].spec


def test_traced_step_splits_attention_and_mlp_four_ways(runs):
    st = runs["structure"]["qwen3-32b"]
    one, four = st[(1, 1)], st[(1, 4)]
    for block in ("attention", "mlp"):
        assert one["flops"][block] > 0
        assert four["flops"][block] * 4 == one["flops"][block], (block, four["flops"], one["flops"])
    cfg = _cfg("qwen3-32b")
    assert four["model_gathers"] and one["gathers"] == 0
    assert set(four["model_gathers"]) == {(S // 4, B, cfg.d_model)}, four["model_gathers"]


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-3b"])
def test_traced_step_splits_the_mixers_four_ways(runs, arch):
    """Over a (1, 4) ``model`` axis every all-gather there moves a (S / 4,
    B, D) chunk of activations, never a parameter; each product of the
    mixers' forwards takes exactly a quarter of world size 1's FLOPs,
    except those with the whole leaves each rank uses for its own heads:
    Mamba2's B and C projections (``wb``, ``wc``; G = 1 group) and RWKV6's
    decay LoRA's first half (``w_lora_a``).  rr's ``wr_cm``, whole, runs on
    the rank's chunk of the sequence, a quarter of the rows."""
    st = runs["structure"][arch]
    one, four = st[(1, 1)], st[(1, 4)]
    cfg = _cfg(arch)
    assert four["model_gathers"] and one["gathers"] == 0
    assert set(four["model_gathers"]) == {(S // 4, B, cfg.d_model)}, four["model_gathers"]
    assert len(one["products"]) == len(four["products"]) > 0
    if arch == "zamba2-2.7b":
        H, P = cfg.ssm_heads, cfg.ssm_expand * cfg.d_model // cfg.ssm_heads
        whole = {(cfg.d_model, 1, cfg.ssm_state)}
        per_call, split = 2, {(cfg.d_model, H, P), (cfg.d_model, H), (H * P, cfg.d_model)}
    else:
        H, K = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
        whole = {(cfg.d_model, 64)}
        per_call, split = 1, {(cfg.d_model, H, K), (64, H, K), (H * K, cfg.d_model), (cfg.d_model, cfg.d_ff),
                              (cfg.d_ff, cfg.d_model), (cfg.d_model, cfg.d_model)}
    kept = [(f1, w1) for (f1, w1), (f4, _) in zip(one["products"], four["products"]) if f1 == f4]
    quartered = [(f1, f4, w1) for (f1, w1), (f4, _) in zip(one["products"], four["products"]) if f1 != f4]
    assert all(f1 == 4 * f4 for f1, f4, _ in quartered), quartered
    assert {w for _, w in kept} == whole and {w for *_, w in quartered} == split, (kept, quartered)
    assert len(kept) == per_call * cfg.n_layers, kept  # one mixer a layer, no remat


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of a test job, or the traced structure case")
    ap.add_argument("--case", default="rank", choices=("rank", "structure"))
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--mesh")
    ap.add_argument("--init")
    ap.add_argument("--out", required=True)
    ap.add_argument("--work")
    args = ap.parse_args()
    if args.case == "structure":
        with open(args.out, "wb") as f:
            pickle.dump(_structure_case(), f)
    else:
        _rank_main(args.rank, args.world, tuple(int(x) for x in args.mesh.split("x")), args.init, args.out,
                   args.work)
