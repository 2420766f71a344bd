"""The port's train, prefill and decode plans over a world-size-1 gloo
``DeviceMesh`` against the JAX package's plans on an Auto-axis 1x1 mesh
(the reference's own plan tests build an Explicit-axis mesh, on which its
MoE layer raises; on Auto axes the same plans run).

The same parameters (the JAX package's ``jax.random`` init, carried across
as numpy by ``to_port``/``params_from_jax``) and the same numpy batches go
through both.  Tolerances: a train step's loss, its metrics and every
parameter leaf after it at ``tests/test_torch_train.py``'s step tolerance
(rtol 2e-4, atol 2e-5), zamba2 at Adam's eps 1e-6 in both packages (at
the default 1e-8 one element of 16384 whose gradient is within float32
noise of zero ends 0.7 lr apart: Adam divides each gradient element by its
own size plus eps); prefill and decode logits and caches at
``tests/test_torch_lm.py``'s 1e-4 (float32 compute, sums in another
order); the EP MoE layer on a 1x1 context against the local dispatch at
the reference test's rtol 1e-4 / atol 1e-5 (``test_ep_matches_local``).
The world-size-1 plans are also the one-device plans bit for bit.
"""

import dataclasses
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AxisType

from repro import optim as joptim
from repro.configs import ARCHS as JARCHS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild
from repro.models.layers import init_params as jinit_params
from repro.models.moe import MoeCtx as JMoeCtx
from repro.models.moe import moe_apply as jmoe_apply
from repro.models.moe import moe_template as jmoe_template
from repro_torch import optim
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps as st
from repro_torch.models import build_model, params_from_jax, to_jax, to_port
from repro_torch.models import moe
from repro_torch.tree import leaves

STEP_TOL = dict(rtol=2e-4, atol=2e-5)
LM_TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 32
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    from torch.distributed.device_mesh import init_device_mesh

    store = dist.FileStore(str(tmp_path_factory.mktemp("store") / "f"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def jmesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))


def _pair(arch, **kw):
    return dataclasses.replace(JARCHS[arch].reduced(), **kw), dataclasses.replace(ARCHS[arch].reduced(), **kw)


def _jparams(jcfg):
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))


def _batch(cfg, seq=S, labels=True, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        out = {"embeds": (rng.standard_normal((B, seq, cfg.d_model)) * 0.1).astype(np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)
    return out


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["qwen3-32b", "granite-moe-1b-a400m", "rwkv6-3b", "zamba2-2.7b", "gemma3-12b"])
def test_train_plan_matches_the_jax_plan(mesh, arch):
    jcfg, tcfg = _pair(arch)
    params, batch = _jparams(jcfg), _batch(jcfg)
    jm = jmesh()
    eps = 1e-6 if arch == "zamba2-2.7b" else 1e-8
    jocfg = joptim.AdamWConfig(state_dtype=jcfg.optim_state_dtype, eps=eps)
    jplan = jsteps.make_train_step(jcfg, jm, JShapeConfig("t", S, B, "train"), opt_cfg=jocfg)
    jp = jax.tree.map(jnp.asarray, params)
    jo = joptim.init(jp, jocfg)
    with jm:
        jp2, _, jmet = jplan.jitted()(jp, jo, jax.tree.map(jnp.asarray, batch))

    ocfg = optim.AdamWConfig(eps=eps)
    plan = st.make_train_step(tcfg, mesh, ShapeConfig("t", S, B, "train"), ocfg, device="cpu")
    assert plan.in_shardings is not None and plan.mesh is mesh
    p, o = st.train_state(plan, to_port(tcfg, params, device="cpu"), ocfg)
    step = plan.jitted()
    p2, o2, met = step(p, o, _t(batch))
    assert p2 is p and o2 is o and step.compiles == 1
    assert set(jmet) == set(met)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), err_msg=k, **STEP_TOL)
    for a, b in zip(jax.tree.leaves(to_jax(tcfg, p)), jax.tree.leaves(jp2)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **STEP_TOL)


def test_world_size_one_train_plan_is_the_one_device_plan(mesh):
    """Over a (1, 1) mesh nothing is gathered: the step is the mesh-None
    plan's bit for bit."""
    _, tcfg = _pair("qwen3-32b", remat="full")
    batch = _t(_batch(tcfg))
    out = []
    for m in (None, mesh):
        plan = st.make_train_step(tcfg, m, ShapeConfig("t", S, B, "train"), device="cpu")
        p = {k: v.detach() for k, v in build_model(tcfg, device="cpu", train=True).train_params().items()}
        p, o = st.train_state(plan, p, optim.AdamWConfig())
        _, _, met = plan.jitted()(p, o, batch)
        out.append((p, met))
    (p0, m0), (p1, m1) = out
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


def _tcache(plan_args_cache):
    from repro_torch.tree import tree_map

    return tree_map(lambda c: torch.zeros(c.shape, dtype=c.dtype), plan_args_cache)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "zamba2-2.7b"])
def test_decode_plan_matches_the_jax_plan(mesh, arch):
    jcfg, tcfg = _pair(arch)
    params = _jparams(jcfg)
    jm = jmesh()
    jplan = jsteps.make_decode_step(jcfg, jm, JShapeConfig("d", S, B, "decode"))
    jcache = jbuild(jcfg).init_cache(B, S)
    batch = _batch(jcfg, seq=1, labels=False)
    with jm:
        jlogits, jcache2 = jplan.jitted()(jax.tree.map(jnp.asarray, params), jcache, jax.tree.map(jnp.asarray, batch),
                                          jnp.asarray(3, jnp.int32))

    plan = st.make_decode_step(tcfg, mesh, ShapeConfig("d", S, B, "decode"), device="cpu")
    serve = {k: v.detach() for k, v in params_from_jax(tcfg, params, device="cpu").train_params().items()}
    cache = _tcache(plan.args[1])
    logits, cache2 = plan.jitted()(serve, cache, _t(batch), torch.tensor(3, dtype=torch.int32))
    assert cache2 is cache
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LM_TOL)
    _caches_close(jcache2, cache)


def _caches_close(jcache, cache):
    for i, layer in enumerate(cache["layers"]):
        for k, v in layer.items():
            np.testing.assert_allclose(v.float().numpy(), np.asarray(jcache["layers"][i][k], np.float32),
                                       err_msg=f"layers.{i}.{k}", **LM_TOL)
    for k, v in cache.get("shared", {}).items():
        np.testing.assert_allclose(v.float().numpy(), np.asarray(jcache["shared"][k], np.float32), **LM_TOL)


def test_prefill_plan_matches_the_jax_plan(mesh):
    """starcoder2-7b with use_pallas on.  A prefill fills a cache, and with
    a cache both packages attend over it without the flash kernel (their
    ``attention_apply`` calls flash only without one); the plan is also
    ``Model.prefill`` bit for bit."""
    jcfg, tcfg = _pair("starcoder2-7b", use_pallas=True)
    params = _jparams(jcfg)
    jm = jmesh()
    jplan = jsteps.make_prefill_step(jcfg, jm, JShapeConfig("p", S, B, "prefill"))
    batch = _batch(jcfg, labels=False)
    with jm:
        jlogits, jcache = jplan.jitted()(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch),
                                         jbuild(jcfg).init_cache(B, S))

    plan = st.make_prefill_step(tcfg, mesh, ShapeConfig("p", S, B, "prefill"), device="cpu")
    model = params_from_jax(tcfg, params, device="cpu")
    serve = {k: v.detach() for k, v in model.train_params().items()}
    cache = _tcache(plan.args[2])
    logits, _ = plan.jitted()(serve, _t(batch), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LM_TOL)
    _caches_close(jcache, cache)
    # the plan is Model.prefill bit for bit
    own = model.init_cache(B, S)
    want, _ = model.prefill(_t(batch), own)
    assert torch.equal(logits, want)
    assert all(torch.equal(a, b) for a, b in zip(leaves(cache), leaves(own)))


def test_moe_ep_matches_local(mesh):
    """The EP path on a 1x1 context against the local gather path, and
    against the JAX package's EP (``test_ep_matches_local``'s case)."""
    jcfg, tcfg = _pair("granite-moe-1b-a400m", capacity_factor=8.0)
    p = jax.tree.map(np.asarray, jinit_params(jmoe_template(jcfg), jax.random.PRNGKey(0), jnp.float32))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (2, 16, jcfg.d_model)) * 0.5)
    jm = jmesh()
    with jm:
        jout, jaux = jax.jit(lambda pp, xx: jmoe_apply(jcfg, pp, xx, ctx=JMoeCtx(mesh=jm, batch_axes=("data",),
                                                                                   model_axis="model")))(p, x)
    tp = _t(p)
    ctx = moe.MoeCtx(mesh=mesh, batch_axes=("data",), model_axis="model")
    assert moe.use_ep(tcfg, ctx)
    out_ep, aux_ep = moe.moe_apply(tcfg, tp, torch.from_numpy(x), ctx)
    out_local, aux_local = moe.moe_apply(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(out_ep.numpy(), out_local.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux_ep), float(aux_local), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out_ep.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux_ep), float(jaux), rtol=1e-4, atol=1e-6)


def test_ep_grads_flow(mesh):
    """The reference's test_ep_grads_flow: a loss through the EP path gives
    finite, nonzero gradients to every expert leaf and the router."""
    _, tcfg = _pair("granite-moe-1b-a400m")
    gen = torch.Generator().manual_seed(0)
    t = moe.moe_template(tcfg)
    p = {k: (torch.randn(s.shape, generator=gen) * 0.1).requires_grad_() for k, s in t.items()}
    x = torch.randn(2, 8, tcfg.d_model, generator=gen) * 0.5
    out, aux = moe.moe_apply(tcfg, p, x, moe.MoeCtx(mesh=mesh))
    ((out ** 2).mean() + 0.01 * aux).backward()
    for k, v in p.items():
        assert torch.isfinite(v.grad).all() and v.grad.abs().sum() > 0, k


def test_mesh_and_entry_points(mesh):
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as ltrain

    m = lmesh.make_local_mesh(device_type="cpu")
    assert lmesh.mesh_axes(m) == ("data", "model") and tuple(m.shape) == (1, 1)
    # the production meshes need a job of their size: this one has one rank
    with pytest.raises(RuntimeError, match="needs 256 ranks, the job has 1"):
        lmesh.make_production_mesh(device_type="cpu")
    # --production-mesh (--multi-pod) goes through to it, as the reference's
    for flags, n in ((["--production-mesh"], 256), (["--production-mesh", "--multi-pod"], 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} ranks, the job has 1"):
            ltrain.main(["--arch", "qwen3-32b", "--steps", "1", "--device", "cpu", *flags])
    # over a job of 256 and 512 ranks (faked, in a process of its own: this
    # module's group is running), the meshes and the entry point's
    got = json.loads(subprocess.run([sys.executable, "-c", FAKE_JOBS], env=dict(
        os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])),
        capture_output=True, text=True, timeout=120, check=True).stdout.splitlines()[-1])
    assert got == {"256": [[16, 16], ["data", "model"]], "512": [[2, 16, 16], ["pod", "data", "model"]],
                   "train 256": [[16, 16], "starcoder2-7b", 4096], "train 512": [[2, 16, 16], "starcoder2-7b", 4096]}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lmesh.make_local_mesh()
    assert st.make_step(ARCHS["qwen3-32b"].reduced(), mesh, ShapeConfig("d", S, B, "decode"),
                        device="cpu").name == "decode_step"


FAKE_JOBS = r"""
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import mesh as lmesh, train as ltrain

class Recorder:
    def __init__(self, cfg, shape, mesh, *a, **kw):
        got[f"train {mesh.size()}"] = [list(mesh.shape), cfg.name, shape.seq_len]

    def train(self):
        return {"step": 0, "stragglers": 0, "failures": 0}

got = {}
ltrain.Trainer = Recorder
for n in (256, 512):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    m = lmesh.make_production_mesh(multi_pod=n == 512)
    got[str(n)] = [list(m.shape), list(lmesh.mesh_axes(m))]
    ltrain.main(["--arch", "starcoder2-7b", "--production-mesh", "--device", "cpu"] + (["--multi-pod"] if n == 512 else []))
    dist.destroy_process_group()
print(json.dumps(got))
"""


def test_distributed_entry_point_trains(mesh, tmp_path):
    """``launch.train --distributed`` in a process group already started:
    the (1, 1) mesh over the one rank."""
    from repro_torch.launch import train as ltrain

    out = ltrain.main(["--arch", "qwen3-32b", "--reduced", "--steps", "2", "--device", "cpu", "--distributed",
                       "--ckpt-dir", str(tmp_path)])
    assert out["step"] == 2 and np.isfinite(out["metrics"][-1]["loss"])
