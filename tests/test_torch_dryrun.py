"""The port's dry run and three-term roofline (``launch/trace_cost.py``,
``launch/roofline.py``, ``launch/dryrun.py``) and the four example programs,
on the CPU.

- ``trace_cost`` counts a loop's matmuls exactly: the counterparts of
  ``tests/test_launch.py``'s ``test_hlo_cost_scan_flops_exact`` and
  ``test_hlo_cost_nested_scan`` written as torch loops (7 * 2 * 64**3 and
  5 * 3 * 2 * 32**3 FLOPs, exactly, on real and on fake tensors; equal to
  the JAX package's ``analyze_hlo`` of the same programs as scans, within
  that test's 1e-6), and one matmul's traffic (3 * 64**2 * 4 bytes).
- The collective convention: c10d calls under a fake group of 4 give the
  JAX package's ``parse_collectives`` dict of an HLO snippet with the same
  result shapes, exactly (all five kinds).
- ``Roofline.finalize`` equals the JAX package's on the same inputs, with
  the reference module's three constants patched to the card's, to 1e-12
  relative.
- ``run_cell`` over a fake (2, 2) job against the same plans run for real
  over four gloo ranks (this file run as a script a rank, as
  ``test_torch_launch_ranks.py`` starts them): FLOPs and every collective
  kind's count and bytes equal, exactly (the same products and collectives
  on the same shapes); traffic within ``TRAFFIC_TOL`` (gloo runs
  ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` through copies
  of its own, which NCCL and the fake group do not, and the CPU's kernels
  lay out some outputs with other strides than the meta kernels, which
  follow CUDA's, so an einsum folds a dim differently: 1.3-4.0 % here).
- One full-width cell, starcoder2-7b ``train_4k`` on ``pod`` (16, 16): a
  per-rank peak above 1 GB, and the process's ``ru_maxrss`` grows by under
  2 GB (nothing of production size allocated).  The entry point writes a
  record a mesh, and reports a refused cell as ``FAIL`` and goes on.
- Each example's ``main([... "--device", "cpu"])`` against the JAX package
  on the same numpy inputs, at the tolerances of the reference's own tests:
  Cholesky factors at rtol = atol = 2e-4 (``tests/test_cholesky.py``), LU
  solves at atol 1e-5 and the inverse at 1e-4 (``tests/test_lu.py``),
  greedy tokens and decode steps exactly (``tests/test_torch_engine.py``),
  training losses at ``STEP_TOL`` (``tests/test_torch_train.py``).

Everything that starts a process group (a fake one included) runs in a
process of its own (``JOB_TIMEOUT_S`` each).
"""

import argparse
import importlib.util
import json
import os
import pickle
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
JOB_TIMEOUT_S = 180
RANKS = (2, 2)
B, S = 4, 16
REL = 1e-12
TRAFFIC_TOL = 0.05
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
# (arch, kind): reduced float32 configurations (the CPU and the card take
# the same ops at float32), one dense and one MoE train step and a decode
CELLS = (("qwen3-32b", "train"), ("granite-moe-1b-a400m", "train"), ("starcoder2-7b", "decode"))


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))


def _script(case: str, tmp: Path, timeout: float = JOB_TIMEOUT_S):
    """This file as a script for ``case``: its pickled result."""
    out = tmp / f"{case}.pkl"
    try:
        p = subprocess.run([sys.executable, __file__, "--case", case, "--out", str(out)], env=_env(), cwd=str(ROOT),
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        pytest.fail(f"case {case} did not finish within {timeout} s")
    assert p.returncode == 0, f"case {case} exited {p.returncode}:\n{(p.stdout + p.stderr)[-4000:]}"
    return pickle.loads(out.read_bytes())


# --------------------------------------------------------------------------
# (a) trace_cost: loops and one matmul
# --------------------------------------------------------------------------
def _loop(x, ws, inner):
    for w in ws:
        for _ in range(inner):
            x = x @ w
    return x


def _jax_scan_flops(trips, inner, n):
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_cost import analyze_hlo

    def f(x, ws):
        def outer(c, w):
            def body(ci, _):
                return ci @ w, ()
            c2, _ = jax.lax.scan(body, c, jnp.arange(inner))
            return c2, ()
        y, _ = jax.lax.scan(outer, x, ws)
        return y

    x, ws = np.zeros((n, n), np.float32), np.zeros((trips, n, n), np.float32)
    return analyze_hlo(jax.jit(f).lower(x, ws).compile().as_text()).flops


@pytest.mark.parametrize("fake", [False, True])
@pytest.mark.parametrize("trips,inner,n", [(7, 1, 64), (5, 3, 32)], ids=["scan", "nested_scan"])
def test_trace_cost_loop_flops_exact(trips, inner, n, fake):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.trace_cost import trace_cost

    want = trips * inner * 2 * n ** 3
    x, ws = np.zeros((n, n), np.float32), np.zeros((trips, n, n), np.float32)
    if fake:
        with FakeTensorMode() as mode:
            cost, _ = trace_cost(_loop, mode.from_tensor(torch.from_numpy(x)), mode.from_tensor(torch.from_numpy(ws)),
                                 inner)
    else:
        cost, _ = trace_cost(_loop, torch.from_numpy(x), torch.from_numpy(ws), inner)
    assert cost.flops == want
    assert cost.flops == pytest.approx(_jax_scan_flops(trips, inner, n), rel=1e-6)


def test_trace_cost_matmul_traffic():
    from repro_torch.launch.trace_cost import trace_cost

    a, b = torch.randn(64, 64), torch.randn(64, 64)
    cost, out = trace_cost(lambda a, b: a.t().t() @ b.view(64, 64), a, b)
    assert cost.traffic == 3 * 64 ** 2 * 4  # the views count nothing
    assert cost.flops == 2 * 64 ** 3 and cost.coll_dict() == {}
    torch.testing.assert_close(out, a @ b)


# --------------------------------------------------------------------------
# (b) the collective convention against the JAX package
# --------------------------------------------------------------------------
HLO = """
HloModule m

ENTRY %main (p0: bf16[8,128], p1: f32[64], p2: bf16[64,64], p3: f32[16,8], p4: bf16[4,32]) -> f32[64] {
  %p0 = bf16[8,128]{1,0} parameter(0)
  %ag = bf16[32,128]{1,0} all-gather(bf16[8,128]{1,0} %p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %p1 = f32[64]{0} parameter(1)
  %ar = f32[64]{0} all-reduce(f32[64]{0} %p1), replica_groups={{0,1,2,3}}, to_apply=%add
  %ar2 = f32[64]{0} all-reduce(f32[64]{0} %ar), replica_groups={{0,1,2,3}}, to_apply=%add
  %p2 = bf16[64,64]{1,0} parameter(2)
  %rs = bf16[16,64]{1,0} reduce-scatter(bf16[64,64]{1,0} %p2), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
  %p3 = f32[16,8]{1,0} parameter(3)
  %a2a = f32[16,8]{1,0} all-to-all(f32[16,8]{1,0} %p3), replica_groups={{0,1,2,3}}, dimensions={0}
  %p4 = bf16[4,32]{1,0} parameter(4)
  ROOT %cp = bf16[4,32]{1,0} collective-permute(bf16[4,32]{1,0} %p4), source_target_pairs={{1,0}}
}
"""


def _collectives_case():
    """The same result shapes as ``HLO`` through the port's c10d calls on
    fake tensors under a fake group of 4."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import fake_job
    from repro_torch.launch.trace_cost import trace_cost

    def calls():
        bf, f32 = torch.bfloat16, torch.float32
        dist.all_gather_into_tensor(torch.empty(32, 128, dtype=bf), torch.empty(8, 128, dtype=bf))
        x = torch.empty(64, dtype=f32)
        dist.all_reduce(x)
        dist.all_reduce(x)
        dist.reduce_scatter_tensor(torch.empty(16, 64, dtype=bf), torch.empty(64, 64, dtype=bf))
        dist.all_to_all_single(torch.empty(16, 8, dtype=f32), torch.empty(16, 8, dtype=f32))
        dist.recv(torch.empty(4, 32, dtype=bf), src=1)

    with fake_job(4), FakeTensorMode():
        cost, _ = trace_cost(calls)
    return {"collectives": cost.collectives, "calls": cost.calls, "notes": cost.notes}


def test_collective_convention_matches_jax(tmp_path):
    from repro.launch.roofline import collective_bytes as jbytes
    from repro.launch.roofline import parse_collectives as jparse
    from repro_torch.launch import roofline as rl

    got = _script("collectives", tmp_path)
    want = jparse(HLO)
    assert got["collectives"] == want, (got, want)
    assert all(want[k]["count"] for k in rl.KINDS)  # every kind taken
    assert rl.parse_collectives(got["calls"]) == want and rl.collective_bytes(want) == jbytes(want)
    assert got["notes"] == ""


# --------------------------------------------------------------------------
# (c) Roofline against the JAX package's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("flops,traffic,coll", [(4.2e15, 3.1e12, 2.0e9), (1e12, 8e12, 1e8), (1e9, 1e9, 5e11)],
                         ids=["compute", "memory", "collective"])
def test_roofline_matches_jax(monkeypatch, flops, traffic, coll):
    import dataclasses

    from repro.launch import roofline as jrl
    from repro_torch.launch import roofline as rl

    monkeypatch.setattr(jrl, "PEAK_FLOPS", rl.PEAK_FLOPS)
    monkeypatch.setattr(jrl, "HBM_BW", rl.HBM_BW)
    monkeypatch.setattr(jrl, "ICI_BW", rl.COLL_BW)
    kw = dict(arch="a", shape="s", mesh="pod", chips=256, hlo_flops=flops, hlo_bytes=traffic, coll_bytes=coll,
              collectives={"all-gather": {"count": 3, "bytes": coll}}, model_flops_total=1.3e17)
    got, want = rl.Roofline(**kw).finalize(), jrl.Roofline(**kw).finalize()
    for f in ("compute_s", "memory_s", "collective_s", "useful_ratio", "mfu_bound"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=REL), f
    assert got.bottleneck == want.bottleneck
    # the same record, but the reference's XLA cost fields (no counterpart)
    names = {f.name for f in dataclasses.fields(jrl.Roofline)} - {"xla_cost_flops", "xla_cost_bytes"}
    assert {f.name for f in dataclasses.fields(rl.Roofline)} == names
    assert json.loads(got.to_json())["bottleneck"] == want.bottleneck


# --------------------------------------------------------------------------
# (d) run_cell on a fake (2, 2) job against four gloo ranks
# --------------------------------------------------------------------------
def _cell(arch: str, kind: str):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig

    return get_arch(arch).reduced(), ShapeConfig(f"tiny_{kind}", S if kind != "decode" else 2 * S, B, kind)


def _counts(cost) -> dict:
    return {"flops": cost.flops, "traffic": cost.traffic, "collectives": cost.collectives}


def _cells_case():
    """``run_cell`` of every ``CELLS`` entry over a fake (2, 2) job, and of
    one with ``use_pallas`` (refused)."""
    import dataclasses

    from repro_torch.launch import dryrun

    out = {}
    for arch, kind in CELLS:
        cfg, shape = _cell(arch, kind)
        rec = dryrun.run_cell(cfg, shape, "tiny", mesh_shape=RANKS, out=None)
        out[f"{arch}/{kind}"] = {"flops": rec["hlo_flops"], "traffic": rec["hlo_bytes"],
                                 "collectives": rec["collectives"], "record": rec}
    cfg, shape = _cell("starcoder2-7b", "train")
    try:
        dryrun.run_cell(dataclasses.replace(cfg, use_pallas=True), shape, "tiny", mesh_shape=RANKS, out=None)
        out["pallas"] = "ran"
    except NotImplementedError as e:
        out["pallas"] = str(e)
    return out


def _rank_main(rank: int, world: int, init: str, out: str) -> None:
    """One gloo rank: every ``CELLS`` plan for real on this rank's blocks
    (seeded weights, seeded batch) under ``trace_cost``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import optim
    from repro_torch.launch import steps as st
    from repro_torch.launch.trace_cost import trace_cost
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", RANKS, mesh_dim_names=("data", "model"))
        res = {}
        for arch, kind in CELLS:
            cfg, shape = _cell(arch, kind)
            plan = st.make_step(cfg, mesh, shape, device="cpu")
            gen = torch.Generator().manual_seed(1)
            tok = lambda s: torch.randint(0, cfg.vocab, s, generator=gen, dtype=torch.int32)
            if kind == "train":
                blocks = build_model(cfg, seed=0, device="cpu", train=True,
                                     shardings=plan.in_shardings[0]).train_params()
                P, O = st.train_state(plan, blocks, optim.AdamWConfig(state_dtype=cfg.optim_state_dtype))
                batch = st.place_params({"tokens": tok((B, S)), "labels": tok((B, S))}, plan.in_shardings[2])
                args = (P, O, batch)
            else:
                params = {k: v.detach() for k, v in build_model(cfg, seed=0, device="cpu").train_params().items()}
                cache = tree_map(lambda v: torch.zeros(v.shape, dtype=v.dtype), plan.args[1])
                args = (st.place_params(params, plan.in_shardings[0]), st.place_params(cache, plan.in_shardings[1]),
                        st.place_params({"tokens": tok((B, 1))}, plan.in_shardings[2]),
                        torch.tensor(3, dtype=torch.int32))
            cost, _ = trace_cost(plan.fn, *args)
            res[f"{arch}/{kind}"] = _counts(cost)
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def fake_and_real(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    world = RANKS[0] * RANKS[1]
    outs = [tmp / f"rank{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, "--case", "rank", "--rank", str(r), "--world", str(world),
                               "--init", str(tmp / "init"), "--out", str(outs[r])], env=_env(), cwd=str(ROOT),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        fake = _script("cells", tmp)
        deadline = time.monotonic() + JOB_TIMEOUT_S
        try:
            logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
        except subprocess.TimeoutExpired:
            pytest.fail(f"the {world} gloo ranks did not finish within {JOB_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return fake, [pickle.loads(o.read_bytes()) for o in outs]


@pytest.mark.parametrize("cell", [f"{a}/{k}" for a, k in CELLS])
def test_run_cell_matches_four_gloo_ranks(fake_and_real, cell):
    fake, real = fake_and_real
    got = fake[cell]
    for r, ranks in enumerate(real):  # every rank traces the same program
        want = ranks[cell]
        assert got["flops"] == want["flops"], (r, got["flops"], want["flops"])
        assert got["traffic"] == pytest.approx(want["traffic"], rel=TRAFFIC_TOL), (r, got["traffic"], want["traffic"])
        assert got["collectives"] == {k: v for k, v in want["collectives"].items() if v["count"]}, r
    rec = got["record"]
    assert rec["chips"] == 4 and rec["mesh_shape"] == list(RANKS) and rec["hlo_flops"] > 0
    assert rec["memory"]["total"] >= rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective") and rec["fits"] is True
    assert "all-gather" in rec["collectives"]  # gather at use


def test_run_cell_refuses_the_flash_kernel(fake_and_real):
    msg = fake_and_real[0]["pallas"]
    assert "flash_attention_sm90" in msg and "no fake implementation" in msg


# --------------------------------------------------------------------------
# (e) one full-width cell
# --------------------------------------------------------------------------
def _full_case(out_dir: Path):
    from repro_torch.launch import dryrun

    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    t0 = time.time()
    rec = dryrun.run_cell("starcoder2-7b", "train_4k", "pod", out=out_dir)
    return {"record": rec, "rss_growth": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - before,
            "s": time.time() - t0}


def test_full_width_cell_allocates_nothing(tmp_path):
    """starcoder2-7b train_4k on (16, 16), 256 faked ranks: the whole
    32-layer model at published widths, B = 256 (16 rows a rank), S =
    4096."""
    got = _script("full", tmp_path)
    rec = got["record"]
    assert rec["memory"]["total"] > 1e9, rec["memory"]
    assert got["rss_growth"] < 2e9, got["rss_growth"]
    assert rec["chips"] == 256 and rec["mesh_shape"] == [16, 16] and rec["step"] == "train_step"
    assert set(rec["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter"}
    assert 0 < rec["useful_ratio"] < 1 and rec["bottleneck"] in ("compute", "memory", "collective")
    on_disk = json.loads((tmp_path / "full" / "pod" / "starcoder2-7b__train_4k.json").read_text())
    assert on_disk["hlo_flops"] == rec["hlo_flops"] and on_disk["fits"] == rec["fits"]


def _cli(tmp: Path, *args):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", str(tmp)], env=_env(),
                          cwd=str(ROOT), capture_output=True, text=True, timeout=JOB_TIMEOUT_S)


def test_main_writes_a_record_a_mesh(tmp_path):
    """The entry point over both production meshes: one record a mesh, the
    multi-pod job's 512 ranks splitting the batch twice as far."""
    p = _cli(tmp_path, "--arch", "granite-moe-1b-a400m", "--shape", "decode_32k", "--mesh", "both")
    assert p.returncode == 0, p.stdout + p.stderr[-4000:]
    recs = {m: json.loads((tmp_path / m / "granite-moe-1b-a400m__decode_32k.json").read_text())
            for m in ("pod", "multipod")}
    assert [recs[m]["chips"] for m in ("pod", "multipod")] == [256, 512]
    assert recs["multipod"]["memory"]["argument_size_in_bytes"] < recs["pod"]["memory"]["argument_size_in_bytes"]
    assert p.stdout.count("OK ") == 2


def test_main_reports_a_refused_cell_and_goes_on(tmp_path):
    """A cell the port refuses prints FAIL with the port's reason, the
    sweep goes on to the next, and the exit names every failed cell."""
    p = _cli(tmp_path, "--arch", "starcoder2-7b", "--shape", "train_4k", "--mesh", "both", "--override",
             "use_pallas=true")
    assert p.returncode == 1
    assert [line.split()[1] for line in p.stdout.splitlines() if line.startswith("FAIL")] == ["pod", "multipod"]
    assert "flash_attention_sm90" in p.stdout and "2 cells failed" in p.stderr


# --------------------------------------------------------------------------
# (g) the examples against the JAX package
# --------------------------------------------------------------------------
def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_drain_counts(graph, parts, n, seed=0):
    from repro.core import Dispatcher, GData, spd_matrix
    from repro.linalg import utp_cholesky

    a = spd_matrix(n, seed=seed)
    d = Dispatcher(graph=graph)
    A = GData(a.shape, partitions=parts, dtype=a.dtype, value=a)
    utp_cholesky(d, A)
    return d.run(), d.stats["waves"]


def test_example_quickstart_matches_jax():
    import jax.numpy as jnp

    from repro.core import spd_matrix

    out = _example("torch_quickstart").main(["64", "4", "2", "--device", "cpu"])
    want = np.asarray(jnp.linalg.cholesky(spd_matrix(64)))
    assert set(out["factors"]) == {"g1", "g2", "g2p", "g3"}
    for graph, L in out["factors"].items():
        np.testing.assert_allclose(L.numpy(), want, rtol=2e-4, atol=2e-4, err_msg=graph)
    for graph in ("g1", "g2", "g2p"):  # the reference's g3 is red (ROADMAP queue C)
        assert out["stats"][graph] == _jax_drain_counts(graph, ((4, 4),), 64), graph
    assert out["lines"][-1].startswith("same program")


def test_example_lu_solve_matches_jax():
    import jax.numpy as jnp
    import jax.scipy.linalg as jsl

    from repro.core import Dispatcher, GData, dd_matrix
    from repro.core.executors import clear_compile_cache
    from repro.linalg.lu import utp_lu_solve

    mod = _example("torch_lu_solve")
    out = mod.main(["64", "4", "2", "--device", "cpu"])
    a, b = dd_matrix(64), mod.rhs(64, 0)
    want = np.asarray(jsl.lu_solve(jsl.lu_factor(a), b))
    for graph, x in out["x"].items():
        np.testing.assert_allclose(x.numpy(), want, atol=1e-5, err_msg=graph)
    np.testing.assert_allclose(out["inv"].numpy() @ np.asarray(a), np.eye(64), atol=1e-4)
    clear_compile_cache()
    jdrains = []
    for seed in (1, 2):
        d = Dispatcher(graph="g2")
        A = GData(a.shape, partitions=((4, 4),), dtype=a.dtype, value=dd_matrix(64, seed=seed))
        B = GData(b.shape, partitions=((4, 4),), dtype=jnp.float32, value=mod.rhs(64, seed))
        utp_lu_solve(d, A, B)
        n_leaf = d.run()
        s = d.executor.stats
        jdrains.append({"leaf_tasks": n_leaf, **{k: s[k] for k in ("launches", "compiles", "groups",
                                                                  "groups_prefusion")}})
    assert out["drains"] == jdrains
    assert [d["compiles"] for d in out["drains"]] == [1, 0]


def test_example_serve_lm_matches_jax():
    from repro.configs import ARCHS as JARCHS
    from repro.serving import EngineConfig as JEngineConfig
    from repro.serving import Request as JRequest
    from repro.serving import ServeEngine as JServeEngine
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, to_jax

    mod = _example("torch_serve_lm")
    out = mod.main(["--requests", "5", "--slots", "2", "--new-tokens", "4", "--device", "cpu"])
    cfg = get_arch("starcoder2-7b").reduced()
    params = to_jax(cfg, build_model(cfg, seed=0, device="cpu").train_params())
    eng = JServeEngine(JARCHS["starcoder2-7b"].reduced(), params, JEngineConfig(slots=2, max_seq=128))
    for i, p in enumerate(mod.prompts(cfg, 5)):
        eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=4))
    done = eng.run_until_drained()
    assert out["tokens"] == {r.rid: [int(t) for t in r.out_tokens] for r in done}
    assert out["decode_steps"] == eng.decode_steps
    # the decode and the scatters compile as the JAX engine jits them; the prefill runs eagerly, once a request
    assert {k: v["compiles"] for k, v in out["stats"].items()} == {
        "decode": eng._decode._cache_size(), "prefill": 0, "scatter": eng._scatter._cache_size()}
    assert out["stats"]["prefill"]["eager_calls"] == len(done)


def test_example_train_lm_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro import optim as joptim
    from repro.configs import ARCHS as JARCHS
    from repro.data import pipeline as jpipe
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, to_jax

    out = _example("torch_train_lm").main(["--steps", "3", "--batch", "4", "--seq", "32", "--lr", "1e-3",
                                           "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    cfg, jcfg = get_arch("qwen3-32b").reduced(), JARCHS["qwen3-32b"].reduced()
    jp = jax.tree.map(jnp.asarray, to_jax(cfg, build_model(cfg, seed=0, device="cpu", train=True).train_params()))
    ocfg = joptim.AdamWConfig(lr=joptim.warmup_cosine(1e-3, warmup=20, total=3))
    jo = joptim.init(jp, ocfg)
    jmodel = jbuild(jcfg)
    ds = jpipe.SyntheticLMDataset(jpipe.DataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=4, seed=0))
    losses = []
    for i in range(3):
        (loss, _), g = jax.value_and_grad(jmodel.loss, has_aux=True)(jp, jax.tree.map(jnp.asarray, ds.batch(i)))
        jp, jo, _ = joptim.update(g, jo, jp, ocfg)
        losses.append(float(loss))
    assert out["step"] == 3 and out["failures"] == 0
    np.testing.assert_allclose([m["loss"] for m in out["metrics"]], losses, **STEP_TOL)
    assert out["lines"][0].startswith("arch=qwen3-32b preset=reduced")


CASES = {"collectives": _collectives_case, "cells": _cells_case}

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="a case of tests/test_torch_dryrun.py in a process of its own")
    ap.add_argument("--case", required=True, choices=("collectives", "cells", "full", "rank"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--init", default="")
    args = ap.parse_args()
    if args.case == "rank":
        _rank_main(args.rank, args.world, args.init, args.out)
    else:
        res = _full_case(Path(args.out).parent / "full") if args.case == "full" else CASES[args.case]()
        with open(args.out, "wb") as f:
            pickle.dump(res, f)
