"""The port's training path against the JAX package's on the CPU: the
model's gradients (fp32 masters through the per-call cast), remat, the UTP
train-step task tree, checkpoints written and read by either package, the
``Trainer``, ``make_train_step``'s plan, ``model_flops`` and the
``launch.train`` entry point; and the flash kernel's refusal under
autograd.  Parameters are the JAX package's ``jax.random`` init carried
across as numpy (``models/convert.py``); batches are numpy.

Tolerances:
- gradients at float32 compute, every leaf (through ``to_jax``): relative
  L2 <= 1e-4 (the same fp32 arithmetic in another order; MoE configs first
  assert a top-k router-logit gap > 1e-4 at every routed token, so no
  comparison rests on a near tie);
- gradients at the shipped bf16 compute, the whole tree: relative L2 <=
  2e-2 against the JAX package run with ``--xla_allow_excess_precision=
  false`` (in a subprocess: by default XLA's CPU backend keeps bf16
  elementwise chains in fp32, which the port's eager bf16 ops do not, and
  the difference then reaches 0.6); for a reduced model whose reference
  bf16 gradient is chaotic (one bf16 ulp of one input element moves the
  reference's zamba2 tree by 0.65, measured in that subprocess), a quarter
  of that move instead;
- the card's head backward against the reference's transpose: 2e-4 on the
  bf16 gradients, 1e-5 on its fp32 products;
- the init's gradient norm, port against reference: 1e-3;
- remat ``full``/``dots`` against ``none``: bit for bit;
- train steps (``UTPTrainStep``, ``Trainer``) against the reference's: the
  reference test's rtol 2e-4 / atol 2e-5 on every parameter.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as jpipe
from repro.kernels import flash_attention as jfa
from repro.launch import roofline as jroofline
from repro.models import build_model as jbuild
from repro.train import Checkpointer as JCheckpointer
from repro.train import UTPTrainStep as JUTPTrainStep
from repro_torch import optim
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import roofline
from repro_torch.launch.steps import StepPlan, make_train_step
from repro_torch.core.executors.captured import CaptureError
from repro_torch.models import build_model, moe, params_from_jax, to_jax, to_port
from repro_torch.models import model as mmodel
from repro_torch.train import Checkpointer, Trainer, TrainerConfig, UTPTrainStep

GRAD_TOL = 1e-4
BF16_TOL = 2e-2
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
GAP = 1e-4
B, S = 2, 16
ROOT = Path(__file__).resolve().parents[1]


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        out = {"embeds": (rng.standard_normal((b, s, cfg.d_model)) * 0.1).astype(np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    out["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return out


def _jparams(jcfg):
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(tree)])


def _port_grads(tcfg, params, batch):
    model = params_from_jax(tcfg, params, device="cpu", train=True)
    (loss, metrics), grads = model.value_and_grad(model.train_params(), _tbatch(batch))
    return loss, metrics, grads


def _router_gaps(tcfg, model, batch):
    """The smallest top-k router-logit gap over every MoE layer's tokens."""
    gaps = []
    real = moe._router

    def spy(cfg, w, xf, *rest):
        logits = np.sort(xf.double().numpy() @ w.double().numpy(), axis=-1)[:, ::-1]
        gaps.append((logits[:, cfg.top_k - 1] - logits[:, cfg.top_k]).min())
        return real(cfg, w, xf, *rest)

    moe._router = spy
    try:
        with torch.no_grad():
            model.loss(_tbatch(batch))
    finally:
        moe._router = real
    return min(gaps)


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(JARCHS))
def test_grads_match_jax_fp32(name):
    jcfg, tcfg = JARCHS[name].reduced(), ARCHS[name].reduced()
    params, batch = _jparams(jcfg), _batch(jcfg)
    if tcfg.is_moe:
        model = params_from_jax(tcfg, params, device="cpu")
        assert _router_gaps(tcfg, model, batch) > GAP
    m = jbuild(jcfg)
    (jloss, _), jg = jax.jit(jax.value_and_grad(m.loss, has_aux=True))(params, jax.tree.map(jnp.asarray, batch))
    loss, _, grads = _port_grads(tcfg, params, batch)
    assert abs(float(loss) - float(jloss)) <= GRAD_TOL * abs(float(jloss))
    assert all(g.dtype == torch.float32 for g in grads.values())  # the masters' dtype
    port = to_jax(tcfg, grads)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], jax.tree.leaves(port)):
        assert _rel(b, a) <= GRAD_TOL, f"{name} {jax.tree_util.keystr(path)}: {_rel(b, a):.3g}"


def _nudged(params, batch):
    """Copies of ``params`` and ``batch`` with one element of the first
    token's input moved by one bf16 ulp (2**-7 of it)."""
    params, batch = jax.tree.map(np.copy, params), dict(batch)
    if "embeds" in batch:
        batch["embeds"] = batch["embeds"].copy()
        batch["embeds"][0, 0, 0] *= 1 + 2.0 ** -7
    else:
        params["embed"][batch["tokens"][0, 0], 0] *= 1 + 2.0 ** -7
    return params, batch


def _jax_bf16_grads(out: str) -> None:
    """The JAX package's bf16 gradients of every reduced config, jitted, to
    ``out`` (npz), and, under ``<name>/sens``, how far the whole tree moves
    (relative L2) when one element of the first token's input moves by one
    bf16 ulp (``_nudged``).  Run in a process of its own, started with
    ``--xla_allow_excess_precision=false``."""
    res = {}
    for name in sorted(JARCHS):
        jcfg = dataclasses.replace(JARCHS[name].reduced(), compute_dtype=jnp.bfloat16)
        grad = jax.jit(jax.value_and_grad(jbuild(jcfg).loss, has_aux=True))
        params, batch = _jparams(JARCHS[name].reduced()), _batch(jcfg)
        g = _flat(grad(params, jax.tree.map(jnp.asarray, batch))[1])
        params, batch = _nudged(params, batch)
        res[name] = g
        res[f"{name}/sens"] = _rel(_flat(grad(params, jax.tree.map(jnp.asarray, batch))[1]), g)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def jax_bf16_grads(tmp_path_factory):
    out = tmp_path_factory.mktemp("bf16") / "grads.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    code = f"import test_torch_train as t; t._jax_bf16_grads({str(out)!r})"
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=600, cwd=str(ROOT))
    return dict(np.load(out))


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_grads_match_jax_bf16(name, jax_bf16_grads):
    """The whole tree within 2e-2, or, for a reduced model whose reference
    bf16 gradient moves more than 8e-2 for one bf16 ulp of one input
    element (``/sens``, measured on the reference: no bf16 implementation
    that rounds anywhere differently can be held closer than that move),
    within a quarter of that move."""
    tcfg = dataclasses.replace(ARCHS[name].reduced(), compute_dtype=torch.bfloat16)
    params, batch = _jparams(JARCHS[name].reduced()), _batch(tcfg)
    _, _, grads = _port_grads(tcfg, params, batch)
    err = _rel(_flat(to_jax(tcfg, grads)), jax_bf16_grads[name])
    bound = max(BF16_TOL, float(jax_bf16_grads[f"{name}/sens"]) / 4)
    assert err <= bound, f"{name}: {err:.3g} > {bound:.3g}"


def test_bf16_head_backward_contracts_the_fp32_gradient():
    """The card's head (``_Bf16Head``; its GEMMs run here on upcast
    operands, which is exact) against the reference's transpose of
    ``jnp.dot(h, w, preferred_element_type=float32)``, which contracts the
    fp32 gradient with the bf16 operands: the bf16 gradients within 2e-4
    relative L2 (a bf16 rounding of fp32 sums taken in another order), and
    ``bf16_head_grads``' fp32 products within 1e-5 of float64, where
    rounding the gradient to bf16 first is 1.6e-3 away."""
    rng = np.random.default_rng(0)
    h = jnp.asarray(rng.standard_normal((64, 48)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((48, 512)) * 0.05, jnp.bfloat16)
    g = (rng.standard_normal((64, 512)) * 1e-3).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32), h, w)
    jdh, jdw = vjp(jnp.asarray(g))
    th, tw = (torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16().requires_grad_() for x in (h, w))
    out = mmodel._Bf16Head.apply(th, tw)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32 and th.grad.dtype == tw.grad.dtype == torch.bfloat16
    assert _rel(th.grad.float(), jdh.astype(jnp.float32)) <= 2e-4
    assert _rel(tw.grad.float(), jdw.astype(jnp.float32)) <= 2e-4
    h64, w64 = th.detach().double().numpy(), tw.detach().double().numpy()
    dh, dw = mmodel.bf16_head_grads(th.detach(), tw.detach(), torch.from_numpy(g))
    assert _rel(dh, g @ w64.T) <= 1e-5 and _rel(dw, h64.T @ g) <= 1e-5
    rounded = torch.from_numpy(g).bfloat16().double().numpy()
    assert _rel(rounded @ w64.T, g @ w64.T) > 1e-3


@pytest.mark.parametrize("layers", [2, 4, 8])
def test_grad_norm_growth_with_depth_is_the_reference(layers, capsys):
    """The init's global gradient norm grows steeply with depth in the
    reference itself (reduced starcoder2-7b, fp32, B = 2, S = 64: 42, 371
    and 1822 at 2, 4 and 8 layers), and the port's, from the same
    parameters, is the reference's within 1e-3."""
    jcfg = dataclasses.replace(JARCHS["starcoder2-7b"].reduced(), n_layers=layers)
    tcfg = dataclasses.replace(ARCHS["starcoder2-7b"].reduced(), n_layers=layers)
    params, batch = _jparams(jcfg), _batch(jcfg, s=64)
    _, jg = jax.jit(jax.value_and_grad(jbuild(jcfg).loss, has_aux=True))(params, jax.tree.map(jnp.asarray, batch))
    _, _, grads = _port_grads(tcfg, params, batch)
    jn, tn = np.linalg.norm(_flat(jg)), np.linalg.norm(_flat(to_jax(tcfg, grads)))
    with capsys.disabled():
        print(f"\nstarcoder2-7b reduced, {layers} layers: grad_norm jax={jn:.6g} port={tn:.6g} "
              f"embed jax={np.linalg.norm(np.asarray(jg['embed'])):.6g}")
    assert abs(tn - jn) <= 1e-3 * jn
    assert jn > {2: 20, 4: 200, 8: 1000}[layers]


@pytest.mark.parametrize("name", sorted(JARCHS))
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_none_bit_for_bit(name, remat):
    base = ARCHS[name].reduced()
    params, batch = _jparams(JARCHS[name].reduced()), _batch(base)
    want = _port_grads(dataclasses.replace(base, remat="none"), params, batch)
    got = _port_grads(dataclasses.replace(base, remat=remat), params, batch)
    assert torch.equal(got[0], want[0])
    for k, g in want[2].items():
        assert torch.equal(got[2][k], g), k


def test_remat_recomputes_under_grad_only():
    """``full`` keeps only each group's input: the forward saves fewer
    tensors for the backward than ``none``."""
    cfg = ARCHS["qwen3-32b"].reduced()
    params, batch = _jparams(JARCHS["qwen3-32b"].reduced()), _tbatch(_batch(cfg))
    saved = {}
    for remat in ("none", "full"):
        model = params_from_jax(dataclasses.replace(cfg, remat=remat), params, device="cpu", train=True)
        n = [0]

        def pack(t):
            n[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model.loss_of(model.train_params(), batch)
        saved[remat] = n[0]
    assert saved["full"] < saved["none"] / 2


def test_frozen_model_takes_no_checkpoint():
    """A serving model's forward and loss in grad mode, at remat ``full``
    with chunked attention and cross-entropy, record nothing, so they take
    no checkpoint (which would hold the model in a reference cycle): the
    model is freed with the garbage collector off."""
    import gc
    import weakref

    cfg = dataclasses.replace(ARCHS["qwen3-32b"].reduced(), remat="full", attn_q_chunk=8, loss_chunk=8)
    batch = _tbatch(_batch(cfg))
    gc.disable()
    try:
        model = build_model(cfg, device="cpu")
        ref = weakref.ref(model.params["final_norm"]["scale"])
        model.loss(batch)
        model({"tokens": batch["tokens"]})
        del model
        assert ref() is None
    finally:
        gc.enable()


def test_layout_functions_round_trip():
    jcfg, tcfg = JARCHS["zamba2-2.7b"].reduced(), ARCHS["zamba2-2.7b"].reduced()
    params = _jparams(jcfg)
    flat = to_port(tcfg, params, device="cpu")
    assert set(flat) == set(build_model(tcfg, device="meta", train=True).train_params())
    back = to_jax(tcfg, flat)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_training_form_masters():
    cfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"].reduced(), compute_dtype=torch.bfloat16)
    model = build_model(cfg, device="cpu", train=True)
    for k, p in model.train_params().items():
        assert p.dtype == torch.float32 and p.requires_grad, k
    serve = build_model(cfg, device="cpu")
    assert serve.train_params()["stack.groups.0.layers.0.attn.wq"].dtype == torch.bfloat16
    assert serve.train_params()["stack.groups.0.layers.0.mlp.router"].dtype == torch.float32
    assert not any(p.requires_grad for p in serve.parameters())


# --------------------------------------------------------------------------
# flash under autograd
# --------------------------------------------------------------------------
def test_flash_raises_under_autograd():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 16, 8)).astype(np.float32)) for _ in range(3))
    fa.flash_attention(q, k, v)  # no grad wanted: runs
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        fa.flash_attention(q, k, v)
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    # the reference cannot differentiate its pallas_call either
    jq, jk, jv = (jnp.asarray(x.detach().numpy()) for x in (q, k, v))
    with pytest.raises(Exception):
        jax.grad(lambda x: jfa.flash_attention(x, jk, jv, block_q=16, block_k=16, interpret=True).sum())(jq)


def test_training_loss_with_flash_raises():
    """``use_pallas`` in the training form raises; it never returns
    gradients with the attention's cut to zero."""
    jcfg = JARCHS["qwen3-32b"].reduced()
    tcfg = dataclasses.replace(ARCHS["qwen3-32b"].reduced(), use_pallas=True)
    model = params_from_jax(tcfg, _jparams(jcfg), device="cpu", train=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        model.value_and_grad(model.train_params(), _tbatch(_batch(tcfg)))


# --------------------------------------------------------------------------
# UTP train-step task tree
# --------------------------------------------------------------------------
def _utp_case():
    jcfg, tcfg = JARCHS["qwen3-32b"].reduced(), ARCHS["qwen3-32b"].reduced()
    params = _jparams(jcfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)}
    return jcfg, tcfg, params, batch


@pytest.mark.parametrize("executor", ["eager", "fused"])
@pytest.mark.parametrize("m", [1, 2])
def test_utp_train_step_matches_jax(executor, m):
    jcfg, tcfg, params, batch = _utp_case()
    jmodel = jbuild(jcfg)
    jocfg, tocfg = joptim.AdamWConfig(lr=1e-3), optim.AdamWConfig(lr=1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    jutp = JUTPTrainStep(lambda p, b: jmodel.loss(p, b), jocfg, microbatches=m, executor=executor)
    tmodel = build_model(tcfg, device="meta", train=True)
    tutp = UTPTrainStep(tmodel.value_and_grad, tocfg, microbatches=m, executor=executor, device="cpu")
    jo = joptim.init(jp, jocfg)
    tp = to_port(tcfg, params, device="cpu")
    to = optim.init(tp, tocfg)
    for call in range(2):
        jp, jo, jmet = jutp(jp, jo, jax.tree.map(jnp.asarray, batch))
        tp, to, tmet = tutp(tp, to, _tbatch(batch))
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0], jax.tree.leaves(to_jax(tcfg, tp))):
            np.testing.assert_allclose(b, np.asarray(a), **STEP_TOL, err_msg=f"call {call} {jax.tree_util.keystr(path)}")
        assert set(tmet) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(tmet[k].numpy(), np.asarray(jmet[k]), **STEP_TOL)
        # compiles: the JAX fused executor compiles once, then hits its cache
        assert tutp.executor.stats["compiles"] == jutp.executor.stats["compiles"]
    assert tutp.executor.stats["compiles"] == (1 if executor == "fused" else 0)
    assert tutp.executor.stats["tasks"] == jutp.executor.stats["tasks"] == 2 * (m + 2)


def test_utp_fused_compiles_once_and_keeps_handles():
    _, tcfg, params, batch = _utp_case()
    tmodel = build_model(tcfg, device="meta", train=True)
    utp = UTPTrainStep(tmodel.value_and_grad, optim.AdamWConfig(lr=1e-3), microbatches=2, device="cpu")
    p, o = to_port(tcfg, params, device="cpu"), None
    o = optim.init(p, utp.opt_cfg)
    key_handles = [g.id for g in utp.op._grads] + [utp.op._total.id]
    for _ in range(3):
        p, o, met = utp(p, o, _tbatch(batch))
    assert utp.executor.stats["compiles"] == 1
    assert [g.id for g in utp.op._grads] + [utp.op._total.id] == key_handles
    assert np.isfinite(float(met["loss"])) and int(o["count"]) == 3
    # the intermediates stay inside the step
    assert not any(h in utp.store for h in key_handles[:-1])


# --------------------------------------------------------------------------
# the step plan
# --------------------------------------------------------------------------
def test_make_train_step_matches_direct_jax_steps():
    """``make_train_step(...).jitted()`` (eager on the CPU) over 2 steps, at
    microbatches 1 and 2, against the reference's microbatched step."""
    jcfg0, tcfg0, params, batch = _utp_case()
    for m in (1, 2):
        jcfg, tcfg = dataclasses.replace(jcfg0, microbatches=m), dataclasses.replace(tcfg0, microbatches=m)
        jmodel = jbuild(jcfg)
        ocfg_j = joptim.AdamWConfig(lr=joptim.warmup_cosine(1e-3, 1, 4))
        ocfg_t = optim.AdamWConfig(lr=optim.warmup_cosine(1e-3, 1, 4))
        plan = make_train_step(tcfg, None, ShapeConfig("t", 16, 4, "train"), ocfg_t, device="cpu")
        assert isinstance(plan, StepPlan) and plan.donate_argnums == (0, 1)
        assert all(t.device.type == "meta" for t in jax.tree.leaves(plan.args, is_leaf=torch.is_tensor))
        step = plan.jitted()
        jp = jax.tree.map(jnp.asarray, params)
        jo = joptim.init(jp, ocfg_j)
        tp = to_port(tcfg, params, device="cpu")
        to = optim.init(tp, ocfg_t)

        def direct(p, o, b):
            mb = jax.tree.map(lambda x: x.reshape((m, 4 // m) + x.shape[1:]), b)
            gs = [jax.grad(lambda pp: jmodel.loss(pp, jax.tree.map(lambda x: x[i], mb))[0])(p) for i in range(m)]
            return joptim.update(jax.tree.map(lambda *xs: sum(xs) / m, *gs), o, p, ocfg_j)

        for _ in range(2):
            jp, jo, _ = direct(jp, jo, jax.tree.map(jnp.asarray, batch))
            tp2, to2, met = step(tp, to, _tbatch(batch))
            assert tp2 is tp and to2 is to  # donated: updated in place
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(to_jax(tcfg, tp))):
            np.testing.assert_allclose(b, np.asarray(a), **STEP_TOL)
        assert step.compiles == 1 and step.graph_replays == 0 and not step.captured
        assert {"loss", "xent", "accuracy", "grad_norm", "lr"} <= set(met)


@pytest.mark.parametrize("change", ["batch", "dtype", "order"])
def test_jitted_step_refuses_another_signature(change):
    """The jitted step is bound to its first call's trees: a smaller batch
    (which would broadcast into the static buffers), int64 tokens (which
    would be cast) or the batch's keys in another order (which would land
    in the wrong buffers) raise ``CaptureError`` naming the step; the
    first signature still runs."""
    cfg = ARCHS["qwen3-32b"].reduced()
    plan = make_train_step(cfg, None, ShapeConfig("t", 16, 4, "train"), device="cpu")
    step = plan.jitted()
    p = build_model(cfg, device="cpu", train=True).train_params()
    o = optim.init(p, optim.AdamWConfig())
    b = _tbatch(_batch(cfg, b=4))
    step(p, o, b)
    other = {"batch": {**b, "labels": b["labels"][:1]}, "dtype": {**b, "tokens": b["tokens"].long()},
             "order": {"labels": b["labels"], "tokens": b["tokens"]}}[change]
    with pytest.raises(CaptureError, match=plan.name):
        step(p, o, other)
    step(p, o, b)
    assert int(o["count"]) == 2


def test_step_plan_mesh_and_device():
    """A mesh whose axes the rule tables do not know is refused (plans over
    ("data", "model") meshes: tests/test_torch_launch*.py); a batch on
    another device than the plan's raises."""
    class TwoDevices:
        mesh_dim_names = ("x",)

        def size(self):
            return 2

    cfg = ARCHS["qwen3-32b"].reduced()
    shape = ShapeConfig("t", 16, 4, "train")
    with pytest.raises(ValueError, match="mesh axes"):
        make_train_step(cfg, TwoDevices(), shape, device="cpu")
    plan = make_train_step(cfg, None, shape, device="cpu")
    p = build_model(cfg, device="cpu", train=True).train_params()
    with pytest.raises(ValueError, match="plan's device"):
        plan.fn(p, optim.init(p, optim.AdamWConfig()), {k: v.to("meta") for k, v in _tbatch(_batch(cfg)).items()})


def test_entry_points_default_to_cuda():
    """No device means CUDA: without it every entry point raises."""
    cfg = ARCHS["qwen3-32b"].reduced()
    shape = ShapeConfig("t", 16, 4, "train")
    if torch.cuda.is_available():
        assert make_train_step(cfg, None, shape).static_meta["device"].type == "cuda"
        return
    for call in (lambda: make_train_step(cfg, None, shape), lambda: Trainer(cfg, shape),
                 lambda: UTPTrainStep(lambda p, b: None, optim.AdamWConfig()),
                 lambda: __import__("repro_torch.launch.train", fromlist=["main"]).main(
                     ["--arch", "qwen3-32b", "--reduced", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# --------------------------------------------------------------------------
# checkpoints: the port's copies of the reference's five, and across packages
# --------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4), "b": {"c": torch.ones(2, dtype=torch.int32)}}
    ck.save(5, state)
    out, step = ck.restore(state, device="cpu")
    assert step == 5
    assert torch.equal(out["a"], state["a"]) and torch.equal(out["b"]["c"], state["b"]["c"])


def test_checkpoint_gc_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_crc_detects_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, {"x": torch.arange(8.0)})
    d = tmp_path / "step_00000001"
    meta = json.loads((d / "meta.json").read_text())
    meta["crc"]["x"] ^= 0xDEADBEEF
    (d / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(IOError):
        ck.restore({"x": torch.zeros(8)}, device="cpu")


def test_checkpoint_async(tmp_path):
    ck = Checkpointer(str(tmp_path))
    x = torch.ones(4)
    ck.save_async(7, {"x": x})
    x.add_(1)  # the save took its host copy before returning
    ck.wait()
    assert ck.latest_step() == 7
    assert torch.equal(ck.restore({"x": x}, device="cpu")[0]["x"], torch.ones(4))


def test_checkpoint_elastic_restore(tmp_path):
    """Save, then restore into a target that has only shapes and dtypes
    (meta tensors, as a plan's arguments), placed on the device asked for:
    the elastic path of a restart on other hardware."""
    ck = Checkpointer(str(tmp_path))
    state = {"w": torch.arange(16.0).reshape(4, 4), "h": torch.arange(6.0).to(torch.bfloat16)}
    ck.save(1, state)
    target = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in state.items()}
    out, _ = ck.restore(target, device="cpu")
    assert out["w"].device.type == "cpu" and torch.equal(out["w"], state["w"])
    assert out["h"].dtype == torch.bfloat16 and torch.equal(out["h"], state["h"])


def test_checkpoint_bf16_keeps_its_bits(tmp_path):
    ck = Checkpointer(str(tmp_path))
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    ck.save(2, {"x": x, "c": torch.tensor(3, dtype=torch.int32)})
    meta = json.loads((tmp_path / "step_00000002" / "meta.json").read_text())
    assert meta["dtypes"] == {"x": "bfloat16", "c": "int32"} and meta["keys"] == ["c", "x"]
    out, _ = ck.restore({"x": x, "c": torch.tensor(0, dtype=torch.int32)}, device="cpu")
    assert torch.equal(out["x"].view(torch.int16), x.view(torch.int16)) and int(out["c"]) == 3


def _ckpt_state():
    rng = np.random.default_rng(5)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "layers": [{"b": rng.standard_normal(4).astype(np.float32)} for _ in range(2)]},
            "opt": {"count": np.array(7, np.int32)}}


def test_checkpoint_written_by_jax_restores_in_port(tmp_path):
    state = _ckpt_state()
    JCheckpointer(str(tmp_path)).save(3, jax.tree.map(jnp.asarray, state))
    target = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(a).dtype), state)
    out, step = Checkpointer(str(tmp_path)).restore(target, device="cpu")
    assert step == 3
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), out))):
        np.testing.assert_array_equal(b, a)


def test_checkpoint_written_by_port_restores_in_jax(tmp_path):
    state = _ckpt_state()
    Checkpointer(str(tmp_path)).save(4, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), state))
    out, step = JCheckpointer(str(tmp_path)).restore(jax.tree.map(jnp.asarray, state))
    assert step == 4
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(out)):
        np.testing.assert_array_equal(np.asarray(b), a)


# --------------------------------------------------------------------------
# trainer: the port's copies of the reference's four, and against its steps
# --------------------------------------------------------------------------
def small_trainer(tmp_path, steps=12, ckpt_every=4, lr=3e-3):
    cfg = ARCHS["qwen3-32b"].reduced()
    shape = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
    return Trainer(
        cfg, shape, None,
        TrainerConfig(steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(tmp_path), log_every=100, seed=0),
        opt_cfg=optim.AdamWConfig(lr=lr),
        device="cpu",
    )


def test_trainer_loss_decreases(tmp_path):
    out = small_trainer(tmp_path, steps=30).train()
    losses = [m["loss"] for m in out["metrics"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    assert out["step"] == 30


def test_trainer_resume(tmp_path):
    small_trainer(tmp_path, steps=8, ckpt_every=4).train()
    out2 = small_trainer(tmp_path, steps=12, ckpt_every=4).train()
    assert out2["step"] == 12
    assert out2["metrics"][0]["step"] == 9  # continued, not restarted


def test_trainer_failure_recovery(tmp_path):
    t = small_trainer(tmp_path, steps=10, ckpt_every=2)
    fail_at = {6}

    def inject(step):
        if step in fail_at:
            fail_at.discard(step)  # fail once
            return True
        return False

    out = t.train(inject_failure=inject)
    assert out["step"] == 10
    assert out["failures"] == 1


def test_trainer_too_many_failures_raises(tmp_path):
    t = small_trainer(tmp_path, steps=10, ckpt_every=2)
    t.tcfg.max_failures = 1
    with pytest.raises(RuntimeError):
        t.train(inject_failure=lambda s: True)


def test_trainer_matches_reference_steps(tmp_path):
    """3 ``Trainer`` steps from the JAX init against a loop of the
    reference's direct step (``jax.value_and_grad(model.loss)`` then
    ``optim.update``) over the same synthetic batches, at the lr of the
    reference's step-equivalence test (1e-3).  Adam divides each gradient
    element by its own magnitude plus eps = 1e-8, so an element of ~1e-8
    (six orders under its leaf's largest) whose fp32 sums differ by 10 %
    between the packages moves its parameter apart by ~lr / 40 a step: at
    the trainer tests' 3e-3 one of 8192 elements ends 5.6e-5 apart, past
    atol 2e-5."""
    jcfg = JARCHS["qwen3-32b"].reduced()
    params = _jparams(jcfg)
    t = small_trainer(tmp_path, steps=3, ckpt_every=100, lr=1e-3)
    t.init_state = lambda: (lambda p: (p, optim.init(p, t.opt_cfg)))(to_port(t.cfg, params, device="cpu"))
    out = t.train()
    jmodel, ocfg = jbuild(jcfg), joptim.AdamWConfig(lr=1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    jo = joptim.init(jp, ocfg)
    ds = jpipe.SyntheticLMDataset(jpipe.DataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=4, seed=0))
    losses = []
    for i in range(3):
        (loss, _), g = jax.value_and_grad(jmodel.loss, has_aux=True)(jp, jax.tree.map(jnp.asarray, ds.batch(i)))
        jp, jo, _ = joptim.update(g, jo, jp, ocfg)
        losses.append(float(loss))
    np.testing.assert_allclose([m["loss"] for m in out["metrics"]], losses, **STEP_TOL)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(to_jax(t.cfg, out["params"]))):
        np.testing.assert_allclose(b, np.asarray(a), **STEP_TOL)
    assert int(out["opt_state"]["count"]) == 3
    # and the checkpoint it wrote at the last step restores the same state
    rp, ro, step = t._restore()
    assert step == 3 and int(ro["count"]) == 3 and all(torch.equal(rp[k], v) for k, v in out["params"].items())


# --------------------------------------------------------------------------
# roofline and the entry point
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(JARCHS))
def test_model_flops_match_jax(name):
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        want = jroofline.model_flops(JARCHS[name], JSHAPES[shape])
        assert roofline.model_flops(ARCHS[name], SHAPES[shape]) == want
    small = (ShapeConfig("s", 64, 2, "train"), JShapeConfig("s", 64, 2, "train"))
    assert roofline.model_flops(ARCHS[name].reduced(), small[0]) == jroofline.model_flops(JARCHS[name].reduced(),
                                                                                          small[1])


def test_launch_train_runs(tmp_path, capsys):
    from repro_torch.launch.train import main

    out = main(["--arch", "qwen3-32b", "--reduced", "--steps", "4", "--device", "cpu",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert out["step"] == 4 and out["failures"] == 0
    assert "finished at step 4" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 4]
