"""The port's MoE layer against the JAX package's on the CPU: the same layer
parameters (the JAX package's ``jax.random`` init, carried across as numpy)
and the same numpy inputs through both ``moe_apply``s, for the gather and the
dense dispatch, granite's all-MoE layer and llama4's routed layer with its
shared expert; the port's copies of tests/test_moe_serving.py's dispatch
tests; and queue C1: the router keeps fp32 at load, so a near tie routes as
the JAX package routes it.

Tolerances: outputs and aux at 1e-5 (float32 in both packages; a token's k
expert outputs summed in another order).  Before any output is compared the
routing indices must be equal, and every token's k-th and (k+1)-th router
logits must lie more than 1e-4 apart, so no test rests on a near tie that
the two packages' float32 sums could order differently."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.models.layers import init_params
from repro_torch.configs import ARCHS
from repro_torch.models import moe, params_from_jax

TOL = 1e-5
GAP = 1e-4


def _cfgs(name, **kw):
    return (dataclasses.replace(JARCHS[name].reduced(), **kw), dataclasses.replace(ARCHS[name].reduced(), **kw))


def _layer(jcfg):
    """The JAX package's MoE layer parameters (numpy) from its init."""
    p = init_params(jmoe.moe_template(jcfg), jax.random.PRNGKey(0), jnp.float32)
    return jax.tree.map(np.asarray, p)


def _torch(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(cfg, B, S, seed):
    return (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)


def _routing_checked(jcfg, tcfg, p, x):
    """Both routers on the same tokens: equal indices, no near tie at the
    top-k cut."""
    xf = x.reshape(-1, x.shape[-1])
    _, jidx, _ = jmoe._router(jcfg, jnp.asarray(p["router"]), jnp.asarray(xf))
    _, tidx, _ = moe._router(tcfg, torch.from_numpy(np.array(p["router"])), torch.from_numpy(xf))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    logits = np.sort(xf.astype(np.float64) @ p["router"].astype(np.float64), axis=-1)[:, ::-1]
    k = tcfg.top_k
    assert (logits[:, k - 1] - logits[:, k]).min() > GAP


CASES = [("granite-moe-1b-a400m", "gather", 1.25), ("granite-moe-1b-a400m", "dense", 1.25),
         ("llama4-maverick-400b-a17b", "gather", 1.25), ("llama4-maverick-400b-a17b", "dense", 1.25),
         ("granite-moe-1b-a400m", "gather", 0.5), ("llama4-maverick-400b-a17b", "gather", 8.0)]


@pytest.mark.parametrize("name,dispatch,capacity", CASES)
def test_moe_apply_matches_jax(name, dispatch, capacity):
    """Out and aux of one MoE layer (B = 2, S = 16; granite top-2 of 4
    experts, llama4 top-1 of 4 with its shared expert), at the default
    capacity factor (tokens dropped), a smaller one and an ample one."""
    jcfg, tcfg = _cfgs(name, moe_dispatch=dispatch, capacity_factor=capacity)
    p = _layer(jcfg)
    x = _x(jcfg, 2, 16, seed=11)
    _routing_checked(jcfg, tcfg, p, x)
    jout, jaux = jmoe.moe_apply(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tout, taux = moe.moe_apply(tcfg, _torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL, atol=TOL)


def test_capacity_and_slots_match_jax():
    """The capacity and each assignment's buffer row (overflow row E*C for
    a drop) as the JAX package's gather dispatch computes them."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", capacity_factor=0.25)
    p = _torch(_layer(jcfg))
    xf = _x(jcfg, 2, 16, seed=12).reshape(32, -1)
    _, idx, _ = moe._router(tcfg, p["router"], torch.from_numpy(xf))
    C = moe._capacity(tcfg, 32)
    assert C == jmoe._capacity(jcfg, 32) == 4
    dest = moe._slots(tcfg, idx, C).numpy()
    flat = idx.reshape(-1).numpy()
    want = []
    for t, e in enumerate(flat):  # the n-th assignment to e, in flattened order
        n = int((flat[:t] == e).sum())
        want.append(e * C + n if n < C else tcfg.n_experts * C)
    np.testing.assert_array_equal(dest, want)
    assert (dest == tcfg.n_experts * C).any()  # some assignments drop


def test_gather_vs_dense_dispatch():
    """The port's copy of tests/test_moe_serving.py's test: with no drops
    the two dispatches compute the same layer."""
    _, cfg = _cfgs("granite-moe-1b-a400m", capacity_factor=8.0)
    p = _torch(_layer(JARCHS["granite-moe-1b-a400m"].reduced()))
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1)) * 0.5
    out_g, aux_g = moe.moe_apply(dataclasses.replace(cfg, moe_dispatch="gather"), p, x)
    out_d, aux_d = moe.moe_apply(dataclasses.replace(cfg, moe_dispatch="dense"), p, x)
    np.testing.assert_allclose(out_g.numpy(), out_d.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux_g), float(aux_d), rtol=1e-5, atol=1e-6)


def test_capacity_drops_tokens():
    _, cfg = _cfgs("granite-moe-1b-a400m", capacity_factor=0.05)  # force drops
    p = _torch(_layer(JARCHS["granite-moe-1b-a400m"].reduced()))
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(4)) * 0.5
    _, idx, _ = moe._router(cfg, p["router"], x.reshape(64, -1))
    C = moe._capacity(cfg, 64)
    assert (moe._slots(cfg, idx, C) == cfg.n_experts * C).sum() > 0
    out, aux = moe.moe_apply(cfg, p, x)
    assert torch.isfinite(out).all() and torch.isfinite(aux)


def test_top_k_ties_take_the_lower_expert_first():
    """jax.lax.top_k's order on exact ties, which the slot count follows."""
    _, cfg = _cfgs("granite-moe-1b-a400m")
    w = torch.zeros(cfg.d_model, cfg.n_experts)
    w[:, 3] = 1.0
    x = torch.ones(3, cfg.d_model)
    _, idx, _ = moe._router(cfg, w, x)  # expert 3 leads, 0, 1, 2 tie
    _, jidx, _ = jmoe._router(JARCHS["granite-moe-1b-a400m"].reduced(), jnp.asarray(w.numpy()), jnp.asarray(x.numpy()))
    assert idx.tolist() == [[3, 0]] * 3 == np.asarray(jidx).tolist()


def _near_tie(cfg, T):
    """A router whose experts 0 and 1 differ below bf16's resolution, and
    tokens for which expert 2 leads (by 10 % of the shared column's weight,
    so the second expert keeps a real gate) and 0 or 1 takes the second
    place: in float32 expert 1 wins by 2^-10 of the shared column's weight;
    rounded to bf16 the two columns are equal and the tie goes to expert 0."""
    rng = np.random.default_rng(5)
    base = torch.from_numpy(rng.standard_normal(cfg.d_model).astype(np.float32) * 0.1)
    base = base.bfloat16().float()
    w = torch.zeros(cfg.d_model, cfg.n_experts)
    w[:, 0] = base
    w[:, 1] = base + base.abs() * 2.0 ** -10  # a quarter of a bf16 ulp: rounds back to base
    w[:, 2] = base + base.abs() * 0.1
    w[:, 3] = base - base.abs() * 0.1
    x = torch.from_numpy(np.abs(rng.standard_normal((T, cfg.d_model))).astype(np.float32)).bfloat16()
    assert torch.equal(w[:, 0].bfloat16(), w[:, 1].bfloat16())
    return w, x


def test_c1_router_stays_fp32_and_routes_a_near_tie_as_jax():
    """Queue C1.  A bf16 model keeps every leaf under ``router`` in fp32 at
    load, and a near tie between two experts routes the same in both
    packages.  The same comparison fails with the router cast to bf16,
    which is what the port's load did before: the test holds the fix."""
    kw = dict(compute_dtype=jnp.bfloat16, cache_dtype=jnp.bfloat16, capacity_factor=2.0)  # no drops
    jcfg = dataclasses.replace(JARCHS["granite-moe-1b-a400m"].reduced(), **kw)
    tcfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"].reduced(), compute_dtype=torch.bfloat16,
                               cache_dtype=torch.bfloat16, capacity_factor=2.0)
    w, x = _near_tie(tcfg, 24)
    tree = jax.tree.map(np.array, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    tree["stack"]["groups"]["layers"][0]["mlp"]["router"][:] = w.numpy()
    model = params_from_jax(tcfg, tree, device="cpu")
    layer = model.params["stack"]["groups"][0]["layers"][0]["mlp"]
    assert layer["router"].dtype == torch.float32 and layer["wi"].dtype == torch.bfloat16

    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    _, jidx, _ = jmoe._router(jcfg, jnp.asarray(w.numpy()), jx)
    _, tidx, _ = moe._router(tcfg, layer["router"], x)
    _, bidx, _ = moe._router(tcfg, layer["router"].bfloat16(), x)
    assert (np.asarray(jidx)[:, 1] == 1).all()  # float32: expert 1 takes second place
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert (bidx[:, 1] == 0).all()  # a bf16 router ties, and expert 0 takes it

    # the whole layer in bf16: the JAX package's cast_for_forward keeps the router fp32
    jp = {k: (jnp.asarray(v[0]) if k == "router" else jnp.asarray(v[0]).astype(jnp.bfloat16))
          for k, v in tree["stack"]["groups"]["layers"][0]["mlp"].items()}
    jout, _ = jmoe.moe_apply(jcfg, jp, jx[None])
    tout, _ = moe.moe_apply(tcfg, layer, x[None])
    bf16_router = {k: layer[k] for k in ("wi", "wg", "wo")}
    bf16_router["router"] = layer["router"].bfloat16()
    bout, _ = moe.moe_apply(tcfg, bf16_router, x[None])
    want = np.asarray(jout).astype(np.float32)
    scale = np.abs(want).max()
    assert np.abs(tout.float().numpy() - want).max() <= 2e-2 * scale
    assert np.abs(bout.float().numpy() - want).max() > 2e-1 * scale
