"""The port's LM path against the JAX package on the CPU, for all ten
shipped families at their reduced sizes: the same parameters (the JAX
package's ``jax.random`` init, carried across as numpy by
``params_from_jax``) and the same numpy tokens, or numpy frame/patch
embeddings for the stub-frontend families, through both.

Tolerances: forward hidden states, logits, the loss and its metrics
(``moe_aux`` too) at 1e-4 (float32 compute in both packages; the sums run
in another order, and the reduced models' logits are O(1)); the flash
kernel path on and off alike; the port's copy of
test_prefill_decode_matches_forward at that test's 2e-3; prefill/decode
logits and caches against the JAX package's at 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild
from repro.models.model import lm_logits as jlm_logits
from repro.models.model import param_counts as jparam_counts
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import build_model, param_counts, params_from_jax

TOL = 1e-4


NEW_FAMILIES = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b", "rwkv6-3b", "zamba2-2.7b",
                "musicgen-large", "pixtral-12b")


def _variants():
    """The reduced configs: starcoder2-7b (LayerNorm, GELU), gemma3-12b
    (local/global windows, qk-norm, GeGLU, tied and scaled embeddings),
    qwen3-32b (qk-norm, SwiGLU), a GQA starcoder2-7b (every reduced config
    has n_kv == n_heads), granite (all-MoE, top-2), llama4 (dense and MoE
    layers interleaved, top-1, a shared expert), rwkv6, zamba2 (Mamba2 and
    the shared block), musicgen (audio stub, sinusoidal positions) and
    pixtral (vision stub)."""
    out = {name: (JARCHS[name].reduced(), ARCHS[name].reduced())
           for name in ("starcoder2-7b", "gemma3-12b", "qwen3-32b")}
    j, t = out["starcoder2-7b"]
    out["starcoder2-7b-gqa"] = (dataclasses.replace(j, n_kv=2), dataclasses.replace(t, n_kv=2))
    out.update({name: (JARCHS[name].reduced(), ARCHS[name].reduced()) for name in NEW_FAMILIES})
    return out


VARIANTS = _variants()
_MODELS = {}


def _pair(name, use_pallas=False):
    """(JAX cfg, JAX params, port model) on one set of weights."""
    if name not in _MODELS:
        jcfg, tcfg = VARIANTS[name]
        params = jbuild(jcfg).init(jax.random.PRNGKey(0))
        _MODELS[name] = (params, jax.tree.map(np.asarray, params))
    params, tree = _MODELS[name]
    jcfg, tcfg = (dataclasses.replace(c, use_pallas=use_pallas) for c in VARIANTS[name])
    return jcfg, params, params_from_jax(tcfg, tree, device="cpu")


def _tokens(cfg, B, S, seed=24):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _inputs(cfg, B, S, seed=24):
    """Numpy model inputs: tokens, or (B, S, D) embeddings for a stub
    frontend (the scale of tests/test_models.py's)."""
    if cfg.frontend:
        return (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)) * 0.1).astype(np.float32)
    return _tokens(cfg, B, S, seed)


def _jb(cfg, x):
    return {"embeds" if cfg.frontend else "tokens": jnp.asarray(x)}


def _tb(cfg, x):
    return {"embeds" if cfg.frontend else "tokens": torch.from_numpy(np.asarray(x))}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_jax(name, use_pallas):
    """Hidden states, MoE aux and logits of the no-cache forward (S = 24 >
    gemma3's reduced window 16), through the flash kernel (JAX: Pallas in
    interpret mode) or the portable attention; the loss and every metric."""
    jcfg, params, model = _pair(name, use_pallas)
    x = _inputs(jcfg, 2, 24)
    jh, _, jaux = jbuild(jcfg).forward(params, _jb(jcfg, x))
    th, _, taux = model.forward_aux(_tb(jcfg, x))
    _close(th, jh)
    _close(taux, jaux)
    _close(model.lm_logits(th), jlm_logits(jcfg, params, jh))
    labels = np.roll(_tokens(jcfg, 2, 24, seed=7), -1, axis=1)
    jl, jm = jbuild(jcfg).loss(params, {**_jb(jcfg, x), "labels": jnp.asarray(labels)})
    tl_, tm = model.loss({**_tb(jcfg, x), "labels": torch.from_numpy(labels)})
    _close(tl_, jl)
    assert tm.keys() == jm.keys()
    for k in ("xent", "loss") + (("moe_aux",) if jcfg.is_moe else ()):
        _close(tm[k], jm[k])
    assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_decode_matches_forward(name):
    """The port's copy of tests/test_models.py's cache-consistency check:
    prefill S - 2 tokens, decode 2, against the no-cache forward (2e-3).
    As there, MoE configs take an ample capacity (8.0): routing is
    batch-global, so a prefix matches the whole sequence only without
    drops."""
    jcfg, _, m = _pair(name)
    if jcfg.is_moe:
        m.cfg = dataclasses.replace(m.cfg, capacity_factor=8.0)
    B, S = 2, 12
    x = _tb(jcfg, _inputs(jcfg, B, S))
    part = lambda sl: {k: v[:, sl] for k, v in x.items()}  # noqa: E731
    h_full, _ = m(x)
    want = m.lm_logits(h_full)
    cache = m.init_cache(B, S)
    logits_p, cache = m.prefill(part(slice(0, S - 2)), cache)
    _close(logits_p, want[:, S - 3], 2e-3)
    lg1, cache = m.decode_step(cache, part(slice(S - 2, S - 1)), S - 2)
    _close(lg1, want[:, S - 2], 2e-3)
    lg2, cache = m.decode_step(cache, part(slice(S - 1, S)), torch.tensor([S - 1, S - 1]))
    _close(lg2, want[:, S - 1], 2e-3)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_decode_matches_jax(name):
    """Prefill and two decode steps (a scalar position, then a per-row
    position vector with the rows at different positions) give the JAX
    package's logits and caches: KV rows, recurrent states and zamba2's
    shared-block KV, leaf for leaf."""
    jcfg, params, m = _pair(name)
    jm = jbuild(jcfg)
    B, S, Smax = 2, 10, 16
    x = _inputs(jcfg, B, S + 2, seed=5)
    jcache = jm.init_cache(B, Smax)
    tcache = m.init_cache(B, Smax)
    assert jax.tree.structure(jcache) == jax.tree.structure(tcache)
    jl, jcache = jm.prefill(params, _jb(jcfg, x[:, :S]), jcache)
    tl_, tcache = m.prefill(_tb(jcfg, x[:, :S]), tcache)
    _close(tl_, jl)
    jl, jcache = jm.decode_step(params, jcache, _jb(jcfg, x[:, S:S + 1]), jnp.asarray(S))
    tl_, tcache = m.decode_step(tcache, _tb(jcfg, x[:, S:S + 1]), S)
    _close(tl_, jl)
    pos = np.array([S + 1, S - 3], np.int32)  # row 1 rewrites an earlier position
    jl, jcache = jm.decode_step(params, jcache, _jb(jcfg, x[:, S + 1:]), jnp.asarray(pos))
    tl_, tcache = m.decode_step(tcache, _tb(jcfg, x[:, S + 1:]), torch.from_numpy(pos))
    _close(tl_, jl)
    for (path, jleaf), tleaf in zip(jax.tree.leaves_with_path(jcache), jax.tree.leaves(tcache)):
        assert tuple(tleaf.shape) == jleaf.shape
        if path[-1].key in ("ssm", "wkv"):
            # a recurrent state sums its whole history (entries up to ~1e2 at
            # these scales): held at 1e-4 of the leaf's largest magnitude
            scale = max(1.0, float(np.abs(np.asarray(jleaf)).max()))
            _close(tleaf.numpy() / scale, np.asarray(jleaf) / scale)
        else:
            _close(tleaf, jleaf)


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_param_counts_match_jax(name):
    """Template arithmetic only (nothing allocated), at full width; the MoE
    families' active counts take top_k / n_experts of the expert leaves
    (tests/test_models.py's bands: granite 0.3-0.55 B active, llama4
    12-20 B)."""
    got = param_counts(get_arch(name))
    assert got == jparam_counts(JARCHS[name])
    bands = {"granite-moe-1b-a400m": (0.3e9, 0.55e9), "llama4-maverick-400b-a17b": (12e9, 20e9)}
    lo, hi = bands.get(name, (got["total"], got["total"]))
    assert lo <= got["active"] <= hi


def test_reduced_configs_match_field_for_field():
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    for name in JARCHS:
        for j, t in ((JARCHS[name], ARCHS[name]), (JARCHS[name].reduced(), ARCHS[name].reduced())):
            jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
            assert jd.keys() == td.keys()
            for k, v in jd.items():
                assert dtypes.get(v, v) == td[k], (name, k)


def test_random_init_follows_the_jax_rules():
    """Seeded draws with the JAX init's scales: the same seed gives the same
    weights, ones/zeros where the template says so, std scale/sqrt(fan_in)."""
    cfg = get_arch("starcoder2-7b").reduced()
    a, b = build_model(cfg, seed=3, device="cpu"), build_model(cfg, seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    layer = a.params["stack"]["groups"][0]["layers"][0]
    assert torch.equal(layer["ln1"]["scale"], torch.ones(cfg.d_model))
    assert torch.equal(layer["ln1"]["bias"], torch.zeros(cfg.d_model))
    wi = torch.cat([g["layers"][0]["mlp"]["wi"].flatten() for g in a.params["stack"]["groups"]])
    assert float(wi.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)
    assert float(a.params["embed"].std()) == pytest.approx(0.02, rel=0.1)


def test_bf16_weights_are_cast_once_at_load():
    """Full-width dtypes on a tiny model: >= 2-D weights held in bf16, 1-D
    scales and biases in float32, the forward in bf16 and the logits fp32."""
    cfg = dataclasses.replace(get_arch("starcoder2-7b").reduced(), compute_dtype=torch.bfloat16,
                              cache_dtype=torch.bfloat16)
    m = build_model(cfg, device="cpu")
    for n, p in m.named_parameters():
        assert p.dtype == (torch.bfloat16 if p.dim() >= 2 else torch.float32), n
    h, _ = m({"tokens": torch.zeros(1, 8, dtype=torch.long)})
    assert h.dtype == torch.bfloat16 and m.lm_logits(h).dtype == torch.float32
