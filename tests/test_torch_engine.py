"""The port's ServeEngine on the CPU: copies of tests/test_moe_serving.py's
engine tests, and the JAX ServeEngine's greedy tokens and decode-step count
reproduced exactly on the same parameters (carried across by
``params_from_jax``) and prompts, for the dense, MoE, RWKV6, hybrid and
stub-frontend families.  Sampled tokens cannot match ``jax.random``'s
draws, so sampling is checked by validity: every decoded token lies in its
step's top-k set.

A stub-frontend prompt is (S, D) frame embeddings, and a decoded token
enters through the stub table, whose standard normal draw the test takes
from ``jax.random`` (the JAX engine's ``PRNGKey(7)``) and passes to the
port.  The JAX engine casts every prompt to int32 before its prefill, which
truncates float embeddings; the port keeps their values, so the prompts
here are integer-valued embeddings, on which both compute the same
function."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS
from repro_torch.models import build_model, params_from_jax
from repro_torch.serving import EngineConfig, Request, ServeEngine

_PARAMS = {}


def _jax_params(name, n_kv=None):
    key = (name, n_kv)
    if key not in _PARAMS:
        jcfg = JARCHS[name].reduced()
        if n_kv:
            jcfg = dataclasses.replace(jcfg, n_kv=n_kv)
        params = jbuild(jcfg).init(jax.random.PRNGKey(0))
        _PARAMS[key] = (jcfg, params, jax.tree.map(np.asarray, params))
    return _PARAMS[key]


def _port_model(name, n_kv=None):
    _, _, tree = _jax_params(name, n_kv)
    cfg = ARCHS[name].reduced()
    if n_kv:
        cfg = dataclasses.replace(cfg, n_kv=n_kv)
    return cfg, params_from_jax(cfg, tree, device="cpu")


@pytest.mark.parametrize("name", ["starcoder2-7b", "gemma3-12b", "rwkv6-3b"])
def test_engine_generates(name):
    cfg = ARCHS[name].reduced()
    m = build_model(cfg, device="cpu")
    eng = ServeEngine(cfg, m, EngineConfig(slots=2, max_seq=64), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=5 + i), max_new_tokens=4)
            for i in range(4)]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained(max_steps=200)
    assert len(done) == 4
    for r in done:
        assert len(r.out_tokens) == 4
        assert all(0 <= t < cfg.vocab for t in r.out_tokens)


def test_engine_greedy_matches_model():
    """Engine output == argmax decoding straight through the model."""
    cfg, m = _port_model("starcoder2-7b")
    prompt = np.array([1, 2, 3, 4, 5], dtype=np.int32)
    new = 4
    toks = list(prompt)
    for _ in range(new):
        h, _ = m({"tokens": torch.tensor([toks])})
        toks.append(int(m.lm_logits(h[:, -1]).argmax(-1)[0]))
    want = toks[len(prompt):]
    eng = ServeEngine(cfg, m, EngineConfig(slots=2, max_seq=32), device="cpu")
    r = Request(rid=0, prompt=prompt, max_new_tokens=new)
    eng.submit(r)
    eng.run_until_drained(max_steps=50)
    assert r.out_tokens == want


def test_engine_continuous_batching_slot_reuse():
    cfg, m = _port_model("starcoder2-7b")
    eng = ServeEngine(cfg, m, EngineConfig(slots=1, max_seq=32), device="cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=3), max_new_tokens=3) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained(max_steps=100)
    assert len(done) == 3  # one slot served all three sequentially
    assert eng.decode_steps == 3 * 2


def _prompt(cfg, rng, n):
    """n prompt tokens, or n integer-valued frame embeddings (values -1, 0
    and 1) for a stub frontend."""
    if cfg.frontend:
        return rng.integers(-1, 2, size=(n, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab, size=n)


@pytest.mark.parametrize("name,n_kv", [("starcoder2-7b", None), ("starcoder2-7b", 2), ("gemma3-12b", None),
                                       ("rwkv6-3b", None), ("granite-moe-1b-a400m", None), ("zamba2-2.7b", None),
                                       ("musicgen-large", None)])
def test_engine_greedy_matches_jax_engine(name, n_kv):
    """Five requests of three prompt lengths over two slots: the port's
    tokens, per request, and decode-step count equal the JAX engine's."""
    jcfg, params, _ = _jax_params(name, n_kv)
    cfg, m = _port_model(name, n_kv)
    rng = np.random.default_rng(3)
    specs = [(_prompt(cfg, rng, n), k) for n, k in ((6, 5), (9, 3), (6, 4), (20, 6), (9, 2))]
    jeng = JServeEngine(jcfg, params, JEngineConfig(slots=2, max_seq=32))
    table = np.array(jax.random.normal(jax.random.PRNGKey(7), (cfg.vocab, cfg.d_model))) if cfg.frontend else None
    teng = ServeEngine(cfg, m, EngineConfig(slots=2, max_seq=32), device="cpu", stub_table=table)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=k) for i, (p, k) in enumerate(specs)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=k) for i, (p, k) in enumerate(specs)]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run_until_drained(max_steps=100)
    teng.run_until_drained(max_steps=100)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert teng.decode_steps == jeng.decode_steps


def test_engine_samples_inside_top_k():
    cfg, m = _port_model("starcoder2-7b")
    eng = ServeEngine(cfg, m, EngineConfig(slots=2, max_seq=32, temperature=1.0, top_k=3, seed=1),
                      device="cpu")
    seen = []
    decode_step = m.decode_step

    def recording(cache, batch, pos):
        logits, cache = decode_step(cache, batch, pos)
        seen.append(logits.clone())
        return logits, cache

    m.decode_step = recording
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=4), max_new_tokens=5) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=50)
    assert len(seen) == eng.decode_steps == 4
    for slot, r in enumerate(reqs):
        assert len(r.out_tokens) == 5
        for step, tok in enumerate(r.out_tokens[1:]):  # the first token comes from the prefill
            assert tok in torch.topk(seen[step][slot], 3).indices.tolist()
    # the engine's generator is seeded: the same config samples the same tokens
    m.decode_step = decode_step
    again = ServeEngine(cfg, m, EngineConfig(slots=2, max_seq=32, temperature=1.0, top_k=3, seed=1),
                        device="cpu")
    rng = np.random.default_rng(2)
    reqs2 = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=4), max_new_tokens=5) for i in range(2)]
    for r in reqs2:
        again.submit(r)
    again.run_until_drained(max_steps=50)
    assert [r.out_tokens for r in reqs2] == [r.out_tokens for r in reqs]


def test_engine_rejects_a_model_elsewhere_and_a_long_prompt():
    cfg = ARCHS["starcoder2-7b"].reduced()
    m = build_model(cfg, device="cpu")
    eng = ServeEngine(cfg, m, EngineConfig(slots=1, max_seq=8), device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(6), max_new_tokens=4))
    with pytest.raises(ValueError, match="exceed max_seq"):
        eng.step()
    with pytest.raises(ValueError, match="lies on cpu"):
        ServeEngine(cfg, m, device="meta")
