"""The port's ServeEngine programs against the JAX engine's jitted ones, on
the CPU at reduced widths.

The JAX engine jits three programs: the decode once, the prefill once per
prompt length (static ``pad_len``), the scatter once per slot (static
``slot``).  The port captures the decode and the scatters into CUDA graphs
on the card; on the CPU each runs eagerly and counts one compile a call
site, so the compile counts held here against ``jax.jit``'s
``_cache_size()`` are the ones the card shows.  The port's prefill is
never compiled: one eager call an admission, where the JAX engine compiles
one program a prompt length.  Tokens are held equal to the JAX engine's on
the same parameters (``params_from_jax``) and prompts: for a recurrent
family also over two requests of one prompt length through one slot, which
a one-row prefill cache that kept the first request's state would break.
Sampling is a Gumbel-max draw: every sampled token lies in its step's
top-k set, and the draws' frequencies match the softmax."""

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
from repro_torch.models import params_from_jax
from repro_torch.serving import EngineConfig, Request, ServeEngine
from repro_torch.serving.engine import sample

_PARAMS = {}

# chi-square quantile at 0.999 by degrees of freedom (scipy.stats.chi2.ppf(0.999, df))
CHI2_999 = {5: 20.515, 9: 27.877}


def _models(name):
    """The JAX config and parameters, and the port's model on them."""
    if name not in _PARAMS:
        jcfg = JARCHS[name].reduced()
        params = jbuild(jcfg).init(jax.random.PRNGKey(0))
        cfg = ARCHS[name].reduced()
        _PARAMS[name] = (jcfg, params, cfg, params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu"))
    return _PARAMS[name]


def _prompt(cfg, rng, n):
    """n prompt tokens, or n integer-valued frame embeddings for a stub
    frontend (the JAX engine casts prompts to int32; see
    tests/test_torch_engine.py)."""
    if cfg.frontend:
        return rng.integers(-1, 2, size=(n, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab, size=n)


def _both(name, specs, slots):
    """The same requests through the JAX engine and the port's: returns
    both engines and both request lists."""
    jcfg, params, cfg, m = _models(name)
    jeng = JServeEngine(jcfg, params, JEngineConfig(slots=slots, max_seq=32))
    table = np.array(jax.random.normal(jax.random.PRNGKey(7), (cfg.vocab, cfg.d_model))) if cfg.frontend else None
    teng = ServeEngine(cfg, m, EngineConfig(slots=slots, max_seq=32), device="cpu", stub_table=table)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=k) for i, (p, k) in enumerate(specs)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=k) for i, (p, k) in enumerate(specs)]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run_until_drained(max_steps=100)
    teng.run_until_drained(max_steps=100)
    return jeng, teng, jreqs, treqs


def _jax_compiles(jeng):
    return {"decode": jeng._decode._cache_size(), "prefill": jeng._prefill._cache_size(),
            "scatter": jeng._scatter._cache_size()}


def _compiles(teng):
    return {k: v["compiles"] for k, v in teng.stats.items()}


def _counts(jeng, teng, admissions):
    """The port's compiles against the JAX engine's: equal for the decode
    and the scatter; the port's prefill compiles nothing and runs once an
    admission.  Returns the JAX engine's."""
    want = _jax_compiles(jeng)
    assert _compiles(teng) == {**want, "prefill": 0}
    assert teng.stats["prefill"]["eager_calls"] == teng.prefills == admissions
    return want


@pytest.mark.parametrize("name", ["starcoder2-7b", "rwkv6-3b", "musicgen-large"])
def test_engine_compiles_match_jax_engine(name):
    """tests/test_torch_engine.py's schedule (five requests of three prompt
    lengths over two slots): equal tokens, the port's decode and scatter
    compiles equal to the JAX engine's jit cache sizes (1, 2), and five eager
    prefills where the JAX engine compiles three."""
    _, _, cfg, _ = _models(name)
    rng = np.random.default_rng(3)
    specs = [(_prompt(cfg, rng, n), k) for n, k in ((6, 5), (9, 3), (6, 4), (20, 6), (9, 2))]
    jeng, teng, jreqs, treqs = _both(name, specs, slots=2)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert _counts(jeng, teng, 5) == {"decode": 1, "prefill": 3, "scatter": 2}
    stats = teng.stats
    assert stats["decode"]["graph_replays"] == stats["scatter"]["graph_replays"] == 0  # no graph on the CPU
    assert stats["decode"]["pool_bytes"] == stats["scatter"]["pool_bytes"] == 0
    assert teng.decode_steps == jeng.decode_steps


@pytest.mark.parametrize("name", ["rwkv6-3b", "zamba2-2.7b"])
def test_engine_same_length_requests_through_one_slot(name):
    """Two requests of one prompt length, one after the other through one
    slot: the second prefill fills the same one-row cache as the first,
    which it must reset (the reference builds a fresh zeroed one): tokens
    equal to the JAX engine's, one scatter compile, two eager prefills."""
    _, _, cfg, _ = _models(name)
    rng = np.random.default_rng(5)
    specs = [(_prompt(cfg, rng, 7), 4), (_prompt(cfg, rng, 7), 4)]
    jeng, teng, jreqs, treqs = _both(name, specs, slots=1)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert _counts(jeng, teng, 2) == {"decode": 1, "prefill": 1, "scatter": 1}


def test_engine_sampled_tokens_inside_top_k():
    """Temperature and top-k through the decode program: every sampled
    token, of every slot and step, lies in that step's top-k set of the
    logits the program returned; a second engine of the same seed draws the
    same tokens."""
    _, _, cfg, m = _models("starcoder2-7b")
    ecfg = EngineConfig(slots=2, max_seq=32, temperature=1.0, top_k=3, seed=1)

    def run():
        eng = ServeEngine(cfg, m, ecfg, device="cpu")
        seen = []
        decode = eng._decode

        def recording(*args):
            out = decode(*args)
            seen.append(out)
            return out

        eng._decode = recording
        rng = np.random.default_rng(2)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=4 + i), max_new_tokens=6) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained(max_steps=50)
        return eng, decode, seen, reqs

    eng, decode, seen, reqs = run()
    assert len(seen) == eng.decode_steps and decode.compiles == 1
    for nxt, logits in seen:
        top = torch.topk(logits, 3, dim=-1).indices
        assert bool((top == nxt[:, None]).any(-1).all())
    assert all(len(r.out_tokens) == 6 for r in reqs)
    *_, again = run()
    assert [r.out_tokens for r in again] == [r.out_tokens for r in reqs]


@pytest.mark.parametrize("temperature,top_k", [(0.8, 6), (1.5, 0)])
def test_gumbel_max_draws_follow_the_softmax(temperature, top_k):
    """4000 seeded Gumbel-max draws from fixed logits over 10 tokens: none
    outside the top-k, and the counts against softmax(logits / T) over the
    kept tokens within the chi-square test's 0.999 quantile."""
    n, V = 4000, 10
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=V).astype(np.float32))
    gen = torch.Generator().manual_seed(11)
    draws = sample(logits.expand(n, V), temperature, top_k, gen)
    counts = torch.bincount(draws, minlength=V).double()
    kept = torch.topk(logits, top_k).indices if top_k else torch.arange(V)
    outside = torch.ones(V, dtype=torch.bool)
    outside[kept] = False
    assert counts[outside].sum() == 0
    p = torch.softmax(logits[kept].double() / temperature, dim=0)
    chi2 = float((((counts[kept] - n * p) ** 2) / (n * p)).sum())
    assert chi2 < CHI2_999[len(kept) - 1], chi2
    # greedy is the argmax, whatever the generator
    assert bool((sample(logits.expand(3, V), 0.0, top_k, gen) == logits.argmax()).all())


def test_engine_release_and_program_names():
    """Each captured program is its own call site, named for a
    CaptureError, and only the decode draws from the engine's generator:
    ``release`` drops every graph (none exist on the CPU) and keeps the
    counts."""
    _, _, cfg, m = _models("starcoder2-7b")
    eng = ServeEngine(cfg, m, EngineConfig(slots=3, max_seq=32), device="cpu")
    rng = np.random.default_rng(1)
    for i, n in enumerate((5, 5, 8, 5)):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n), max_new_tokens=2))
    eng.run_until_drained(max_steps=20)
    assert _compiles(eng) == {"decode": 1, "prefill": 0, "scatter": 3}
    assert eng.stats["prefill"]["eager_calls"] == 4
    assert eng._decode.name == "ServeEngine decode" and eng._decode.generators == (eng._gen,)
    assert sorted(c.name for c in eng._scatter.values()) == [f"ServeEngine scatter slot={i}" for i in range(3)]
    assert all(c.generators == () for c in eng._scatter.values())
    eng.release()
    assert not eng._decode.captured and _compiles(eng)["scatter"] == 3
