"""The port's stub frontends on the CPU against the JAX package's: the
synthetic frame/patch embedders and the engine's stub token table, each fed
the JAX package's ``jax.random`` draw (which torch cannot reproduce) as
numpy, at 1e-5 (float32 products summed in another order); and the port's
own seeded draws: deterministic, standard normal, on the caller's device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import frontend as jfe
from repro_torch.configs import ARCHS
from repro_torch.models import frontend

TOL = 1e-5
NAMES = ["musicgen-large", "pixtral-12b"]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", NAMES)
def test_stub_frontend_contract(name):
    cfg = ARCHS[name].reduced()
    assert frontend.uses_stub_frontend(cfg) and frontend.embed_input_shape(cfg, 2, 5) == (2, 5, cfg.d_model)
    assert frontend.embed_input_shape(cfg, 2, 5) == jfe.embed_input_shape(JARCHS[name].reduced(), 2, 5)
    assert not frontend.uses_stub_frontend(ARCHS["starcoder2-7b"])


@pytest.mark.parametrize("name", NAMES)
def test_synth_embeddings_match_jax(name):
    jcfg, cfg = JARCHS[name].reduced(), ARCHS[name].reduced()
    key = jax.random.PRNGKey(3)
    want = jfe.synth_embeddings(jcfg, key, 2, 7)
    draw = np.array(jax.random.normal(key, (2, 7, cfg.d_model), jnp.float32))
    _close(frontend.synth_embeddings(cfg, 3, 2, 7, "cpu", x=draw), want)


@pytest.mark.parametrize("name", NAMES)
def test_synth_frames_from_audio_match_jax(name):
    jcfg, cfg = JARCHS[name].reduced(), ARCHS[name].reduced()
    audio = np.random.default_rng(0).standard_normal((2, 1000)).astype(np.float32)
    want = jfe.synth_frames_from_audio(jcfg, jnp.asarray(audio), frame=64)
    proj = np.array(jax.random.normal(jax.random.PRNGKey(0), (64, cfg.d_model), jnp.float32))
    got = frontend.synth_frames_from_audio(cfg, torch.from_numpy(audio), frame=64, proj=proj)
    assert got.shape == (2, 1000 // 64, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_synth_patches_from_image_match_jax(name):
    jcfg, cfg = JARCHS[name].reduced(), ARCHS[name].reduced()
    images = np.random.default_rng(1).standard_normal((2, 20, 36, 3)).astype(np.float32)
    want = jfe.synth_patches_from_image(jcfg, jnp.asarray(images), patch=8)
    proj = np.array(jax.random.normal(jax.random.PRNGKey(1), (8 * 8 * 3, cfg.d_model), jnp.float32))
    got = frontend.synth_patches_from_image(cfg, torch.from_numpy(images), patch=8, proj=proj)
    assert got.shape == (2, (20 // 8) * (36 // 8), cfg.d_model)
    _close(got, want)


def test_stub_token_table_matches_jax_engine_draw():
    cfg = ARCHS["musicgen-large"].reduced()
    draw = np.array(jax.random.normal(jax.random.PRNGKey(7), (cfg.vocab, cfg.d_model)))
    want = jax.random.normal(jax.random.PRNGKey(7), (cfg.vocab, cfg.d_model)) / jnp.sqrt(float(cfg.d_model))
    _close(frontend.stub_token_table(cfg, "cpu", draw), want)


def test_seeded_draws_are_deterministic_standard_normals():
    cfg = ARCHS["pixtral-12b"].reduced()
    a = frontend.synth_embeddings(cfg, 0, 4, 64, "cpu")
    assert torch.equal(a, frontend.synth_embeddings(cfg, 0, 4, 64, "cpu"))
    assert not torch.equal(a, frontend.synth_embeddings(cfg, 1, 4, 64, "cpu"))
    assert a.dtype == cfg.compute_dtype and float((a * cfg.d_model ** 0.5).std()) == pytest.approx(1.0, rel=0.1)
    t = frontend.stub_token_table(cfg, "cpu")
    assert torch.equal(t, frontend.stub_token_table(cfg, "cpu")) and t.shape == (cfg.vocab, cfg.d_model)
    assert float((t * cfg.d_model ** 0.5).std()) == pytest.approx(1.0, rel=0.1)
