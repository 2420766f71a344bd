"""The port's sharding resolver against the JAX package's, on mock meshes.

Every parameter leaf of all ten shipped configurations at their published
widths (templates only: nothing is allocated), every cache leaf, the
batch's sharding and the data-parallel degree, on mock meshes (1, 1),
(4, 1), (2, 2), (16, 16) and (2, 16, 16), under both rule tables: the specs
are equal.  The port holds one group a leaf where the reference stacks the
groups on a leading ``"layers"`` dim, so a group leaf's spec is held
against the stacked leaf's without its first entry.  The last tests mirror
the reference's resolver cases (``tests/test_launch.py``) and the spec's
DTensor placements.
"""

import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.launch import sharding as jsh
from repro.models import build_model as jbuild
from repro.models.transformer import cache_logical as jcache_logical
from repro.models.transformer import cache_specs as jcache_specs
from repro_torch.configs import ARCHS
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as st
from repro_torch.models.transformer import cache_logical

import jax


class FakeMesh:
    def __init__(self, shape):
        self.axis_names = ("pod", "data", "model")[-len(shape):]
        self.shape = dict(zip(self.axis_names, shape))


MESHES = [(1, 1), (4, 1), (2, 2), (16, 16), (2, 16, 16)]
RULES = {"train": (sh.train_rules, jsh.train_rules), "serve": (sh.serve_rules, jsh.serve_rules)}


def _jflat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jflat(v, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, (jax.sharding.PartitionSpec, sh.PartitionSpec)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_jflat(v, f"{prefix}.{i}"))
        return out
    return {prefix: tree}


def _jspecs(jcfg, mesh, rules):
    model = jbuild(jcfg)
    specs = jsh.tree_pspecs(model.logical, model.abstract(), mesh, rules)
    return _jflat(specs)


@pytest.mark.parametrize("kind", sorted(RULES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch, kind):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    port_rules, ref_rules = RULES[kind]
    for shape in MESHES:
        mesh = FakeMesh(shape)
        want = _jspecs(jcfg, mesh, ref_rules(jcfg))
        got = st.param_shardings(cfg, mesh, port_rules(cfg))
        n_split = 0
        for name, s in got.items():
            if name.startswith("stack.groups."):
                _, _, g, rest = name.split(".", 3)
                ref = tuple(want[f"stack.groups.{rest}"])
                assert ref[0] is None, name
                ref = ref[1:]
            else:
                ref = tuple(want[name])
            assert tuple(s.spec) == ref, (arch, kind, shape, name)
            n_split += any(e is not None for e in s.spec)
        assert len({n for n in got if not n.startswith("stack.groups.")}) + len(
            {n.split(".", 3)[3] for n in got if n.startswith("stack.groups.")}) == len(want)
        if shape != (1, 1):
            assert n_split > 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_the_reference(arch):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    for shape in MESHES:
        mesh = FakeMesh(shape)
        for batch in (32, 1):
            want = _jflat(jsh.tree_pspecs(jcache_logical(jcfg), jcache_specs(jcfg, batch, 4096), mesh,
                                          jsh.serve_rules(jcfg)))
            got = _jflat(sh.tree_pspecs(cache_logical(cfg), st.cache_specs(cfg, batch, 4096), mesh,
                                        sh.serve_rules(cfg)))
            assert set(got) == set(want)
            for k in want:
                assert tuple(got[k]) == tuple(want[k]), (arch, shape, batch, k)


@pytest.mark.parametrize("shape", MESHES)
def test_batch_sharding_and_degree_equal_the_reference(shape):
    mesh = FakeMesh(shape)
    for arch in ("qwen3-32b", "nemotron-4-340b"):
        cfg, jcfg = ARCHS[arch], JARCHS[arch]
        for kind in RULES:
            rules, jrules = RULES[kind][0](cfg), RULES[kind][1](jcfg)
            for batch in (1, 2, 4, 16, 32, 256, 512):
                for ndim in (2, 3):
                    want = jsh.batch_pspec(mesh, jrules, ndim)
                    assert tuple(sh.batch_pspec(mesh, rules, ndim)) == tuple(want)
                assert sh.data_parallel_degree(mesh, rules, batch) == jsh.data_parallel_degree(mesh, jrules, batch)
                # the reference's batch_sharding needs a jax Mesh; its rule, as it reads
                axes = tuple(a for a in jrules.lookup("batch") if a in mesh.axis_names)
                while axes and batch % int(np.prod([mesh.shape[a] for a in axes])) != 0:
                    axes = axes[:-1]
                lead = axes if len(axes) > 1 else (axes[0] if axes else None)
                assert tuple(sh.batch_sharding(mesh, rules, batch, 2).spec) == (lead, None)


def test_param_bytes_estimate_equals_the_reference():
    for arch in ARCHS:
        assert sh.param_bytes_estimate(ARCHS[arch]) == jsh.param_bytes_estimate(JARCHS[arch])


# --------------------------------------------------------------------------
# the reference's resolver cases (tests/test_launch.py), mirrored
# --------------------------------------------------------------------------
def test_resolver_divisibility_fallback():
    mesh = FakeMesh((1, 1))
    rules = sh.Rules(table={"heads": ("model",), "embed": ("data",), None: ()})
    assert sh.resolve_pspec(("embed", "heads", None), (64, 8, 16), mesh, rules) == sh.P("data", "model", None)


def test_resolver_nondivisible_replicates():
    mesh = FakeMesh((16, 16))
    rules = sh.Rules(table={"kv_heads": ("model",), "embed": ("data",), None: ()})
    assert sh.resolve_pspec(("embed", "kv_heads"), (64, 8), mesh, rules) == sh.P("data", None)
    assert sh.resolve_pspec(("embed", "kv_heads"), (60, 32), mesh, rules) == sh.P(None, "model")


def test_resolver_multi_axis_dim():
    mesh = FakeMesh((2, 16, 16))
    rules = sh.Rules(table={"embed": ("pod", "data"), None: ()})
    assert sh.resolve_pspec(("embed", None), (18432, 8), mesh, rules) == sh.P(("pod", "data"), None)


def test_resolver_axis_used_once_per_leaf():
    mesh = FakeMesh((4, 4))
    rules = sh.Rules(table={"batch": ("data", "model"), "seq": ("data", "model"), None: ()})
    assert sh.resolve_pspec(("batch", "seq"), (16, 64), mesh, rules) == sh.P(("data", "model"), None)


def test_vector_params_replicated():
    rules = sh.train_rules(ARCHS["qwen3-32b"])
    assert sh.resolve_pspec(("embed",), (5120,), FakeMesh((1, 1)), rules) == sh.P()


def test_group_leaf_is_the_stacked_leaf_without_its_first_dim():
    """A group's 1-D norm scale is 2-D once stacked: sharded, not under
    ``min_ndim``."""
    rules = sh.train_rules(ARCHS["qwen3-32b"])
    mesh = FakeMesh((4, 1))
    assert sh.resolve_pspec(("embed",), (5120,), mesh, rules) == sh.P()
    assert sh.group_pspec(("embed",), (5120,), mesh, rules, 64) == sh.P("data")


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh3:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    m = Mesh3()
    assert sh.placements(m, sh.P(("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert sh.placements(m, sh.P(None, "data")) == (Replicate(), Shard(1), Replicate())
    assert sh.placements(m, sh.P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements(m, sh.P(("data", "pod")))
