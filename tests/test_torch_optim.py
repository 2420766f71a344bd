"""The port's AdamW and learning-rate schedules against the JAX package's
on the same numpy trees (CPU).

Tolerance: every leaf of the parameters and moments after each of 3 steps,
and the metrics, within 1e-6 relative to the leaf's largest magnitude (both
run the same fp32 arithmetic in the same order; the global norm sums its
leaves in another order, and ``b ** count`` comes from two pow
implementations, each a few ulps).  bf16 moments are compared after the
port's rounding, within one bf16 ulp of the leaf's scale where an fp32
ulp of difference before the rounding flips it.  Schedules: steps 0..N
within 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim

REL = 1e-6


def _tree(rng, scale):
    shapes = {"w": (8, 6), "b": (6,), "blocks": [{"k": (4, 3, 2)}, {"k": (4, 3, 2)}], "s": ()}

    def draw(s):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return {k: ([{"k": draw(x["k"])} for x in v] if isinstance(v, list) else draw(v)) for k, v in shapes.items()}


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, rel, label):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, f"{label}: {np.abs(got - want).max() / scale:.3g} > {rel}"


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy() if torch.is_tensor(t) else np.asarray(t), tree))


LRS = {
    "constant": (3e-3, 3e-3),
    "warmup_cosine": (joptim.warmup_cosine(1e-2, warmup=2, total=5), optim.warmup_cosine(1e-2, warmup=2, total=5)),
    "wsd": (joptim.wsd(1e-2, warmup=1, total=4, decay_frac=0.5), optim.wsd(1e-2, warmup=1, total=4, decay_frac=0.5)),
}
# clip: off (0), on but not active (norm well below 1), active (norm above 1)
CLIPS = {"off": (0.0, 1.0), "inactive": (1.0, 0.01), "active": (1.0, 3.0)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("lr", sorted(LRS))
def test_adamw_matches_jax(state_dtype, clip, lr):
    clip_norm, gscale = CLIPS[clip]
    jlr, tlr = LRS[lr]
    jcfg = joptim.AdamWConfig(lr=jlr, clip_norm=clip_norm, state_dtype=getattr(jnp, state_dtype))
    tcfg = optim.AdamWConfig(lr=tlr, clip_norm=clip_norm, state_dtype=getattr(torch, state_dtype))
    rng = np.random.default_rng(7)
    params = _tree(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _torch(params)
    jo, to = joptim.init(jp, jcfg), optim.init(tp, tcfg)
    assert to["m"]["w"].dtype == getattr(torch, state_dtype) and to["count"].dtype == torch.int32
    tol = REL if state_dtype == "float32" else 2.0 ** -8
    for step in range(3):
        grads = _tree(rng, gscale)
        jp, jo, jm = joptim.update(jax.tree.map(jnp.asarray, grads), jo, jp, jcfg)
        tp2, to2, tm = optim.update(_torch(grads), to, tp, tcfg)
        assert tp2 is tp and to2 is to  # updated in place, the trees returned
        for a, b in zip(_leaves(tp), _leaves(jp)):
            _close(a, b, REL, f"params step {step}")
        for name in ("m", "v"):
            for a, b in zip(_leaves(to[name]), _leaves(jo[name])):
                _close(a, b, tol, f"{name} step {step}")
        assert int(to["count"]) == int(jo["count"]) == step + 1
        for k in ("grad_norm", "lr"):
            _close(tm[k].numpy(), np.asarray(jm[k]), REL, k)
    if clip == "active":
        assert float(tm["grad_norm"]) > 1.0


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(3), 2.0)
    _close(optim.global_norm(_torch(tree)).numpy(), np.asarray(joptim.global_norm(jax.tree.map(jnp.asarray, tree))),
           REL, "global_norm")


@pytest.mark.parametrize("name,jfn,tfn", [
    ("warmup_cosine", joptim.warmup_cosine(3e-4, warmup=5, total=30), optim.warmup_cosine(3e-4, warmup=5, total=30)),
    ("warmup_cosine_floor", joptim.warmup_cosine(1.0, warmup=0, total=10, floor=0.0),
     optim.warmup_cosine(1.0, warmup=0, total=10, floor=0.0)),
    ("wsd", joptim.wsd(3e-4, warmup=5, total=30), optim.wsd(3e-4, warmup=5, total=30)),
    ("wsd_half", joptim.wsd(2.0, warmup=2, total=12, decay_frac=0.5), optim.wsd(2.0, warmup=2, total=12, decay_frac=0.5)),
])
def test_schedules_match_jax(name, jfn, tfn):
    for s in range(0, 36):
        want = np.asarray(jfn(jnp.asarray(s, jnp.int32)))
        got = tfn(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=REL * 1e-3, err_msg=f"{name} step {s}")


def test_update_waits_on_nothing():
    """No host synchronization in ``update`` or a schedule: every scalar
    stays a tensor (a captured step could not hold them otherwise)."""
    cfg = optim.AdamWConfig(lr=optim.warmup_cosine(1e-3, 2, 10))
    p = {"w": torch.ones(4, 4)}
    o = optim.init(p, cfg)
    _, _, m = optim.update({"w": torch.full((4, 4), 2.0)}, o, p, cfg)
    assert all(torch.is_tensor(v) for v in m.values())
    assert o["count"].dtype == torch.int32 and int(o["count"]) == 1
