"""The port's chunked recurrences on the CPU: ``ssd_chunked`` (Mamba2) and
``wkv6_chunked`` (RWKV6) against the JAX package's at chunks 4, 8 and 16,
and against a naive per-token recurrence (the port's copies of
tests/test_models.py's oracles), on the same numpy inputs; the state carry
(two halves with the first half's state passed on equal one whole run); and
``wkv6_chunked`` with its pairwise products in bf16 against the JAX
package's.

Tolerances: 1e-5 against the JAX functions and the oracles (float32 in
both, the sums in another order); 2e-2 for the bf16 mix (rounded inputs to
the pairwise products, summed in float32 in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv import wkv6_chunked as jwkv6
from repro.models.ssm import ssd_chunked as jssd
from repro_torch.models.rwkv import wkv6_chunked
from repro_torch.models.ssm import ssd_chunked

TOL = 1e-5
BF16_TOL = 2e-2


def rand(seed, *shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def softplus(x):
    return np.log1p(np.exp(x)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# --------------------------------------------------------------------------
# oracles: one token at a time, in float64
# --------------------------------------------------------------------------
def wkv6_naive(r, k, v, log_w, u, s0=None):
    r, k, v, log_w, u = (a.astype(np.float64) for a in (r, k, v, log_w, u))
    B, S, H, K = r.shape
    s = np.zeros((B, H, K, K)) if s0 is None else s0.astype(np.float64)
    ys = []
    for t in range(S):
        kv = np.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(np.einsum("bhk,bhkv->bhv", r[:, t], s + u[None, :, :, None] * kv))
        s = np.exp(log_w[:, t])[..., None] * s + kv
    return np.stack(ys, 1), s


def ssd_naive(xs, dt, A, bs, cs, s0=None):
    xs, dt, A, bs, cs = (a.astype(np.float64) for a in (xs, dt, A, bs, cs))
    B, S, H, P = xs.shape
    G, N = bs.shape[2], bs.shape[3]
    hg = H // G
    s = np.zeros((B, H, N, P)) if s0 is None else s0.astype(np.float64)
    ys = []
    for t in range(S):
        a_t = np.exp(dt[:, t] * A[None])  # (B, H)
        b_t = np.repeat(bs[:, t], hg, axis=1)  # (B, H, N)
        c_t = np.repeat(cs[:, t], hg, axis=1)
        s = a_t[..., None, None] * s + np.einsum("bhn,bhp->bhnp", b_t, xs[:, t] * dt[:, t][..., None])
        ys.append(np.einsum("bhn,bhnp->bhp", c_t, s))
    return np.stack(ys, 1), s


def wkv_inputs(seed, B=2, S=16, H=2, K=8):
    r, k, v = rand(seed, B, S, H, K), rand(seed + 1, B, S, H, K), rand(seed + 2, B, S, H, K)
    log_w = -np.exp(rand(seed + 3, B, S, H, K) * 0.5)
    return r, k, v, log_w, rand(seed + 4, H, K)


def ssd_inputs(seed, B=2, S=16, H=4, P=8, G=1, N=4):
    xs = rand(seed, B, S, H, P)
    dt = softplus(rand(seed + 1, B, S, H))
    A = -np.exp(rand(seed + 2, H) * 0.3)
    return xs, dt, A, rand(seed + 3, B, S, G, N), rand(seed + 4, B, S, G, N)


# --------------------------------------------------------------------------
# wkv6
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_wkv6_chunked_matches_jax_and_naive(chunk):
    inp = wkv_inputs(0)
    y, s = wkv6_chunked(*_t(*inp), chunk)
    jy, js = jwkv6(*_j(*inp), chunk)
    _close(y, jy)
    _close(s, js)
    y0, s0 = wkv6_naive(*inp)
    _close(y, y0)
    _close(s, s0)


def test_wkv6_chunk_that_does_not_divide():
    """S = 12 with chunk 8 runs chunks of 6 (the largest divisor of S not
    above the request), as the JAX package does."""
    inp = wkv_inputs(20, S=12)
    y, s = wkv6_chunked(*_t(*inp), 8)
    jy, js = jwkv6(*_j(*inp), 8)
    _close(y, jy)
    _close(s, js)


def test_wkv6_state_carry():
    """Processing [first half; second half with the carried state] == full."""
    r, k, v, log_w, u = _t(*wkv_inputs(5, B=1))
    y_full, s_full = wkv6_chunked(r, k, v, log_w, u, 4)
    y1, s1 = wkv6_chunked(r[:, :8], k[:, :8], v[:, :8], log_w[:, :8], u, 4)
    y2, s2 = wkv6_chunked(r[:, 8:], k[:, 8:], v[:, 8:], log_w[:, 8:], u, 4, s0=s1)
    _close(torch.cat([y1, y2], 1), y_full)
    _close(s2, s_full)


def test_wkv6_bf16_mix_matches_jax():
    inp = wkv_inputs(10)
    s0 = rand(15, 2, 2, 8, 8)
    y, s = wkv6_chunked(*_t(*inp), 8, torch.from_numpy(s0), mix_dtype=torch.bfloat16)
    jy, js = jwkv6(*_j(*inp), 8, jnp.asarray(s0), mix_dtype=jnp.bfloat16)
    _close(y, jy, BF16_TOL)
    _close(s, js, BF16_TOL)


# --------------------------------------------------------------------------
# mamba2 SSD
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_jax_and_naive(chunk):
    inp = ssd_inputs(30)
    y, s = ssd_chunked(*_t(*inp), chunk)
    jy, js = jssd(*_j(*inp), chunk)
    _close(y, jy)
    _close(s, js)
    y0, s0 = ssd_naive(*inp)
    _close(y, y0)
    _close(s, s0)


def test_ssd_grouped_bc_and_odd_chunk():
    """Two B/C groups over four heads, S = 12 with chunk 8 (chunks of 6)."""
    inp = ssd_inputs(40, S=12, G=2)
    y, s = ssd_chunked(*_t(*inp), 8)
    jy, js = jssd(*_j(*inp), 8)
    _close(y, jy)
    _close(s, js)
    y0, s0 = ssd_naive(*inp)
    _close(y, y0)
    _close(s, s0)


def test_ssd_state_carry():
    xs, dt, A, bs, cs = _t(*ssd_inputs(15, B=1, H=2, P=4))
    y_full, s_full = ssd_chunked(xs, dt, A, bs, cs, 4)
    y1, s1 = ssd_chunked(xs[:, :8], dt[:, :8], A, bs[:, :8], cs[:, :8], 4)
    y2, s2 = ssd_chunked(xs[:, 8:], dt[:, 8:], A, bs[:, 8:], cs[:, 8:], 4, s0=s1)
    _close(torch.cat([y1, y2], 1), y_full)
    _close(s2, s_full)


# --------------------------------------------------------------------------
# the masked half of a chunk's decay exponents, past fp32's range
# --------------------------------------------------------------------------
def _grads_port(fn, inp, chunk, wrt):
    ts = _t(*inp)
    for i in wrt:
        ts[i].requires_grad_(True)
    y, s = fn(*ts, chunk)
    (y.sum() + s.sum()).backward()
    return y.detach(), [ts[i].grad for i in wrt]


def _grads_jax(fn, inp, chunk, wrt):
    import jax

    def f(*xs):
        args = list(_j(*inp))
        for i, x in zip(wrt, xs):
            args[i] = x
        y, s = fn(*args, chunk)
        return y.sum() + s.sum()

    return jax.grad(f, argnums=tuple(range(len(wrt))))(*(jnp.asarray(inp[i]) for i in wrt))


@pytest.mark.parametrize("kind", ["ssd", "wkv6"])
def test_gradients_stay_finite_where_the_masked_decay_overflows(kind):
    """zamba2's chunk of 128 (and a steep RWKV6 decay at 16) puts the
    masked half's exponents past fp32's range: the reference's
    ``where(tri, exp(.), 0)`` then gives the decay a NaN gradient (a zero
    cotangent times inf; a reference caveat in ROADMAP), the port, which
    masks the exponent before ``exp``, a finite one.  Where both are
    finite they agree: the forward, the gradients that do not pass through
    the decay at the reference's chunk, and the decay's gradient at a
    chunk short enough for the reference (8) at ``TOL``."""
    if kind == "ssd":
        inp = list(ssd_inputs(50, B=1, S=256, H=2, P=4))
        inp[1] = (np.abs(inp[1]) + 0.7).astype(np.float32)  # dt: 128 steps reach exp's range
        fn, jfn, chunk, short, wrt = ssd_chunked, jssd, 128, 8, (0, 1)  # xs, dt
    else:
        inp = list(wkv_inputs(60, B=1, S=32))
        inp[3] = (inp[3] * 8).astype(np.float32)  # log_w: 16 steps reach exp's range
        fn, jfn, chunk, short, wrt = wkv6_chunked, jwkv6, 16, 4, (2, 3)  # v, log_w
    y, (g_free, g_decay) = _grads_port(fn, inp, chunk, wrt)
    j_free, j_decay = _grads_jax(jfn, inp, chunk, wrt)
    assert not np.isfinite(np.asarray(j_decay)).all()  # the reference's NaN
    assert torch.isfinite(g_decay).all() and torch.isfinite(g_free).all()
    _close(y, jfn(*_j(*inp), chunk)[0])
    _close(g_free, j_free)
    _, j_short = _grads_jax(jfn, inp, short, wrt)
    assert np.isfinite(np.asarray(j_short)).all()
    _close(g_decay, j_short)
