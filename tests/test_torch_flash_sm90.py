"""The Hopper flash-attention route on the CPU: which kernel a call on the
card takes (a pure function of dtype and head dimension), how its operands
are prepared for TMA, and a plain emulation of its arithmetic held against
the JAX package's reference.  The kernel itself runs only on the card:
chip_smoke.py holds it against the plain version there.

The emulation repeats what ``csrc/flash_attention_sm90.cu`` computes and
the Pallas kernel does not: the scale on the fp32 scores (not on q),
``exp2`` with log2(e) folded into that scale, key tiles of the kernel's
width (128 for D <= 128, else 64), and the probabilities rounded to bf16
before P V while their sum stays fp32.  It must agree with
``repro.kernels.ref.flash_attention`` at the bf16 tolerance of
tests/test_kernels.py, 2e-2."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops

TOL = 2e-2  # tests/test_kernels.py::test_flash_attention, bfloat16


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.3


def _bf16(x):
    """The same bf16 values for both packages."""
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,head_dim,route", [
    *[(torch.bfloat16, d, fa.SM90) for d in (64, 80, 128, 192, 256)],
    *[(torch.bfloat16, d, fa.SIMPLE) for d in (8, 16, 32, 48, 72, 130)],
    *[(torch.float32, d, fa.SIMPLE) for d in (8, 16, 32, 64, 128, 192, 256)],
])
def test_route_is_a_function_of_dtype_and_head_dim(dtype, head_dim, route):
    assert fa.flash_route(dtype, head_dim) == route


def test_float16_still_raises():
    q = torch.zeros(1, 2, 16, 64, dtype=torch.float16)
    assert fa.flash_route(torch.float16, 64) == fa.SIMPLE
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tops.flash_attention(q, q, q)


def test_misaligned_view_is_copied_and_keeps_the_route():
    """A bf16 view starting one element into its storage cannot be read by
    TMA (a 2-byte aligned base): it is made contiguous, stays on the sm90
    route, and gives what the plain version gives on the view."""
    B, Hq, Hkv, S, D = 1, 4, 2, 32, 64
    flat = [torch.from_numpy(_rand(40 + i, B * h * S * D + 1)).to(torch.bfloat16) for i, h in enumerate((Hq, Hkv, Hkv))]
    q, k, v = (x[1:].view(B, h, S, D) for x, h in zip(flat, (Hq, Hkv, Hkv)))
    assert q.data_ptr() % 16 != 0 and not fa._tma_ready(q)
    assert fa.flash_route(q.dtype, D) == fa.SM90
    cq, ck, cv, o = fa._operands(fa.SM90, q, k, v)
    for x, c in zip((q, k, v), (cq, ck, cv)):
        assert fa._tma_ready(c) and c.is_contiguous() and torch.equal(x, c)
    assert fa._tma_ready(o) and o.shape == q.shape and o.dtype == q.dtype
    got = tops.flash_attention(q, k, v, causal=True, block_q=16, block_k=16)
    assert torch.equal(got, fa.flash_attention_plain(cq, ck, cv, causal=True))
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    _close(got.float(), jref.flash_attention(jq, jk, jv, causal=True).astype(jnp.float32))


def test_aligned_views_pass_without_a_copy():
    """The model's transposed (B, S, H, D) activations are read in place and
    the output keeps their layout; a size-1 dimension's stride is free."""
    B, S, D = 1, 16, 128
    q, k, v = (torch.zeros(B, S, h, D, dtype=torch.bfloat16).transpose(1, 2) for h in (36, 4, 4))
    ops = fa._operands(fa.SM90, q, k, v)
    assert all(x.data_ptr() == y.data_ptr() for x, y in zip((q, k, v), ops[:3]))
    assert ops[3].stride() == q.stride()
    assert fa._strides(ops[3]) == [D, D, 36 * D]  # (b: size 1, so D; h; s)
    odd = torch.zeros(1, 2, 16, 68, dtype=torch.bfloat16)[..., :64]  # rows 136 bytes apart
    assert not fa._tma_ready(odd) and fa._tma_ready(fa._operands(fa.SM90, odd, odd, odd)[0])


def emulate_sm90(q, k, v, *, causal=True, window=0, scale=None):
    """The kernel's arithmetic in float32 on (B, H, S, D) bf16 tensors, key
    tile by key tile (a query row's result does not depend on its tile)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    bk = 128 if D <= 128 else 64
    scale = D ** -0.5 if scale is None else scale
    sl = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    qf = q.float().reshape(B, Hkv, g, S, D)
    kf, vf = k.float(), v.float()
    m = torch.full((B, Hkv, g, S), float("-inf"))
    l = torch.zeros(B, Hkv, g, S)
    acc = torch.zeros(B, Hkv, g, S, D)
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * sl
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones(S, kt.shape[2], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = s.masked_fill(~ok, float("-inf"))
        m_cur = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_cur), 0.0, m_cur)
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp2(m - m_safe))
        p = torch.exp2(s - m_safe[..., None])
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p.to(torch.bfloat16).float(), vt)
        m = m_cur
    inv = torch.where(l == 0.0, 0.0, 1.0 / torch.where(l == 0.0, 1.0, l))
    return (acc * inv[..., None]).reshape(B, Hq, S, D).to(torch.bfloat16)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,causal", [
    (1, 9, 1, 256, 128, 0, True),  # GQA 9 (starcoder2-7b's 36 / 4) at its head dim
    (1, 4, 2, 256, 256, 0, True),  # gemma3's head dim, global
    (1, 4, 2, 256, 256, 16, True),  # and local: rows past 79 see no key in the first tile (m = -inf there)
    (1, 9, 1, 300, 128, 0, True),  # ragged S: a 44-key last tile, a 44-row last query tile
    (1, 4, 2, 200, 192, 0, True),  # nemotron's head dim, ragged at Bk = 64
    (2, 4, 2, 128, 64, 0, False),  # no causal mask
])
def test_emulation_matches_the_jax_reference(B, Hq, Hkv, S, D, window, causal):
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(_rand(50 + i, B, h, S, D)) for i, h in enumerate((Hq, Hkv, Hkv)))
    got = emulate_sm90(tq, tk, tv, causal=causal, window=window)
    want = jref.flash_attention(jq, jk, jv, causal=causal, window=window).astype(jnp.float32)
    _close(got.float(), want)


def test_emulation_matches_pallas_with_a_scale():
    """A caller's scale multiplies the scores (the Pallas kernel scales q)."""
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(_rand(60 + i, 1, h, 128, 128)) for i, h in enumerate((4, 2, 2)))
    got = emulate_sm90(tq, tk, tv, causal=True, scale=0.3)
    want = jops.flash_attention(jq, jk, jv, causal=True, scale=0.3, block_q=64, block_k=64, interpret=True)
    _close(got.float(), want.astype(jnp.float32))


def test_source_declares_its_entry_point_and_hopper_building_blocks():
    src = (_build.CSRC / "flash_attention_sm90.cu").read_text()
    assert 'extern "C" int flash_attention_sm90_bf16' in src
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor.4d", "mbarrier.try_wait.parity",
                   "mbarrier.arrive.expect_tx", "setmaxnreg.dec", "setmaxnreg.inc", "__grid_constant__",
                   "CU_TENSOR_MAP_SWIZZLE_128B", "src/repro/kernels/flash_attention.py"):
        assert needle in src, needle
    # the simple kernel's source is untouched by the new route
    assert 'extern "C" int flash_attention_bf16' in (_build.CSRC / "flash_attention.cu").read_text()
