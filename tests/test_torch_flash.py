"""The port's flash attention and tiled matmul on the CPU: the wrappers'
plain PyTorch versions and the torch oracles against the JAX package's
Pallas kernels (interpret mode) and oracles on the same numpy inputs, with
tests/test_kernels.py's tolerances: flash 2e-5 in float32 and 2e-2 in
bfloat16, matmul 1e-4.  The CUDA kernels themselves run only on the card:
chip_smoke.py holds them against these plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import _sdpa as jsdpa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tile_linalg as tl
from repro_torch.models.attention import _sdpa as tsdpa

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.3


def _both(x, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _qkv(B, Hq, Hkv, S, D, dtype, seed=10):
    return [_both(_rand(seed + i, B, h, S, D), dtype) for i, h in enumerate((Hq, Hkv, Hkv))]


# test_flash_attention's grid, then a GQA group of 3, of 9 (the full-width
# starcoder2-7b group, 36 / 4) and a ragged tile (S = 12: one 12-row block)
SHAPES = [
    (1, 2, 2, 32, 8),
    (2, 4, 2, 64, 16),
    (1, 8, 1, 32, 32),  # MQA
    (1, 6, 2, 32, 16),  # group 3
    (1, 9, 1, 16, 8),  # group 9
    (2, 4, 2, 12, 16),  # ragged
]


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_matches_pallas_and_oracle(dtype, B, Hq, Hkv, S, D, window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, Hq, Hkv, S, D, dtype)
    blk = min(16, S)
    before = dict(fa.LAUNCHES)
    got = tops.flash_attention(tq, tk, tv, causal=True, window=window, block_q=blk, block_k=blk)
    assert fa.LAUNCHES == before  # the CPU runs the plain version, no launch
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jops.flash_attention(jq, jk, jv, causal=True, window=window, block_q=blk, block_k=blk,
                                  interpret=True)
    tol = DTYPES[dtype][2]
    _close(got.float(), pallas.astype(jnp.float32), tol)
    _close(got.float(), jref.flash_attention(jq, jk, jv, causal=True, window=window).astype(jnp.float32), tol)
    _close(tref.flash_attention(tq, tk, tv, causal=True, window=window).float(),
           jref.flash_attention(jq, jk, jv, causal=True, window=window).astype(jnp.float32), tol)


@pytest.mark.parametrize("causal,window", [(False, 0), (False, 8), (True, 0)])
def test_flash_scale_and_mask_options(causal, window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 4, 2, 32, 16, "float32", seed=20)
    got = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window, scale=0.3)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window, scale=0.3, block_q=16,
                                block_k=16, interpret=True)
    _close(got, want, 2e-5)


def test_flash_on_transposed_model_layout():
    """The model hands the kernel (B, S, H, D) activations transposed to
    (B, H, S, D); the result equals the model's own _sdpa in both packages
    (test_flash_attention_matches_model_sdpa's shapes)."""
    B, H, S, D = 2, 4, 32, 16
    q, k, v = (_rand(13 + i, B, S, H, D) for i in range(3))
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    want = jsdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.asarray(pos), None, 0)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), causal=True,
                               block_q=16, block_k=16).transpose(1, 2)
    _close(got, want, 2e-5)
    tpos = torch.from_numpy(np.ascontiguousarray(pos))
    _close(tsdpa(tq, tk, tv, tpos, tpos, None, 0), want, 2e-5)


def test_flash_keeps_the_jax_contract():
    q = torch.zeros(1, 4, 160, 8)
    kv = torch.zeros(1, 2, 160, 8)
    with pytest.raises(ValueError, match="multiple of the blocks"):
        tops.flash_attention(q, kv, kv)  # above 128, S must be a multiple of 128
    q3 = torch.zeros(1, 3, 32, 8)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        tops.flash_attention(q3, torch.zeros(1, 2, 32, 8), torch.zeros(1, 2, 32, 8))
    big = torch.zeros(1, 1, 16, 512)
    with pytest.raises(ValueError, match="head dimension"):
        tops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tops.flash_attention(q3[:, :2].half(), q3[:, :2].half(), q3[:, :2].half())


@pytest.mark.parametrize("m,k,n,bm,bk,bn", [
    (32, 32, 32, 16, 16, 16),
    (64, 128, 32, 32, 64, 16),
    (128, 64, 128, 128, 64, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas(dtype, m, k, n, bm, bk, bn):
    (ja, ta), (jb, tb) = _both(_rand(8, m, k), dtype), _both(_rand(9, k, n), dtype)
    before = dict(tl.MATMUL_LAUNCHES)
    got = tops.matmul(ta, tb, bm=bm, bn=bn, bk=bk)
    assert tl.MATMUL_LAUNCHES == before
    assert got.dtype == ta.dtype and got.shape == (m, n)
    want = jops.matmul(ja, jb, bm=bm, bn=bn, bk=bk, interpret=True)
    # float32: the reference test's 1e-4; bfloat16: both round the same
    # float32 sum to bfloat16, so one bf16 ulp of the result (2 ** -8)
    tol = 1e-4 if dtype == "float32" else 2 ** -8
    _close(got.float(), want.astype(jnp.float32), tol)
    _close(tref.matmul(ta, tb).float(), jref.matmul(ja, jb).astype(jnp.float32), tol)


def test_matmul_keeps_the_jax_contract():
    with pytest.raises(ValueError, match="not divisible"):
        tops.matmul(torch.zeros(48, 32), torch.zeros(32, 32), bm=32)
    with pytest.raises(ValueError, match=r"\(m, k\) @ \(k, n\)"):
        tops.matmul(torch.zeros(8, 4), torch.zeros(8, 4))


def test_sources_declare_their_entry_points():
    """Each CUDA source exports the C entries the wrappers bind."""
    src = (tl._build.CSRC / "flash_attention.cu").read_text()
    assert 'extern "C" int flash_attention_f32' in src and 'extern "C" int flash_attention_bf16' in src
    assert "expf(" in src and "__expf(" not in src  # the 2e-5 float32 tolerance
    src = (tl._build.CSRC / "matmul.cu").read_text()
    for route in (tl.WGMMA, tl.TF32X3, tl.SIMPLE):  # one C entry a route of matmul_route
        assert f'extern "C" int matmul_{route}(' in src, route
    # bf16 on wgmma fed by TMA, fp32 in 3xTF32 on mma.sync, each with its bound noted
    for word in ("wgmma.mma_async", "cp.async.bulk.tensor", "mma.sync.aligned.m16n8k8", "0x1000u) & 0xffffe000u",
                 "__fadd_rn", "bound", "_matmul_kernel"):
        assert word in src, word
