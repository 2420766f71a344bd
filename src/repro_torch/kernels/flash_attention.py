"""Causal GQA flash attention: a hand-written CUDA kernel
(``csrc/flash_attention.cu``, replacing the JAX package's Pallas TPU
kernel ``kernels/flash_attention.py``) and its plain PyTorch version.

``flash_attention`` keeps the JAX signature and contract: ``(B, Hq, S, D)``
queries, ``(B, Hkv, S, D)`` keys and values, ``Hq % Hkv == 0``, and ``S``
a multiple of ``min(block_q, S)`` and ``min(block_k, S)``.  The blocks are
the TPU's tiling and only feed that check: the CUDA kernel picks its own
tile and masks a ragged last one.  Inputs may be any strided view with the
head dimension contiguous (the model passes transposed ``(B, S, H, D)``
activations); the output is allocated in q's memory layout, so the model's
transpose back is contiguous.  float32 and bfloat16.

The wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device; there is no fallback between the two.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _build
from .ref import fp32_matmul

MAX_HEAD_DIM = 256  # largest head dimension the kernel accepts (csrc kMaxD)

LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


@fp32_matmul()
def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """What the kernel computes, on whole (S, S) score matrices: q upcast
    to float32 then scaled, -inf masks, softmax with a fully masked row
    giving 0, output in q's dtype.  GQA by reshaping the query heads into
    (Hkv, group) instead of repeating K and V."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qf = q.float().reshape(B, Hkv, g, S, D) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isneginf(m), 0.0, m))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / torch.where(l == 0.0, 1.0, l)
    return o.reshape(B, Hq, S, D).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int, block_k: int) -> None:
    """The JAX kernel's contract, on both devices; raises ``ValueError``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, H, S, D) with k and v alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if Hq % Hkv != 0:
        raise ValueError(f"query heads {Hq} not a multiple of KV heads {Hkv}")
    bq, bk = min(block_q, S), min(block_k, S)
    if S % bq != 0 or S % bk != 0:
        raise ValueError(f"sequence length {S} not a multiple of the blocks ({bq}, {bk})")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dimension {D} outside the kernel's limit 1..{MAX_HEAD_DIM}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")


_FNS: Dict[torch.dtype, object] = {}


def _kernel_fn(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        lib = _build.load("flash_attention")
        for dt, sym in ((torch.float32, "flash_attention_f32"), (torch.bfloat16, "flash_attention_bf16")):
            f = getattr(lib, sym)
            f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            f.restype = ctypes.c_int
            _FNS[dt] = f
        fn = _FNS[dtype]
    return fn


def flash_attention(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Causal (and sliding-window, ``window`` > 0) GQA attention; CUDA
    kernel on the card, plain version on the CPU."""
    _check(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"q, k, v must lie on one CUDA device, got {q.device}, {k.device}, {v.device}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    B, Hq, S, D = q.shape
    o = torch.empty_like(q)  # q's memory layout (D contiguous): a transposed view gives one too
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, o) for s in x.stride()[:3]))
    scale = (D ** -0.5) if scale is None else scale
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel_fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
                                  k.shape[1], S, D, strides, scale, int(causal), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return o
