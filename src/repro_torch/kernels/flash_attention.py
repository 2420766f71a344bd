"""Causal GQA flash attention: two hand-written CUDA kernels replacing the
JAX package's Pallas TPU kernel ``kernels/flash_attention.py``, and their
plain PyTorch version.

``flash_attention`` keeps the JAX signature and contract: ``(B, Hq, S, D)``
queries, ``(B, Hkv, S, D)`` keys and values, ``Hq % Hkv == 0``, and ``S``
a multiple of ``min(block_q, S)`` and ``min(block_k, S)``.  The blocks are
the TPU's tiling and only feed that check: each CUDA kernel picks its own
tiles and masks a ragged last one.  Inputs may be any strided view with the
head dimension contiguous (the model passes transposed ``(B, S, H, D)``
activations); the output is allocated in q's memory layout, so the model's
transpose back is contiguous.  float32 and bfloat16.

On the card, ``flash_route`` picks the kernel from the dtype and the head
dimension alone:

- ``"sm90"`` (``csrc/flash_attention_sm90.cu``): bfloat16 with D a multiple
  of 16 in 64..256, every configured model's head dimension.  TMA copies,
  ``wgmma`` products, a warp-specialised producer.  It reads through TMA
  tensor maps, so an input whose base or (b, h, s) strides are not 16-byte
  multiples is copied to a contiguous tensor first.
- ``"simple"`` (``csrc/flash_attention.cu``): everything else, float32 (its
  2e-5 tolerance is out of reach of bf16 tensor cores) and the small head
  dimensions of the reduced models.

A failure to build or launch either kernel raises; nothing falls back.  The
wrapper runs the plain version for tensors on the CPU.  ``LAUNCHES`` counts
kernel launches: ``"flash_attention"`` all of them, ``"flash_attention_sm90"``
those of the sm90 route.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _build
from .ref import fp32_matmul

MAX_HEAD_DIM = 256  # largest head dimension the kernels accept (csrc kMaxD)
SM90, SIMPLE = "sm90", "simple"

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_sm90": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a call on the card takes: ``SM90`` for bfloat16 with a
    head dimension that is a multiple of 16 in 64..256, ``SIMPLE`` for
    anything else."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 and 64 <= head_dim <= 256:
        return SM90
    return SIMPLE


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


_FNS: Dict[tuple, object] = {}
_SYMBOLS = {
    (SIMPLE, torch.float32): ("flash_attention", "flash_attention_f32"),
    (SIMPLE, torch.bfloat16): ("flash_attention", "flash_attention_bf16"),
    (SM90, torch.bfloat16): ("flash_attention_sm90", "flash_attention_sm90_bf16"),
}


def _kernel_fn(route: str, dtype: torch.dtype):
    fn = _FNS.get((route, dtype))
    if fn is None:
        source, symbol = _SYMBOLS[(route, dtype)]
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[(route, dtype)] = fn
    return fn


def _tma_ready(x: torch.Tensor) -> bool:
    """Whether a TMA tensor map can describe ``x``: a 16-byte aligned base,
    D contiguous and positive (b, h, s) strides of 16-byte multiples
    (a dimension of size 1 is never stepped, so its stride is free)."""
    return x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
        s > 0 and s * x.element_size() % 16 == 0 for s, n in zip(x.stride()[:3], x.shape[:3]) if n > 1)


def _strides(x: torch.Tensor) -> list:
    """(b, h, s) element strides; a size-1 dimension's is set to D, which
    every tensor map accepts."""
    return [s if n > 1 else x.shape[-1] for s, n in zip(x.stride()[:3], x.shape[:3])]


def _operands(route: str, q, k, v) -> tuple:
    """(q, k, v, o) as ``route``'s kernel reads and writes them: an input it
    cannot read in place is copied to a new contiguous tensor (a clone: a
    misaligned view can already count as contiguous); the output takes q's
    memory layout (a transposed view gives one too; a non-dense q gives a
    contiguous one), which the kernel can then write."""
    ready = _tma_ready if route == SM90 else (lambda x: x.stride(-1) == 1)
    q, k, v = (x if ready(x) else x.clone(memory_format=torch.contiguous_format) for x in (q, k, v))
    return q, k, v, torch.empty_like(q)


def _launch(route: str, q, k, v, *, causal: bool, window: int, scale: Optional[float]) -> torch.Tensor:
    """One launch of ``route``'s kernel on checked CUDA tensors; raises on a
    failed launch."""
    q, k, v, o = _operands(route, q, k, v)
    B, Hq, S, D = q.shape
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, o) for s in _strides(x)))
    scale = (D ** -0.5) if scale is None else scale
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel_fn(route, q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
                                         k.shape[1], S, D, strides, scale, int(causal), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({route} kernel) launch failed: error {err} (a CUDA error code; "
                           f"10000 + a CUresult: a TMA tensor map was refused; 20000: no tensor-map encoder)")
    LAUNCHES["flash_attention"] += 1
    if route == SM90:
        LAUNCHES["flash_attention_sm90"] += 1
    return o


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
    """Causal (and sliding-window, ``window`` > 0) GQA attention; on the
    card the kernel ``flash_route`` names, on the CPU the plain version.
    Forward only, on both devices: the kernel has no backward (the JAX
    package's ``pallas_call`` has no VJP either), so a call that autograd
    would have to differentiate raises instead of returning an output
    whose gradient is silently cut."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward kernel (nor has the JAX package's pallas_call a VJP): "
            "train with use_pallas=False, or call it under torch.no_grad()")
    _check(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"q, k, v must lie on one CUDA device, got {q.device}, {k.device}, {v.device}")
    return _launch(flash_route(q.dtype, q.shape[-1]), q, k, v, causal=causal, window=window, scale=scale)
