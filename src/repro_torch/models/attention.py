"""GQA attention: qk-norm, RoPE, sliding-window/global masks, KV cache (the
JAX package's ``models/attention.py``).

Layouts as in the JAX package: activations (B, S, H, hd); KV cache
(B, Smax, Hkv, hd).  ``window`` is a static int (0 = global).  The
no-cache path (forward/loss) goes through the hand-written flash kernel
when ``cfg.use_pallas`` is set, else through the portable ``_sdpa_auto``;
the cache path (prefill/decode) always takes ``_sdpa_auto``, as in the
JAX package.

Cache writes happen in place: the returned cache holds the same tensors as
the one passed in, with the new K/V written at ``cache_pos``.  The JAX
package returns updated copies (a ``dynamic_update_slice`` for a uniform
position, a ``jnp.where`` select against ``arange == cache_pos`` for a
per-slot position vector); the port writes a slice, or one indexed row per
slot, which is the same result without an O(Smax) select.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..kernels.flash_attention import flash_attention
from .layers import PSpec, apply_rope, proj, rms_norm, rope_embed

NEG_INF = -1e30


def attention_template(cfg: ArchConfig) -> Dict[str, PSpec]:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    t = {
        "wq": PSpec((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": PSpec((D, Hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((D, Hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((H, hd, D), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        t["q_norm"] = PSpec((hd,), ("head_dim",), init="ones")
        t["k_norm"] = PSpec((hd,), ("head_dim",), init="ones")
    return t


def _qkv(cfg: ArchConfig, p, x, positions, window: int = 0):
    q, k, v = proj(x, p["wq"]), proj(x, p["wk"]), proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.pos_type == "rope":
        # gemma3: sliding-window layers use the short (local) rope base
        theta = cfg.rope_theta_local if window > 0 else cfg.rope_theta
        cos, sin = rope_embed(positions, cfg.hd, theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _sdpa(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, hd)
    q_pos: torch.Tensor,  # (B, Sq)
    k_pos: torch.Tensor,  # (B, Sk)
    k_valid: Optional[torch.Tensor],  # (B, Sk) bool or None
    window: int,  # 0 = global
    score_dtype: str = "f32",
) -> torch.Tensor:
    """Portable attention.  Scores and probabilities in ``score_dtype``;
    the probabilities-times-V contraction always in float32 (the JAX
    ``preferred_element_type=float32``: the operands are upcast, so a
    bf16 input gives an fp32 product, not a rounded bf16 one)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    dt = torch.bfloat16 if score_dtype == "bf16" else torch.float32
    qg = q.reshape(B, Sq, Hkv, g, hd)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg.to(dt), k.to(dt))
    # the scale rounded to dt, as jnp.asarray(hd ** -0.5, dt); host scalars
    # only, so nothing here waits for the device
    logits = logits * torch.tensor(hd ** -0.5, dtype=dt).item()
    mask = k_pos[:, None, :] <= q_pos[:, :, None]  # causal
    if window > 0:
        mask &= k_pos[:, None, :] > q_pos[:, :, None] - window
    if k_valid is not None:
        mask &= k_valid[:, None, :]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs.float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _sdpa_chunked(q, k, v, q_pos, k_pos, k_valid, window: int, q_chunk: int,
                  score_dtype: str = "f32") -> torch.Tensor:
    """Attention over query chunks of ``q_chunk`` rows, so one chunk's
    (B, H, c, Sk) scores exist at a time.  Under grad each chunk is
    rematerialised (the JAX package scans the chunks under
    ``jax.checkpoint``): the backward recomputes a chunk's scores instead of
    keeping all of them (taken only when autograd records: see
    ``transformer.records``)."""
    outs = []
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    for qc, pc in zip(q.split(q_chunk, dim=1), q_pos.split(q_chunk, dim=1)):
        if grad:
            outs.append(checkpoint(_sdpa, qc, k, v, pc, k_pos, k_valid, window, score_dtype,
                                   use_reentrant=False, preserve_rng_state=False))
        else:
            outs.append(_sdpa(qc, k, v, pc, k_pos, k_valid, window, score_dtype))
    return torch.cat(outs, dim=1)


def _sdpa_auto(cfg: ArchConfig, q, k, v, q_pos, k_pos, k_valid, window: int):
    """Pick chunked vs direct attention by query length."""
    Sq = q.shape[1]
    if Sq > cfg.attn_q_chunk and Sq % cfg.attn_q_chunk == 0:
        return _sdpa_chunked(
            q, k, v, q_pos, k_pos, k_valid, window, cfg.attn_q_chunk, cfg.score_dtype,
        )
    return _sdpa(q, k, v, q_pos, k_pos, k_valid, window, cfg.score_dtype)


def attention_apply(
    cfg: ArchConfig,
    p,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    window: int = 0,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Union[int, torch.Tensor, None] = None,  # scalar, or (B,) per-slot write index
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (output, cache); the cache is updated in place."""
    q, k, v = _qkv(cfg, p, x, positions, window)
    if cache is None:
        if cfg.use_pallas:
            o = flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, window=window,
            ).transpose(1, 2)
        else:
            o = _sdpa_auto(cfg, q, k, v, positions, positions, None, window)
    else:
        # write new K/V at cache_pos, attend over the whole cache
        B, Sq = x.shape[0], x.shape[1]
        ck, cv = cache["k"], cache["v"]
        Smax = ck.shape[1]
        k_pos = torch.arange(Smax, device=x.device)[None, :].expand(B, Smax)
        if not torch.is_tensor(cache_pos) or cache_pos.dim() == 0:
            start = int(cache_pos)
            ck[:, start:start + Sq] = k.to(ck.dtype)
            cv[:, start:start + Sq] = v.to(cv.dtype)
            last = start + Sq - 1
        else:
            if Sq != 1:
                raise ValueError(f"a per-slot cache_pos writes one token a slot, got {Sq}")
            pos = cache_pos.to(x.device)
            lanes = torch.arange(B, device=x.device)
            ck[lanes, pos] = k[:, 0].to(ck.dtype)
            cv[lanes, pos] = v[:, 0].to(cv.dtype)
            last = pos[:, None]
        # valid = written region (last written index = cache_pos + Sq - 1);
        # causality vs the query positions is enforced inside _sdpa.
        k_valid = k_pos <= last
        o = _sdpa_auto(cfg, q, ck, cv, positions, k_pos, k_valid, window)
    H, hd, D = p["wo"].shape
    out = o.reshape(*o.shape[:2], H * hd) @ p["wo"].to(o.dtype).reshape(H * hd, D)
    return out, cache


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, n: int, dtype, device=None):
    """n stacked caches (one per layer group)."""
    shape = (n, batch, max_seq, cfg.n_kv, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
