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

Over ``model`` (``ctx.tp``, ``models/spmd.py``) attention is column- and
row-parallel: each rank takes its ``H / tp`` query heads and the KV heads
they read (its own when ``n_kv`` divides ``model``, else a slice of the
whole ``wk``/``wv``), and ``wo``'s rows; every head count is read from the
blocks' shapes.  Heads that do not divide ``model`` are computed whole on
every rank.  A KV cache split on seq (``ctx.kv_seq``) is attended block by
block and the blocks combined (``_attend_seq_split``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..kernels.flash_attention import flash_attention
from .layers import PSpec, apply_rope, proj, rms_norm, rope_embed
from .spmd import all_gather, all_reduce, tp_of

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


def _mask(q_pos, k_pos, k_valid, window: int) -> torch.Tensor:
    """(B, Sq, Sk): causal, within the window, and written."""
    mask = k_pos[:, None, :] <= q_pos[:, :, None]  # causal
    if window > 0:
        mask &= k_pos[:, None, :] > q_pos[:, :, None] - window
    if k_valid is not None:
        mask &= k_valid[:, None, :]
    return mask


def _scores(q, k, score_dtype: str):
    """(B, Hkv, g, Sq, Sk) scaled logits of q (B, Sq, H, hd) against k
    (B, Sk, Hkv, hd), in ``score_dtype``."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    dt = torch.bfloat16 if score_dtype == "bf16" else torch.float32
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg.to(dt), k.to(dt))
    # the scale rounded to dt, as jnp.asarray(hd ** -0.5, dt); host scalars
    # only, so nothing here waits for the device
    return logits * torch.tensor(hd ** -0.5, dtype=dt).item()


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
    logits = _scores(q, k, score_dtype)
    logits = torch.where(_mask(q_pos, k_pos, k_valid, window)[:, None, None], logits, NEG_INF)
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


def _sdpa_stats(cfg: ArchConfig, q, k, v, q_pos, k_pos, k_valid, window: int):
    """``_sdpa`` over one block of the keys, unnormalised, for a
    log-sum-exp combine with the other blocks (``_combine``): each row's
    max logit, sum of exponentials and exponential-weighted V, in float32,
    (B, Hkv, g, Sq) and (B, Hkv, g, Sq, hd); over query chunks of
    ``cfg.attn_q_chunk`` as ``_sdpa_auto``.  A row with no key in the block
    has max ``NEG_INF`` and weighs nothing in the combine."""
    Sq, c = q.shape[1], cfg.attn_q_chunk
    if Sq > c and Sq % c == 0:
        parts = [_sdpa_stats(cfg, qc, k, v, pc, k_pos, k_valid, window)
                 for qc, pc in zip(q.split(c, dim=1), q_pos.split(c, dim=1))]
        return tuple(torch.cat(t, dim=3) for t in zip(*parts))
    logits = _scores(q, k, cfg.score_dtype)
    logits = torch.where(_mask(q_pos, k_pos, k_valid, window)[:, None, None], logits, NEG_INF).float()
    m = logits.amax(-1)
    e = torch.exp(logits - m[..., None])
    return m, e.sum(-1), torch.einsum("bhgqs,bshk->bhgqk", e, v.float())


def _combine(m, l, acc, groups) -> torch.Tensor:
    """The attention output (B, Sq, H, hd) in float32 from every seq block's
    ``_sdpa_stats``: one max and one sum over each group in ``groups``."""
    B, Hkv, g, Sq, hd = acc.shape
    M = m.clone()
    for grp in groups:
        all_reduce(M, grp, "max")
    s = torch.exp(m - M)
    buf = torch.cat([(l * s)[..., None], acc * s[..., None]], dim=-1)
    for grp in groups:
        all_reduce(buf, grp)
    out = buf[..., 1:] / buf[..., :1]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hkv * g, hd)


def _write(ck, cv, k, v, cache_pos, lo: Optional[int] = None):
    """Write the new K/V rows at ``cache_pos`` (a scalar, or (B,) per-slot
    positions) into the cache ``ck``/``cv`` (B, L, Hkv, hd); ``lo``: the
    cache is the block of positions [lo, lo + L) and only rows that fall in
    it are written.  Returns the last written position, an int or (B, 1)."""
    Sq = k.shape[1]
    if not torch.is_tensor(cache_pos) or cache_pos.dim() == 0:
        start = int(cache_pos)
        if lo is None:
            ck[:, start:start + Sq] = k.to(ck.dtype)
            cv[:, start:start + Sq] = v.to(cv.dtype)
        else:
            a, b = max(start, lo), min(start + Sq, lo + ck.shape[1])
            if a < b:
                ck[:, a - lo:b - lo] = k[:, a - start:b - start].to(ck.dtype)
                cv[:, a - lo:b - lo] = v[:, a - start:b - start].to(cv.dtype)
        return start + Sq - 1
    if Sq != 1:
        raise ValueError(f"a per-slot cache_pos writes one token a slot, got {Sq}")
    pos = cache_pos.to(k.device)
    lanes = torch.arange(k.shape[0], device=k.device)
    if lo is None:
        ck[lanes, pos] = k[:, 0].to(ck.dtype)
        cv[lanes, pos] = v[:, 0].to(cv.dtype)
    else:
        # rows outside the block write back what they read (no host sync)
        idx = (pos - lo).clamp(0, ck.shape[1] - 1)
        inside = ((pos >= lo) & (pos < lo + ck.shape[1]))[:, None, None]
        ck[lanes, idx] = torch.where(inside, k[:, 0].to(ck.dtype), ck[lanes, idx])
        cv[lanes, idx] = torch.where(inside, v[:, 0].to(cv.dtype), cv[lanes, idx])
    return pos[:, None]


def _attend(cfg: ArchConfig, q, k, v, positions, window: int, cache, cache_pos, sel=None):
    """Attention of this rank's queries: without a cache through the flash
    kernel (``cfg.use_pallas``) or ``_sdpa_auto``; with one, the new K/V
    written at ``cache_pos`` first, then over the whole cache (``sel``: the
    cache's KV heads these queries read)."""
    if cache is None:
        if cfg.use_pallas:
            return flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, window=window,
            ).transpose(1, 2)
        return _sdpa_auto(cfg, q, k, v, positions, positions, None, window)
    ck, cv = cache["k"], cache["v"]
    B, Smax = q.shape[0], ck.shape[1]
    last = _write(ck, cv, k, v, cache_pos)
    k_pos = torch.arange(Smax, device=q.device)[None, :].expand(B, Smax)
    # valid = written region (last written index = cache_pos + Sq - 1);
    # causality vs the query positions is enforced inside _sdpa.
    k_valid = k_pos <= last
    if sel is not None:
        ck, cv = _take(ck, sel, 2), _take(cv, sel, 2)
    return _sdpa_auto(cfg, q, ck, cv, positions, k_pos, k_valid, window)


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    H, hd, D = wo.shape
    return o.reshape(*o.shape[:2], H * hd) @ wo.to(o.dtype).reshape(H * hd, D)


def attention_apply(
    cfg: ArchConfig,
    p,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    window: int = 0,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Union[int, torch.Tensor, None] = None,  # scalar, or (B,) per-slot write index
    ctx=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (output, cache); the cache is updated in place.  Over
    ``model`` (``ctx``: module docstring) ``x`` and the output are in the
    residual stream's layout."""
    tp = tp_of(ctx)
    if tp is not None:
        return _attention_tp(cfg, p, x, positions, window, cache, cache_pos, ctx, tp), cache
    q, k, v = _qkv(cfg, p, x, positions, window)
    o = _attend(cfg, q, k, v, positions, window, cache, cache_pos)
    return _out(o, p["wo"]), cache


def kv_heads_read(H: int, Hkv: int, lo: int, n: int):
    """The KV heads query heads lo .. lo + n - 1 read (head h reads
    h // (H / Hkv)): a slice when they read whole groups or lie in one
    group (GQA on the slice), else each head's own KV head (an index)."""
    g = H // Hkv
    first, last = lo // g, (lo + n - 1) // g
    if (n % g == 0 and lo % g == 0) or first == last:
        return slice(first, last + 1)
    return torch.tensor([(lo + j) // g for j in range(n)])


def _take(t: torch.Tensor, sel, dim: int) -> torch.Tensor:
    if isinstance(sel, slice):
        return t.narrow(dim, sel.start, sel.stop - sel.start)
    return t.index_select(dim, sel.to(t.device))


def _attention_tp(cfg: ArchConfig, p, x, positions, window: int, cache, cache_pos, ctx, tp) -> torch.Tensor:
    """Attention over ``model`` (module docstring)."""
    H, Hkv = cfg.n_heads, cfg.n_kv
    Hl = p["wq"].shape[1]
    split = Hl != H
    w = {k: p[k] for k in ("wq", "wk", "wv", "q_norm", "k_norm") if k in p}
    every_kv = cache is not None and cache["k"].shape[-2] == Hkv  # the cache holds every KV head
    # the KV heads this rank's query heads read, where they are not its own
    sel = kv_heads_read(H, Hkv, tp.rank * Hl, Hl) if split and (every_kv or p["wk"].shape[1] == Hkv) else None
    if sel is not None and not every_kv:  # project only those
        w["wk"], w["wv"] = (_take(tp.whole_leaf(p[n]), sel, 1) for n in ("wk", "wv"))
        sel = None
    if split and cfg.qk_norm:
        w["q_norm"], w["k_norm"] = tp.whole_leaf(p["q_norm"]), tp.whole_leaf(p["k_norm"])
    q, k, v = _qkv(cfg, w, tp.enter(x) if split else tp.whole(x), positions, window)
    if every_kv and k.shape[2] != Hkv:  # this rank projected its own KV heads: the cache takes them all
        k, v = all_gather(k, 2, tp.group, tp.n), all_gather(v, 2, tp.group, tp.n)
    seq = ctx.kv_seq if cache is not None else None
    if seq is None:
        o = _attend(cfg, q, k, v, positions, window, cache, cache_pos, sel)
    else:
        o = _attend_seq_split(cfg, q, k, v, positions, window, cache, cache_pos, seq, tp, split and every_kv)
    if split:
        return tp.leave(_out(o, p["wo"]))
    return tp.own(_out(o, p["wo"]))


def _attend_seq_split(cfg: ArchConfig, q, k, v, positions, window: int, cache, cache_pos, seq, tp,
                      all_heads: bool) -> torch.Tensor:
    """Attention over a cache split on seq (``seq``, a ``SeqSplit``): the
    new K/V rows written where their positions fall in this rank's block,
    the queries attended over the block, the blocks' results combined
    (``_combine``).  ``all_heads``: this rank's query heads are gathered
    over ``model`` first, and its own kept after."""
    ck, cv = cache["k"], cache["v"]
    Hl = q.shape[2]
    if all_heads:
        q = all_gather(q, 2, tp.group, tp.n)
    B, L = q.shape[0], ck.shape[1]
    lo = seq.index * L
    last = _write(ck, cv, k, v, cache_pos, lo)
    k_pos = (lo + torch.arange(L, device=q.device))[None, :].expand(B, L)
    o = _combine(*_sdpa_stats(cfg, q, ck, cv, positions, k_pos, k_pos <= last, window), seq.groups)
    if all_heads:
        o = o.narrow(2, tp.rank * Hl, Hl)
    return o.to(q.dtype)


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, n: int, dtype, device=None):
    """n stacked caches (one per layer group)."""
    shape = (n, batch, max_seq, cfg.n_kv, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
