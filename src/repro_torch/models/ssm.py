"""Mamba2 block (state-space dual / SSD) with a chunked scan (the JAX
package's ``models/ssm.py``).

The sequence is processed in chunks: intra-chunk work is a masked (Q x Q)
product, and only the small per-chunk state (B, H, N, P) is carried from
one chunk to the next.  The JAX package carries it with ``lax.scan``; the
port runs a Python loop over the chunks.  Every decay exponent is <= 0 by
construction, so fp32 ``exp`` never overflows; the chunk's masked half is
masked before ``exp``, where the reference masks after and its gradient
is NaN at published widths (a reference caveat in ROADMAP).

Decode keeps O(1) state: the SSM state (B, H, N, P) plus a (ck-1)-deep
convolution tail per stream.

Over ``model`` (``ctx.tp``, ``models/spmd.py``) the mixer is split by
heads where the resolver splits them: ``wz``, ``wx``, ``wdt``, ``conv_x``,
``A_log``, ``dt_bias``, ``D_skip`` and ``norm`` are column-parallel and
``wo`` row-parallel; ``wb``, ``wc``, ``conv_b`` and ``conv_c`` (one B/C
group, read by every head) are whole leaves each rank uses for its heads
(``TP.whole_leaf``).  The scan runs on the rank's heads over the whole
sequence (gathered under sequence parallelism) and the gated norm reduces
over each head's P alone, so nothing is exchanged inside the mixer.  The
cache's ``ssm`` and ``conv_x`` hold the rank's heads; ``conv_b`` and
``conv_c`` are whole.  Heads that do not divide ``model`` run whole on
every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import PSpec, largest_divisor, proj, rms_norm
from .spmd import tp_of


def _dims(cfg: ArchConfig):
    H = cfg.ssm_heads
    return H, (cfg.ssm_expand * cfg.d_model) // H, cfg.ssm_state, cfg.ssm_conv


def mamba_template(cfg: ArchConfig) -> Dict[str, PSpec]:
    D = cfg.d_model
    H, P, N, ck = _dims(cfg)
    G = 1  # B/C groups
    return {
        "wz": PSpec((D, H, P), ("embed", "heads", "head_dim")),
        "wx": PSpec((D, H, P), ("embed", "heads", "head_dim")),
        "wb": PSpec((D, G, N), ("embed", None, None)),
        "wc": PSpec((D, G, N), ("embed", None, None)),
        "wdt": PSpec((D, H), ("embed", "heads")),
        "conv_x": PSpec((ck, H, P), (None, "heads", "head_dim"), init="normal"),
        "conv_b": PSpec((ck, G, N), (None, None, None)),
        "conv_c": PSpec((ck, G, N), (None, None, None)),
        "A_log": PSpec((H,), ("heads",), init="zeros"),
        "dt_bias": PSpec((H,), ("heads",), init="zeros"),
        "D_skip": PSpec((H,), ("heads",), init="ones"),
        "norm": PSpec((H, P), ("heads", "head_dim"), init="ones"),
        "wo": PSpec((H, P, D), ("heads", "head_dim", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along dim 1.  x: (B, S, ...), w: (ck, ...)."""
    ck, S = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(ck):  # ck is tiny (4): unrolled shifts
        shift = ck - 1 - i
        xi = x if shift == 0 else torch.cat([x.new_zeros((x.shape[0], shift) + x.shape[2:]), x], 1)[:, :S]
        out = out + xi * w[i].to(x.dtype)
    return out


def ssd_chunked(
    xs: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) fp32, positive
    A: torch.Tensor,  # (H,) fp32, negative
    bs: torch.Tensor,  # (B, S, G, N)
    cs: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    s0: Optional[torch.Tensor] = None,  # (B, H, N, P) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P), final state (B, H, N, P) fp32).

    One chunk's (B, Q, Q, H) decay matrix at a time, never the whole
    sequence's; exponents are <= 0 throughout."""
    B, S, H, P = xs.shape
    G, N = bs.shape[2], bs.shape[3]
    Q = largest_divisor(S, chunk)
    hg = H // G
    f32 = torch.float32
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xs.device))[None, :, :, None]
    s = xs.new_zeros((B, H, N, P), dtype=f32) if s0 is None else s0.to(f32)
    ys = []
    for c0 in range(0, S, Q):
        xc, dtc = xs[:, c0:c0 + Q].to(f32), dt[:, c0:c0 + Q].to(f32)
        bc, cc = bs[:, c0:c0 + Q].to(f32), cs[:, c0:c0 + Q].to(f32)
        log_a = dtc * A  # (B, Q, H) <= 0
        l = torch.cumsum(log_a, dim=1)  # inclusive
        # intra: M[i, j] = exp(l_i - l_j), i >= j (exponent <= 0); the upper
        # half's exponents (> 0, past fp32's range at Q = 128) are masked
        # before exp, not after: a zero cotangent times exp's inf there is a
        # NaN gradient (the reference's where(tri, exp(.), 0) has it)
        M = torch.exp((l[:, :, None, :] - l[:, None, :, :]).masked_fill(~tri, float("-inf")))  # (B, Q, Q, H)
        CB = torch.einsum("bqgn,bkgn->bqkg", cc, bc)  # (B, Q, Q, G)
        W = CB.repeat_interleave(hg, dim=-1) * M * dtc[:, None, :, :]
        y = torch.einsum("bqkh,bkhp->bqhp", W, xc)
        # inter: the carried state, decayed from the chunk's start
        cs_h = cc.repeat_interleave(hg, dim=2)  # (B, Q, H, N)
        y = y + torch.einsum("bqhn,bhnp->bqhp", cs_h * torch.exp(l)[..., None], s)
        # state update
        wj = (dtc * torch.exp(l[:, -1:, :] - l))[..., None]  # (B, Q, H, 1), decay to the end <= 1
        bs_h = bc.repeat_interleave(hg, dim=2)  # (B, Q, H, N)
        s = torch.exp(l[:, -1])[:, :, None, None] * s + torch.einsum("bqhn,bqhp->bhnp", bs_h, xc * wj)
        ys.append(y)
    return torch.cat(ys, 1).to(xs.dtype), s


def mamba_apply(
    cfg: ArchConfig,
    p,
    x: torch.Tensor,  # (B, S, D)
    cache: Optional[Dict[str, torch.Tensor]] = None,
    ctx=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out, new cache): the new conv tails and SSM state, or None
    without a cache.  Over ``model`` (module docstring) ``x`` and ``out``
    are in the residual stream's layout and the cache holds this rank's
    heads."""
    tp = tp_of(ctx)
    split = tp is not None and p["wx"].shape[1] != cfg.ssm_heads
    if tp is not None:
        x = tp.enter(x) if split else tp.whole(x)
    if split:
        p = {**p, **{k: tp.whole_leaf(p[k]) for k in ("wb", "wc", "conv_b", "conv_c")}}
    S = x.shape[1]
    ck = cfg.ssm_conv
    z, xs = proj(x, p["wz"]), proj(x, p["wx"])
    bs, cs = proj(x, p["wb"]), proj(x, p["wc"])
    dt = F.softplus(proj(x, p["wdt"]).float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if cache is None:
        xs_c, bs_c, cs_c = (_causal_conv(t, p[k]) for t, k in ((xs, "conv_x"), (bs, "conv_b"), (cs, "conv_c")))
        new_cache = None
    else:
        # prepend the conv tails (B, ck-1, ...), keep the last ck-1 raw inputs
        full = {k: torch.cat([cache[k].to(t.dtype), t], 1) for t, k in ((xs, "conv_x"), (bs, "conv_b"), (cs, "conv_c"))}
        xs_c, bs_c, cs_c = (_causal_conv(full[k], p[k])[:, ck - 1:] for k in ("conv_x", "conv_b", "conv_c"))
        new_cache = {k: t[:, -(ck - 1):] for k, t in full.items()}
    xs_c, bs_c, cs_c = (F.silu(t.float()).to(t.dtype) for t in (xs_c, bs_c, cs_c))

    if cache is None:
        y, _ = ssd_chunked(xs_c, dt, A, bs_c, cs_c, cfg.ssm_chunk)
    else:
        # chunked prefill too: one S-sized chunk would hold a (B, S, S, H) decay matrix
        y, new_cache["ssm"] = ssd_chunked(xs_c, dt, A, bs_c, cs_c, cfg.ssm_chunk if S > 1 else 1,
                                          s0=cache["ssm"])
    y = y + p["D_skip"].to(y.dtype)[:, None] * xs_c
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), torch.ones((), dtype=y.dtype, device=y.device))
    y = y * p["norm"].to(y.dtype)
    out = proj(y.flatten(2), p["wo"].flatten(0, 1))
    if tp is not None:
        out = tp.leave(out) if split else tp.own(out)
    return out, new_cache


def mamba_cache_shape(cfg: ArchConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    H, P, N, ck = _dims(cfg)
    G = 1
    return {
        "ssm": (batch, H, N, P),
        "conv_x": (batch, ck - 1, H, P),
        "conv_b": (batch, ck - 1, G, N),
        "conv_c": (batch, ck - 1, G, N),
    }
