"""RWKV6 ("Finch") block: data-dependent per-channel decay, token shift (the
JAX package's ``models/rwkv.py``).

The decay ``w_t = exp(-exp(w0 + tanh(x_w A) B))`` comes from a LoRA of the
input.  The WKV6 recurrence runs chunked, every exponent <= 0
(chunk-relative log-decay differences), so fp32 cannot overflow:

  intra:  A[i,j] = sum_k r_i[k] k_j[k] exp(l_{i-1}[k] - l_j[k])   (j < i)
          A[i,i] = sum_k r_i[k] u[k] k_i[k]                       (bonus u)
  state:  S <- exp(l_last) * S + sum_j (k_j exp(l_last - l_j)) (x) v_j
  inter:  y_i += (r_i exp(l_{i-1}[k])) . S_prev

The JAX package carries the state over the chunks with ``lax.scan``; the
port runs a Python loop.  As in the reference: static token-shift mix
vectors (RWKV5-style) for r/k/v/g, the full data-dependent LoRA path for
the decay, and O(1) decode state: the (B, H, K, V) wkv state and one-token
shift states.

Over ``model`` (``ctx.tp``, ``models/spmd.py``) each half splits where the
resolver splits its leaves, the time-mix by heads and the channel-mix by
``mlp``, apart: rwkv6-3b's 40 heads stay whole on a 16-way ``model`` while
its ``d_ff`` of 8960 splits.  Time-mix: ``wr``, ``wk``, ``wv``, ``wg``,
``w_lora_b``, ``w0``, ``u`` and ``ln_x`` (a norm over each head's K) are
column-parallel, ``wo`` row-parallel, ``mu`` and ``w_lora_a`` whole leaves
(``TP.whole_leaf``).  Channel-mix: ``wk_cm`` column-parallel, ``wv_cm``
row-parallel; ``rr`` multiplies the sum of ``vv``'s parts, so it is
computed whole (``wr_cm``, ``mu_cm[1]``) on the rows of the sequence the
rank keeps.  Each half takes the whole sequence (gathered under sequence
parallelism) before its token shift, so the first token of a rank's
chunk reads the last of the chunk before.  The ``wkv`` state holds the
rank's heads; the shift states are whole.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import PSpec, largest_divisor, norm_apply, norm_template, proj, rms_norm
from .spmd import tp_of


def _dims(cfg: ArchConfig):
    D = cfg.d_model
    K = cfg.rwkv_head_size
    return D, D // K, K


def rwkv_template(cfg: ArchConfig) -> Dict[str, PSpec]:
    D, H, K = _dims(cfg)
    F_ = cfg.d_ff
    lora = 64
    return {
        "ln1": norm_template(cfg),
        "ln2": norm_template(cfg),
        # time-mix
        "mu": PSpec((5, D), (None, "embed"), init="const", scale=0.5),
        "wr": PSpec((D, H, K), ("embed", "heads", "head_dim")),
        "wk": PSpec((D, H, K), ("embed", "heads", "head_dim")),
        "wv": PSpec((D, H, K), ("embed", "heads", "head_dim")),
        "wg": PSpec((D, H, K), ("embed", "heads", "head_dim")),
        "w0": PSpec((H, K), ("heads", "head_dim"), init="zeros"),
        "w_lora_a": PSpec((D, lora), ("embed", None)),
        "w_lora_b": PSpec((lora, H, K), (None, "heads", "head_dim"), scale=0.1),
        "u": PSpec((H, K), ("heads", "head_dim"), init="zeros"),
        "ln_x": PSpec((H, K), ("heads", "head_dim"), init="ones"),
        "wo": PSpec((H, K, D), ("heads", "head_dim", "embed")),
        # channel-mix
        "mu_cm": PSpec((2, D), (None, "embed"), init="const", scale=0.5),
        "wk_cm": PSpec((D, F_), ("embed", "mlp")),
        "wv_cm": PSpec((F_, D), ("mlp", "embed")),
        "wr_cm": PSpec((D, D), ("embed", None)),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros, or the carried state, at t = 0)."""
    first = x.new_zeros(x.shape[0], 1, x.shape[2]) if prev is None else prev[:, None, :].to(x.dtype)
    return torch.cat([first, x[:, :-1]], 1)


def wkv6_chunked(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,  # (B, S, H, K)
    v: torch.Tensor,  # (B, S, H, K)  (V == K)
    log_w: torch.Tensor,  # (B, S, H, K) fp32 <= 0
    u: torch.Tensor,  # (H, K)
    chunk: int,
    s0: Optional[torch.Tensor] = None,  # (B, H, K, V)
    mix_dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, K), final state (B, H, K, V) fp32).  One
    chunk's (B, Q, Q, H, K) pairwise decay at a time.  Every exponent is
    <= 0, so the decay weights lie in [0, 1] and may be rounded to
    ``mix_dtype`` (with r, k and v) for the two pairwise products, which
    accumulate in fp32; the state and every exponent stay fp32."""
    B, S, H, K = r.shape
    Q = largest_divisor(S, chunk)
    f32 = torch.float32
    dev = r.device
    tri_strict = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=dev), diagonal=-1)[None, :, :, None, None]
    eye = torch.eye(Q, dtype=f32, device=dev)[None, :, :, None]
    u32 = u.to(f32)

    def mixed(t):  # rounded to mix_dtype, multiplied in fp32
        return t.to(mix_dtype).to(f32)

    s = r.new_zeros((B, H, K, K), dtype=f32) if s0 is None else s0.to(f32)
    ys = []
    for c0 in range(0, S, Q):
        rc, kc, vc = (t[:, c0:c0 + Q].to(f32) for t in (r, k, v))
        lw = log_w[:, c0:c0 + Q]
        l = torch.cumsum(lw, dim=1)  # inclusive log-decay
        l_exc = l - lw  # exclusive
        # intra: pair[i, j, k] = exp(l_exc[i, k] - l[j, k]), j < i (exponent <= 0),
        # the rest masked before exp (as ssm.ssd_chunked's decay: no NaN gradient)
        pair = torch.exp((l_exc[:, :, None] - l[:, None, :]).masked_fill(~tri_strict, float("-inf")))  # (B, i, j, H, K)
        A = torch.einsum("bihk,bijhk,bjhk->bijh", mixed(rc), mixed(pair), mixed(kc))
        A = A + torch.einsum("bihk,hk,bihk->bih", rc, u32, kc)[:, :, None, :] * eye
        y = torch.einsum("bijh,bjhk->bihk", mixed(A), mixed(vc))
        # inter: the carried state's contribution (exponent <= 0)
        y = y + torch.einsum("bqhk,bhkv->bqhv", rc * torch.exp(l_exc), s)
        # state update (exponents <= 0)
        k_dec = kc * torch.exp(l[:, -1:] - l)
        s = torch.exp(l[:, -1])[..., None] * s + torch.einsum("bqhk,bqhv->bhkv", k_dec, vc)
        ys.append(y)
    return torch.cat(ys, 1).to(r.dtype), s


def rwkv_block_apply(
    cfg: ArchConfig,
    p,
    x: torch.Tensor,  # (B, S, D)
    cache: Optional[Dict[str, torch.Tensor]] = None,
    ctx=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The full RWKV6 layer, time-mix then channel-mix (both with token
    shift).  Returns (out, new cache), the new cache None without one.
    Over ``model`` (module docstring) ``x`` and ``out`` are in the residual
    stream's layout and the ``wkv`` state holds this rank's heads."""
    tp = tp_of(ctx)
    tm_split = tp is not None and p["wr"].shape[1] != cfg.d_model // cfg.rwkv_head_size
    cm_split = tp is not None and p["wk_cm"].shape[1] != cfg.d_ff

    # ---- time mix (pre-norm: x = x + TM(LN1 x)) ---------------------------
    xa = norm_apply(cfg, p["ln1"], x)
    if tp is not None:
        xa = tp.enter(xa) if tm_split else tp.whole(xa)
    S = xa.shape[1]
    xp = _shift(xa, cache["shift_tm"] if cache is not None else None)
    mu, w_lora_a = (tp.whole_leaf(p[k]) if tm_split else p[k] for k in ("mu", "w_lora_a"))
    mu = mu.to(x.dtype)  # (5, D): r, k, v, w, g
    xr, xk, xv, xw, xg = (xa + mu[i] * (xp - xa) for i in range(5))
    r, k, v, g = proj(xr, p["wr"]), proj(xk, p["wk"]), proj(xv, p["wv"]), proj(xg, p["wg"])
    lora = proj(torch.tanh(xw.float()), w_lora_a.float())
    wexp = p["w0"].float() + proj(torch.tanh(lora), p["w_lora_b"].float())
    log_w = -torch.exp(wexp)  # data-dependent decay, always <= 0

    # chunked in every mode: a prefill with a cache in one S-sized chunk
    # would hold a (B, S, S, H, K) pair tensor
    chunk = cfg.rwkv_chunk if S > 1 else 1
    mix_dtype = torch.bfloat16 if cfg.score_dtype == "bf16" else torch.float32
    y, s_final = wkv6_chunked(r, k, v, log_w, p["u"], chunk, cache["wkv"] if cache is not None else None,
                              mix_dtype=mix_dtype)
    y = rms_norm(y, torch.ones((), dtype=y.dtype, device=y.device)) * p["ln_x"].to(y.dtype)
    y = y * F.silu(g.float()).to(y.dtype)
    tm = proj(y.flatten(2), p["wo"].flatten(0, 1))
    if tp is not None:
        tm = tp.leave(tm) if tm_split else tp.own(tm)
    x = x + tm

    # ---- channel mix (pre-norm) --------------------------------------------
    xb = norm_apply(cfg, p["ln2"], x)
    xbk = xbr = xb  # the key half's input, and rr's
    if cm_split:  # the key half computes its part; rr whole on the sequence this rank keeps
        xbk = tp.enter(xb)
        xbr = xbk if tp.sp else xb
    elif tp is not None:
        xbk = xbr = tp.whole(xb)
    prev = cache["shift_cm"] if cache is not None else None
    xpk = _shift(xbk, prev)
    xpr = xpk if xbr is xbk else _shift(xbr, prev)
    if tp is not None:
        xbr, xpr = tp.own(xbr), tp.own(xpr)
    mu_k = (tp.whole_leaf(p["mu_cm"]) if cm_split else p["mu_cm"])[0].to(x.dtype)
    xk2 = xbk + mu_k * (xpk - xbk)
    xr2 = xbr + p["mu_cm"][1].to(x.dtype) * (xpr - xbr)
    kk = F.relu(proj(xk2, p["wk_cm"]).float()).square().to(x.dtype)
    vv = proj(kk, p["wv_cm"])
    if tp is not None:
        vv = tp.leave(vv) if cm_split else tp.own(vv)
    rr = torch.sigmoid(proj(xr2, p["wr_cm"]).float()).to(x.dtype)
    out = x + rr * vv
    if cache is None:
        return out, None
    # the shift states carry the normed inputs at the last position
    return out, {"wkv": s_final, "shift_tm": xa[:, -1], "shift_cm": xbk[:, -1]}


def rwkv_cache_shape(cfg: ArchConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    D, H, K = _dims(cfg)
    return {"wkv": (batch, H, K, K), "shift_tm": (batch, D), "shift_cm": (batch, D)}
