"""Analytic useful FLOPs of a step (the JAX package's ``launch/roofline.py``,
its ``seq_mix_flops`` and ``model_flops``).

MODEL_FLOPS (useful compute) comes from the exact parameter template:
6*N_active*tokens for training, 2*N_active*tokens for inference, plus the
sequence-mixing term per family (causal-aware).  A training step's model
FLOPs over its time and the card's peak rate give its MFU.  The HLO-based
three-term roofline waits for the port's compiled-artifact cost model
(ROADMAP A12c).
"""

from __future__ import annotations

from typing import Optional

from ..configs.base import ArchConfig, ShapeConfig
from ..models.model import param_counts


def seq_mix_flops(cfg: ArchConfig, batch: int, seq: int, kind: str) -> float:
    """Sequence-mixing FLOPs beyond the 6N/2N weight term (causal-aware)."""
    B, S = batch, seq

    def attn(n_layers: int, cache_len: Optional[int] = None) -> float:
        H, hd = cfg.n_heads, cfg.hd
        if kind == "decode":
            L = cache_len if cache_len is not None else S
            return 4.0 * B * L * H * hd * n_layers  # q.K + p.V, one token
        # train/prefill: causal = half the full square
        f = 2.0 * B * S * S * H * hd * n_layers
        return f * (3.0 if kind == "train" else 1.0)  # bwd ~ 2x fwd

    if cfg.family == "rwkv":
        D = cfg.d_model
        H = D // cfg.rwkv_head_size
        K = cfg.rwkv_head_size
        Q = cfg.rwkv_chunk
        T = B * (1 if kind == "decode" else S)
        f = 2.0 * T * H * K * (2 * K + 2 * Q) * cfg.n_layers
        return f * (3.0 if kind == "train" else 1.0)
    if cfg.family == "hybrid":
        D = cfg.d_model
        H, P, N, Q = cfg.ssm_heads, (cfg.ssm_expand * cfg.d_model) // cfg.ssm_heads, cfg.ssm_state, cfg.ssm_chunk
        T = B * (1 if kind == "decode" else S)
        ssd = 2.0 * T * H * (2 * N * P + Q * (N + P)) * cfg.n_layers
        ssd *= 3.0 if kind == "train" else 1.0
        n_shared = cfg.n_layers // max(cfg.hybrid_attn_every, 1)
        return ssd + attn(n_shared, cache_len=S)
    if cfg.local_per_global > 0:
        g = cfg.local_per_global + 1
        n_glob = cfg.n_layers // g
        n_loc = cfg.n_layers - n_glob
        W = cfg.local_window
        H, hd = cfg.n_heads, cfg.hd
        if kind == "decode":
            loc = 4.0 * B * min(W, S) * H * hd * n_loc
        else:
            loc = 4.0 * B * S * min(W, S) * H * hd * n_loc * (
                3.0 if kind == "train" else 1.0
            )
        return attn(n_glob, cache_len=S) + loc
    return attn(cfg.n_layers, cache_len=S)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    c = param_counts(cfg)
    N = c["active_nonembed"]
    if shape.kind == "train":
        T = shape.global_batch * shape.seq_len
        return 6.0 * N * T + seq_mix_flops(cfg, shape.global_batch, shape.seq_len, "train")
    if shape.kind == "prefill":
        T = shape.global_batch * shape.seq_len
        return 2.0 * N * T + seq_mix_flops(cfg, shape.global_batch, shape.seq_len, "prefill")
    # decode: one token per sequence against a cache of seq_len
    T = shape.global_batch
    return 2.0 * N * T + seq_mix_flops(cfg, shape.global_batch, shape.seq_len, "decode")
