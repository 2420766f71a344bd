"""Three-term roofline of a traced step, and the analytic useful FLOPs (the
JAX package's ``launch/roofline.py``).

    compute term    = FLOPs / PEAK_FLOPS
    memory term     = traffic / HBM_BW
    collective term = collective bytes a rank / COLL_BW

FLOPs, traffic and collective bytes are one rank's, from one eager call of
the step (``launch/trace_cost.py``, the counterpart of the reference's
loop-aware HLO walk).  Ring-collective convention, as the reference's: an
all-gather moves about its result's bytes a rank, an all-reduce twice its
operand's, a reduce-scatter, all-to-all or permute about its operand's;
the (n-1)/n factor is folded to 1.  ``parse_collectives`` takes the
recorded (kind, result bytes) list of a trace where the reference parses
HLO text.

MODEL_FLOPS (useful compute) comes from the exact parameter template:
6*N_active*tokens for training, 2*N_active*tokens for inference, plus the
sequence-mixing term per family (causal-aware).  The ratio
MODEL_FLOPS / (ranks * traced FLOPs) exposes remat, recompute, full-causal
and duplicated work; a training step's model FLOPs over its time and the
card's peak rate give its MFU.

The record keeps the reference's field names (``hlo_flops``, ``hlo_bytes``
hold the trace's FLOPs and traffic), so the two packages' JSON records
diff field by field; the reference's ``xla_cost_*`` (XLA's own
loop-unaware count) has no counterpart and is left out.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, Optional, Tuple

from ..configs.base import ArchConfig, ShapeConfig
from ..models.model import param_counts

# ---- the card's constants -----------------------------------------------
PEAK_FLOPS = 989e12  # NVIDIA H100 80GB HBM3, 700.00 W: bf16 dense tensor-core FLOP/s (datasheet, SXM5)
HBM_BW = 3.35e12  # NVIDIA H100 80GB HBM3, 700.00 W: HBM bytes/s (datasheet; the bound PERF.md divides by)
# NVIDIA H100 80GB HBM3, 700.00 W: collective bytes/s a card.  Every axis of
# the (16, 16) and (2, 16, 16) meshes spans more than one 8-card node, so one
# conservative inter-node figure, one 400 Gb/s NIC a card: a datasheet
# assumption, not a measurement (the cards' links are unmeasured, PERF.md
# section 6)
COLL_BW = 50e9

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def parse_collectives(calls: Iterable[Tuple[str, float]]) -> Dict[str, Dict[str, float]]:
    """Per-kind {count, bytes} from a trace's recorded collectives, each
    (kind, result bytes) and one rank's: an all-reduce counts twice its
    bytes (the ring's reduce-scatter and all-gather phases)."""
    out: Dict[str, Dict[str, float]] = {k: {"count": 0, "bytes": 0.0} for k in KINDS}
    for kind, b in calls:
        c = out.setdefault(kind, {"count": 0, "bytes": 0.0})
        c["count"] += 1
        c["bytes"] += float(b) * (2.0 if kind == "all-reduce" else 1.0)
    return out


def collective_bytes(coll: Dict[str, Dict[str, float]]) -> float:
    return sum(v["bytes"] for v in coll.values())


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


# --------------------------------------------------------------------------
# report
# --------------------------------------------------------------------------
@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # a rank's traced FLOPs
    hlo_bytes: float  # a rank's traced traffic
    coll_bytes: float
    collectives: Dict[str, Dict[str, float]]
    model_flops_total: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0  # MODEL_FLOPS / (chips * FLOPs a rank)
    mfu_bound: float = 0.0  # MODEL_FLOPS / (chips * PEAK * max term)
    memory_per_chip: Optional[float] = None
    notes: str = ""

    def finalize(self) -> "Roofline":
        self.compute_s = self.hlo_flops / PEAK_FLOPS
        self.memory_s = self.hlo_bytes / HBM_BW
        self.collective_s = self.coll_bytes / COLL_BW
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        self.bottleneck = max(terms, key=terms.get)
        denom = self.chips * self.hlo_flops
        self.useful_ratio = self.model_flops_total / denom if denom else 0.0
        t = max(self.compute_s, self.memory_s, self.collective_s)
        self.mfu_bound = (
            self.model_flops_total / (self.chips * PEAK_FLOPS * t) if t else 0.0
        )
        return self

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def analyze(
    cfg: ArchConfig,
    shape: ShapeConfig,
    mesh_name: str,
    chips: int,
    cost,
    memory_stats: Optional[Dict[str, float]] = None,
    notes: str = "",
) -> Roofline:
    """Three-term roofline of one rank's traced step (``cost``: a
    ``trace_cost.TraceCost``)."""
    if cost.notes:
        notes = (notes + "; " + cost.notes).strip("; ")
    r = Roofline(
        arch=cfg.name,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=cost.flops,
        hlo_bytes=cost.traffic,
        coll_bytes=cost.coll_bytes,
        collectives=cost.coll_dict(),
        model_flops_total=model_flops(cfg, shape),
        memory_per_chip=(memory_stats or {}).get("total"),
        notes=notes,
    )
    return r.finalize()
