"""Architecture + run configuration schema (the JAX package's
``configs/base.py``, field for field, with torch dtypes).

One ``ArchConfig`` instance per assigned architecture lives in
``configs/<id>.py`` with the exact published numbers; ``reduced()`` derives
the CPU smoke-test variant (same family, tiny dims).

``remat`` (``models/transformer.py``) and ``microbatches``
(``launch/steps.py``) steer the port's training step as the reference's;
``fsdp`` its placement over a mesh (``launch/sharding.py``);
``seq_parallel`` splits the residual stream on seq over ``model`` where S
divides it (``models/spmd.py``).  The layer-scan and layout-anchor knobs
(``anchor_*``, ``cast_in_scan``, ``cast_params``, ``scan_layers``,
``windowed_cache``) steer the JAX package's compiled programs; they are
kept so both packages read the same configuration, and have no effect in
the port, which casts as ``models/model.py`` says.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'rwkv' | 'hybrid' | 'audio' | 'vlm'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"  # 'swiglu' | 'relu2' | 'geglu' | 'gelu'
    norm_type: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-6
    pos_type: str = "rope"  # 'rope' | 'sinusoidal' | 'none'
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    rope_theta_local: float = 10_000.0  # sliding-window layers (gemma3)
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scale
    loss_chunk: int = 512  # chunked cross-entropy sequence-chunk length
    attn_q_chunk: int = 1024  # flash-style query-chunk for the no-cache path
    score_dtype: str = "f32"  # attention score/softmax dtype: 'f32' | 'bf16'
    seq_parallel: bool = True
    anchor_attn: bool = False
    anchor_params: bool = False
    cast_in_scan: bool = False
    anchor_cast: bool = False
    cast_params: bool = True
    # attention pattern: 0 = all-global; else (local_per_global, window)
    local_per_global: int = 0
    local_window: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_interleave: int = 1  # 1 = every layer routed; 2 = alternate dense/MoE
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_dispatch: str = "gather"  # 'gather' (scatter/gather) | 'dense' (one-hot einsum)
    moe_aux_weight: float = 0.01
    # SSM (Mamba2) / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 64
    hybrid_attn_every: int = 0  # zamba2: shared attn+mlp block every k ssm layers
    # RWKV6
    rwkv_head_size: int = 64
    rwkv_chunk: int = 32
    # modality frontend stub: None | 'audio' | 'vision'
    frontend: Optional[str] = None
    # numerics / execution
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    optim_state_dtype: Any = torch.float32
    remat: str = "full"  # 'none' | 'full' | 'dots'
    scan_layers: bool = True
    use_pallas: bool = False  # no-cache attention through the flash kernel
    fsdp: bool = True
    microbatches: int = 1
    cache_dtype: Any = torch.bfloat16
    windowed_cache: bool = False
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False

    # -- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def attn_window(self, layer: int) -> int:
        """Sliding window for layer (0 = global).  gemma3: 5 local : 1 global."""
        if self.local_per_global <= 0:
            return 0
        return 0 if (layer % (self.local_per_global + 1)) == self.local_per_global else self.local_window

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (same group layout
        family, group size shrunk so 4-layer stacks stay divisible)."""
        hd = 16
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(n_heads, self.n_kv if self.n_kv < self.n_heads else n_heads))
        lpg = 1 if self.local_per_global > 0 else 0  # 1 local : 1 global
        group = max(
            1,
            2 if self.hybrid_attn_every else 0,
            lpg + 1 if lpg else 0,
            self.moe_interleave if self.is_moe else 0,
        )
        layers = 2 * group
        return replace(
            self,
            n_layers=layers,
            d_model=n_heads * hd,
            n_heads=n_heads,
            n_kv=n_kv,
            head_dim=hd,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.is_moe else 0,
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=4 if self.ssm_heads else 0,
            ssm_chunk=8,
            rwkv_head_size=16,
            rwkv_chunk=8,
            local_per_global=lpg,
            local_window=16 if self.local_window else 0,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            loss_chunk=32,
            compute_dtype=torch.float32,
            cache_dtype=torch.float32,
            remat="none",
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
