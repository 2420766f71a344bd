"""llama4-maverick-400b-a17b [moe]: 128 experts top-1 + shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4-Maverick-17B-128E (shapes per Llama-4-Scout-17B-16E);
unverified]

head_dim=128, SwiGLU, RMSNorm.  Llama-4 interleaves: every other layer is
routed (top-1 of 128 experts + always-on shared expert), the rest dense.
"Early fusion" is the VLM frontend — backbone only here.  The 400B total /
17B active split is the EP stress test of the pool.  Full attention ->
``long_500k`` skipped.
"""

import torch

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    rope_theta=500_000.0,
    n_experts=128,
    top_k=1,
    moe_interleave=2,
    shared_expert=True,
    optim_state_dtype=torch.bfloat16,
)
