"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention block.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B]

54 Mamba2 layers (expand 2, head dim P=64 -> 80 SSM heads, state N=64,
conv 4); ONE shared attention+MLP block (32-head MHA, d_ff 10240, GELU)
applied after every 6 Mamba layers — the weights are shared across all 9
invocations (the zamba2 parameter-sharing trick).  Simplification noted in
DESIGN.md: the shared-block input is the residual stream x (the published
model concatenates the original embeddings and applies a per-invocation
LoRA).  O(1) SSM decode state -> ``long_500k`` RUNS (the shared block's KV
cache is the only sequence-length state).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    mlp_type="gelu",
    ssm_state=64,
    ssm_heads=80,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=128,
    hybrid_attn_every=6,
    subquadratic=True,
)
