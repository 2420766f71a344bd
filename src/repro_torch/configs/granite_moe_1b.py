"""granite-moe-1b-a400m [moe]: 32 fine-grained experts, top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]

head_dim=64, expert d_ff=512 (fine-grained), every layer routed, SwiGLU,
RMSNorm, tied embeddings.  Full attention -> ``long_500k`` skipped.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    tie_embeddings=True,
    rope_theta=10_000.0,
    n_experts=32,
    top_k=8,
    moe_interleave=1,
)
