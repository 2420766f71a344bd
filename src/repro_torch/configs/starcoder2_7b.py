"""starcoder2-7b [dense]: GQA + RoPE code model.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152
[arXiv:2402.19173; hf:bigcode/starcoder2-7b]

head_dim=128, non-gated GELU MLP, LayerNorm, RoPE theta 1e5.
Full attention -> ``long_500k`` skipped.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv=4,
    head_dim=128,
    d_ff=18432,
    vocab=49152,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_theta=100_000.0,
)
