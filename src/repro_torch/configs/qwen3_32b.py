"""qwen3-32b [dense]: GQA + per-head qk-norm.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936
[hf:Qwen/Qwen3-32B (family config per hf:Qwen/Qwen3-8B); hf]

head_dim=128, SwiGLU, RMSNorm, RoPE theta 1M, untied embeddings.
Full attention -> ``long_500k`` skipped.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
