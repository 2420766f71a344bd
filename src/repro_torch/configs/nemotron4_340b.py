"""nemotron-4-340b [dense]: GQA + squared-ReLU MLP.

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000
[arXiv:2402.16819 (Nemotron-4); unverified]

head_dim=192, squared-ReLU (non-gated) MLP, LayerNorm, RoPE theta 10k.
The memory/collective stress test of the pool: 340B params demand FSDP
over the full data axis and bf16 optimizer moments (DESIGN.md §8).
Full attention -> ``long_500k`` skipped.
"""

import torch

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    mlp_type="relu2",
    norm_type="layernorm",
    rope_theta=10_000.0,
    optim_state_dtype=torch.bfloat16,  # 2x HBM saving on m/v at 340B
    # microbatching REFUTED for fit (§Perf): per-microbatch grad reductions
    # scale collective time ~m x; 340B single-pod training runs multi-pod
    # (FSDP over ("pod","data")) instead — see EXPERIMENTS §Dry-run.
)
