"""rwkv6-3b [ssm]: RWKV-6 "Finch" — attention-free, data-dependent decay.

32L d_model=2560 (attn-free) d_ff=8960 vocab=65536
[arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b]

Head size 64 -> 40 heads.  O(1) decode state (wkv state + token-shift
carries), so ``long_500k`` RUNS.  n_heads/n_kv recorded for bookkeeping
only (no attention layers).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    norm_type="layernorm",
    pos_type="none",
    rwkv_head_size=64,
    # Q=16 hillclimbed (§Perf cell C): the (B,Q,Q,H,K) pairwise tensor's
    # HBM traffic scales with Q; compute stays recurrence-dominated.
    rwkv_chunk=16,
    subquadratic=True,
)
