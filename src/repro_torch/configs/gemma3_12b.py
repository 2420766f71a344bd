"""gemma3-12b [dense]: 5:1 local:global attention, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf:google/gemma-3-12b-pt (family config per google/gemma-3-1b-pt); unverified]

head_dim=256, gated-GELU, RMSNorm, qk-norm, tied embeddings with
sqrt(d_model) embedding scale.  Pattern LLLLLG (window 1024 locals, global
every 6th layer); local layers use rope theta 10k, globals 1M.
5/6 of layers are sub-quadratic and decode cost is linear -> ``long_500k``
RUNS (global layers keep a sequence-sharded cache; with
``windowed_cache=True`` local layers keep only a 1024-slot cache).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    mlp_type="geglu",
    qk_norm=True,
    tie_embeddings=True,
    embed_scale=True,
    local_per_global=5,
    local_window=1024,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    subquadratic=True,
)
