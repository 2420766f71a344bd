"""musicgen-large [audio]: decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf:facebook/musicgen-large]

Backbone only — the EnCodec frontend is a STUB (``input_specs`` provides
precomputed 50 Hz frame embeddings, see models/frontend.py).  MusicGen uses
a vanilla transformer decoder: LayerNorm, non-gated GELU MLP, sinusoidal
positions.  Full attention -> ``long_500k`` is skipped (DESIGN.md
§Arch-applicability).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    mlp_type="gelu",
    norm_type="layernorm",
    pos_type="sinusoidal",
    frontend="audio",
)
