"""pixtral-12b [vlm]: Pixtral-ViT frontend + Mistral-Nemo decoder.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified]

Backbone only — the Pixtral ViT is a STUB (``input_specs`` provides the
fused patch+text embedding sequence, see models/frontend.py).
head_dim=128, SwiGLU, RMSNorm, RoPE theta 1M.  Full attention ->
``long_500k`` skipped.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1_000_000.0,
    frontend="vision",
)
