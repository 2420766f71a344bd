"""LM substrate: the dense decoder family of the JAX package's ``models``
(attention layers, dense MLPs, KV cache), with the no-cache attention
through the hand-written flash kernel when ``cfg.use_pallas`` is set."""

from .convert import params_from_jax
from .model import Model, build_model, param_counts

__all__ = ["Model", "build_model", "param_counts", "params_from_jax"]
