"""LM substrate: the JAX package's ``models`` — the dense decoders, MoE
(gather and dense dispatch), Mamba2 with zamba2's shared block, RWKV6 and
the stub frontends — with the no-cache attention through the hand-written
flash kernel when ``cfg.use_pallas`` is set."""

from .convert import params_from_jax
from .model import Model, build_model, param_counts

__all__ = ["Model", "build_model", "param_counts", "params_from_jax"]
