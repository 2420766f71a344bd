"""LM substrate: the JAX package's ``models`` — the dense decoders, MoE
(gather and dense dispatch), Mamba2 with zamba2's shared block, RWKV6 and
the stub frontends — with the no-cache attention through the hand-written
flash kernel when ``cfg.use_pallas`` is set, in a serving form (cast at
load) and a training form (fp32 masters, ``value_and_grad``)."""

from .convert import params_from_jax, to_jax, to_port
from .model import Model, build_model, cast_for_forward, param_counts

__all__ = ["Model", "build_model", "cast_for_forward", "param_counts", "params_from_jax", "to_jax", "to_port"]
