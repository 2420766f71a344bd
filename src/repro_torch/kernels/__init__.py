"""Hand-written CUDA kernels with their plain versions: the nine tile
kernels (``tile_linalg``, with the standalone ``matmul``) and
``flash_attention``; single-tile entry points (``ops``) and torch library
oracles (``ref``)."""

from . import flash_attention, ops, ref, tile_linalg

__all__ = ["flash_attention", "ops", "ref", "tile_linalg"]
