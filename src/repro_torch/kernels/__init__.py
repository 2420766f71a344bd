"""Hand-written CUDA tile kernels (``tile_linalg``) with their plain
versions, single-tile entry points (``ops``) and torch library oracles
(``ref``)."""

from . import ops, ref, tile_linalg

__all__ = ["ops", "ref", "tile_linalg"]
