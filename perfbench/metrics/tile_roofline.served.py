"""Roofline share of the tile kernels in the profiled stretch
(``reduce.tile_roofline``)."""

from perfbench.reduce import tile_roofline


def read(rec):
    return tile_roofline(rec)
