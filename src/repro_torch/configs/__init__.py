"""Architecture registry: the 10 assigned archs + their input-shape cells
(the JAX package's ``configs/__init__.py``)."""

from typing import Dict, List

from .base import SHAPES, ArchConfig, ShapeConfig
from .gemma3_12b import CONFIG as _gemma3
from .granite_moe_1b import CONFIG as _granite
from .llama4_maverick import CONFIG as _llama4
from .musicgen_large import CONFIG as _musicgen
from .nemotron4_340b import CONFIG as _nemotron
from .pixtral_12b import CONFIG as _pixtral
from .qwen3_32b import CONFIG as _qwen3
from .rwkv6_3b import CONFIG as _rwkv6
from .starcoder2_7b import CONFIG as _starcoder2
from .zamba2_2p7b import CONFIG as _zamba2

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (
        _musicgen,
        _rwkv6,
        _qwen3,
        _nemotron,
        _starcoder2,
        _gemma3,
        _zamba2,
        _granite,
        _llama4,
        _pixtral,
    )
}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")


def cell_supported(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention (assignment rule)."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True


def all_cells() -> List[tuple]:
    """Every supported (arch, shape) cell — 33 of the nominal 40."""
    out = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            if cell_supported(a, s):
                out.append((a, s))
    return out


__all__ = [
    "ARCHS",
    "SHAPES",
    "ArchConfig",
    "ShapeConfig",
    "all_cells",
    "cell_supported",
    "get_arch",
    "get_shape",
]
