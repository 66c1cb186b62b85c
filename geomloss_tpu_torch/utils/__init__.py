"""Typed containers and numpy interop."""

from .interop import from_numpy, tile_mask_from_numpy, to_numpy
from .typing import CostMatrices, DescentParameters, SinkhornPotentials

__all__ = [
    "CostMatrices",
    "DescentParameters",
    "SinkhornPotentials",
    "from_numpy",
    "tile_mask_from_numpy",
    "to_numpy",
]
