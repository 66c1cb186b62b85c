"""Typed containers, numpy interop, validation, caching and profiling."""

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
