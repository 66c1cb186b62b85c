"""Costs, softmin operators, block-sparse truncation and their kernels,
clustering and grid operators."""

from .block_sparse import (
    TileMask,
    build_tile_masks,
    gibbs_apply_sparse,
    lse_sparse,
    softmin_sparse,
)
from .clustering import cluster_ranges_centroids, clusterize, grid_cluster
from .costs import SQDIST_FLOOR, cost_routines, distances, halved_sqdist, squared_distances
from .grid import C_transform, log_dens, pyramid, softmin_grid, upsample
from .softmin import (
    gibbs_apply,
    gibbs_matvec,
    lse_points,
    lse_points_custom,
    sinkhorn_step_points,
    softmin_dense,
    softmin_extrapolation,
    softmin_extrapolation_sym,
    softmin_points,
)

__all__ = [
    "SQDIST_FLOOR",
    "cost_routines",
    "distances",
    "halved_sqdist",
    "squared_distances",
    "gibbs_apply",
    "gibbs_matvec",
    "lse_points",
    "lse_points_custom",
    "sinkhorn_step_points",
    "softmin_dense",
    "softmin_extrapolation",
    "softmin_extrapolation_sym",
    "softmin_points",
    "TileMask",
    "build_tile_masks",
    "gibbs_apply_sparse",
    "lse_sparse",
    "softmin_sparse",
    "grid_cluster",
    "cluster_ranges_centroids",
    "clusterize",
    "log_dens",
    "pyramid",
    "upsample",
    "softmin_grid",
    "C_transform",
]
