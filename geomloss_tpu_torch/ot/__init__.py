"""``geomloss_tpu_torch.ot``: POT-compatible optimal transport solvers.

Counterpart of :mod:`geomloss_tpu.ot`: ``solve`` / ``solve_batch`` on
explicit cost matrices, ``solve_sample`` / ``solve_sample_batch`` on point
clouds (streaming above 5000 x 5000 cost entries: kernel 1 for every
softmin, kernel 4 for the result's lazy plan), ``solve_grid`` on images
and volumes (with the ``axes`` / ``periodic`` geometry), the Wasserstein
barycenter solvers ``barycenter`` (fixed support), ``barycenter_sample``
(free support) and ``barycenter_grid``, and the lazily cached
``OTResult`` family with ``LinearOperator`` plans.
"""

from .result import LinearOperator, OTResult
from .sample_impl import (
    OTResultSample,
    barycenter_sample,
    solve_sample,
    solve_sample_batch,
)
from .solve_matrix import OTResultMatrix, barycenter, solve, solve_batch


def __getattr__(name):
    if name in ("solve_grid", "barycenter_grid", "OTResultGrid"):
        from . import grid_impl

        return getattr(grid_impl, name)
    raise AttributeError(f"module 'geomloss_tpu_torch.ot' has no attribute {name!r}")


__all__ = [
    "LinearOperator",
    "OTResult",
    "OTResultMatrix",
    "OTResultSample",
    "solve",
    "solve_batch",
    "solve_sample",
    "solve_sample_batch",
    "solve_grid",
    "barycenter",
    "barycenter_sample",
    "barycenter_grid",
]
