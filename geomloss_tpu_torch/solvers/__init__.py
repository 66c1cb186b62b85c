"""Annealing schedules, the Sinkhorn loop and the barycenter loop."""

from .annealing import dampening, epsilon_schedule, max_diameter, scaling_parameters
from .barycenters import barycenter_iteration, sinkhorn_barycenter_loop
from .sinkhorn_loop import (
    log_weights,
    scal,
    sinkhorn_cost,
    sinkhorn_loop,
    unbalanced_weight,
)

__all__ = [
    "dampening",
    "epsilon_schedule",
    "max_diameter",
    "scaling_parameters",
    "barycenter_iteration",
    "sinkhorn_barycenter_loop",
    "log_weights",
    "scal",
    "sinkhorn_cost",
    "sinkhorn_loop",
    "unbalanced_weight",
]
