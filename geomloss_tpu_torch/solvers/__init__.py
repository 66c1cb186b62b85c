"""Annealing schedules and the Sinkhorn loop."""

from .annealing import dampening, epsilon_schedule, max_diameter, scaling_parameters
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
    "log_weights",
    "scal",
    "sinkhorn_cost",
    "sinkhorn_loop",
    "unbalanced_weight",
]
