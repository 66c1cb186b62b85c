"""Annealing schedules, the Sinkhorn loops and the barycenter loop."""

from .annealing import (
    annealing_parameters,
    dampening,
    epsilon_schedule,
    max_diameter,
    scaling_parameters,
)
from .barycenters import barycenter_iteration, sinkhorn_barycenter_loop
from .sinkhorn_loop import (
    log_weights,
    scal,
    sinkhorn_cost,
    sinkhorn_loop,
    unbalanced_weight,
)
from .sinkhorn_ot import sinkhorn_initialization
from .sinkhorn_ot import sinkhorn_loop as sinkhorn_loop_ot
from .unbalanced import dot_products
from .unbalanced import sinkhorn_cost as sinkhorn_cost_ot

__all__ = [
    "annealing_parameters",
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
    "sinkhorn_loop_ot",
    "sinkhorn_initialization",
    "sinkhorn_cost_ot",
    "dot_products",
]
