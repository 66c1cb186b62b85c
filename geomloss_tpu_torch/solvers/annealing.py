r"""Epsilon-scaling (annealing) schedules for Sinkhorn loops.

Counterpart of :mod:`geomloss_tpu.solvers.annealing`. The schedule is a
plain Python list of floats, computed before the loop starts.
"""

import math
from typing import List

import numpy as np
import torch

__all__ = [
    "dampening",
    "max_diameter",
    "epsilon_schedule",
    "scaling_parameters",
]


def dampening(eps, rho):
    """Unbalanced-OT damping factor: 1 for balanced, 1/(1 + eps/rho) otherwise."""
    return 1.0 if rho is None else 1.0 / (1.0 + eps / rho)


def max_diameter(x, y) -> float:
    """Rough upper bound on the diameter of a pair of point clouds.

    Reads the value back to the host (``.item()``).
    """
    mins = torch.minimum(x.min(dim=0).values, y.min(dim=0).values)
    maxs = torch.maximum(x.max(dim=0).values, y.max(dim=0).values)
    return float(torch.linalg.norm(maxs - mins).item())


def epsilon_schedule(p, diameter, blur, scaling) -> List[float]:
    r"""Geometric cooling schedule from ``diameter**p`` down to ``blur**p``:
    ``[diameter**p] + exp(arange(p log diameter, p log blur, p log scaling))
    + [blur**p]``."""
    return (
        [diameter**p]
        + [
            float(np.exp(e))
            for e in np.arange(
                p * math.log(diameter), p * math.log(blur), p * math.log(scaling)
            )
        ]
        + [blur**p]
    )


def scaling_parameters(x, y, p, blur, reach, diameter, scaling):
    """High-level arguments -> (diameter, eps, eps_list, rho)."""
    if diameter is None:
        D = x.shape[-1]
        with torch.no_grad():
            diameter = max_diameter(x.reshape(-1, D), y.reshape(-1, D))
    eps = blur**p
    rho = None if reach is None else reach**p
    eps_list = epsilon_schedule(p, diameter, blur, scaling)
    return diameter, eps, eps_list, rho
