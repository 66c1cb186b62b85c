r"""Epsilon-scaling (annealing) schedules for Sinkhorn loops.

Counterpart of :mod:`geomloss_tpu.solvers.annealing`. The schedule is a
plain Python list of floats, computed before the loop starts.
"""

import math
from typing import List, Optional

import numpy as np
import torch

from ..utils import profiling
from ..utils.typing import DescentParameters

__all__ = [
    "dampening",
    "max_diameter",
    "epsilon_schedule",
    "scaling_parameters",
    "annealing_parameters",
]


def dampening(eps, rho):
    """Unbalanced-OT damping factor: 1 for balanced, 1/(1 + eps/rho) otherwise."""
    return 1.0 if rho is None else 1.0 / (1.0 + eps / rho)


def max_diameter(x, y) -> float:
    """Rough upper bound on the diameter of a pair of point clouds.

    Reads the value back to the host (``.item()``, counted as
    ``host.reads``).
    """
    mins = torch.minimum(x.min(dim=0).values, y.min(dim=0).values)
    maxs = torch.maximum(x.max(dim=0).values, y.max(dim=0).values)
    profiling.count("host.reads")
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


def annealing_parameters(
    *,
    maxmin_cost: float,
    eps: float,
    rho: Optional[float] = None,
    n_iter: Optional[int] = None,
    scaling: Optional[float] = None,
    eps_scales: Optional[List[float]] = None,
) -> DescentParameters:
    r"""Schedule of the ``ot.solve*`` loop:
    ``DescentParameters(scale_list, eps_list, rho_list)``.

    * ``n_iter`` given: a constant (``scaling=1``), geomspace
      (``scaling=None``) or geometric-with-floor schedule;
    * ``scaling`` given alone: ``floor((log eps - log maxmin) / log
      scaling) + 2`` iterations of geometric-with-floor cooling;
    * ``scale_list`` puts each iteration on the coarsest scale whose
      resolution is still finer than its temperature, the last one on the
      finest scale.
    """
    if n_iter is not None and n_iter <= 0:
        raise ValueError(
            f"The number of iterations should be >= 1. Received n_iter={n_iter}."
        )
    if scaling is not None and (scaling <= 0 or scaling > 1):
        raise ValueError(
            f"The scaling factor should be in (0,1]. Received scaling={scaling}."
        )
    if n_iter is None and scaling is None:
        raise ValueError(
            "Please specify a number of iterations using either "
            "the n_iter or scaling parameters."
        )

    maxmin_cost = max(float(maxmin_cost), eps)

    if n_iter is None:
        if scaling == 1:
            raise ValueError(
                "If n_iter is not specified, the scaling coefficient should be < 1."
            )
        n_iter = int(np.floor((np.log(eps) - np.log(maxmin_cost)) / np.log(scaling))) + 2

    if scaling == 1:
        eps_list = [eps] * n_iter
    elif scaling is None:
        eps_list = [eps] if n_iter == 1 else list(np.geomspace(maxmin_cost, eps, n_iter))
    else:
        log_eps = np.log(maxmin_cost) + np.arange(n_iter) * np.log(scaling)
        eps_list = list(np.exp(np.maximum(log_eps, np.log(eps))))

    eps_list = [float(e) for e in eps_list]
    rho_list = [rho] * len(eps_list)

    if eps_scales is None or len(eps_scales) < 2:
        scale_list = [0] * len(eps_list)
    else:
        scale_list = []
        scale = 0
        for e in eps_list:
            while scale + 1 < len(eps_scales) and e < eps_scales[scale]:
                scale += 1
            scale_list.append(scale)
        scale_list[-1] = len(eps_scales) - 1

    return DescentParameters(scale_list=scale_list, eps_list=eps_list, rho_list=rho_list)
