r"""Debiased Sinkhorn barycenters of images on 1D/2D/3D grids.

Counterpart of :mod:`geomloss_tpu.models.barycenter_images`: a pyramid of
the measures, epsilon-scaling with ``scaling_N`` steps per scale
(``sigma <- sigma * 2^(-1/scaling_N)`` with a floor at ``blur``), the
debiasing density update
``d_log <- (d_log + bar_log + softmin(d_log)/eps) / 2``, and a final
handful of ``backward_iterations`` run with autograd on so that gradients
reach the input measures and weights.
"""

import torch

from ..ops.grid import log_dens, pyramid, softmin_grid, upsample
from ..solvers.barycenters import _log_normalize
from ..solvers.barycenters import barycenter_iteration as shared_iteration
from ..utils.typing import CostMatrices

__all__ = ["ImagesBarycenter", "barycenter_iteration"]


def barycenter_iteration(f_k, g_k, d_log, eps, p, ak_log, w_k, D=2):
    """One symmetric barycenter iteration on a grid: the library's shared
    iteration (:func:`..solvers.barycenters.barycenter_iteration`) with the
    implicit separable grid cost ``(p, D)`` and the grid softmin.

    Shapes: f_k, g_k, ak_log are ``(B, K, *grid)``; d_log is
    ``(B, 1, *grid)``; w_k is ``(B, K)``; ``D`` is the number of grid axes.
    """
    desc = (p, D)
    C = CostMatrices(xy=desc, yx=desc, xx=desc)

    def softmin(eps, C_, h):
        return softmin_grid(eps, C_[0], h, D=C_[1])

    return shared_iteration(
        softmin=softmin, f_k=f_k, g_k=g_k, log_d=d_log, eps=eps, C=C,
        log_b_k=ak_log, w_k=w_k,
    )


def ImagesBarycenter(measures, weights, blur=0, p=2, scaling_N=10, backward_iterations=5):
    """Debiased Sinkhorn barycenter of K grid measures.

    Args:
        measures: ``(B, K, N, N)`` batch of K normalized densities (also
            1D ``(B, K, N)`` and 3D ``(B, K, N, N, N)`` grids).
        weights: ``(B, K)`` barycentric weights.
        blur: target blur; 0 means one pixel (``1/N``).
        p: cost exponent (2 for halved squared Euclidean).
        scaling_N: number of epsilon-scaling steps per pyramid scale.
        backward_iterations: extra iterations run *with* gradient tracking
            at the finest scale (the envelope-theorem shortcut).

    Returns:
        ``(B, 1, *grid)`` barycenter densities.
    """
    a_k, w_k = measures, weights
    D = a_k.ndim - 2  # number of grid axes

    if blur == 0:
        blur = 1 / measures.shape[-1]

    # --- No-grad multiscale descent -------------------------------------------
    with torch.no_grad():
        ak_s = pyramid(a_k.detach(), D=D)[1:]  # drop the 1-wide level
        ak_log_s = [log_dens(m) for m in ak_s]
        w_k_d = w_k.detach()

        sigma = 1.0
        eps = sigma**p

        f_k = softmin_grid(eps, p, ak_log_s[0], D=D)
        g_k = softmin_grid(eps, p, ak_log_s[0], D=D)

        # Logarithm of the debiasing term: uniform density on the coarsest grid.
        d_log = _log_normalize(torch.ones_like(ak_log_s[0]).sum(dim=1, keepdim=True))

        for n, ak_log in enumerate(ak_log_s):
            for _ in range(scaling_N):
                eps = sigma**p
                f_k, g_k, d_log, bar_log = barycenter_iteration(
                    f_k, g_k, d_log, eps, p, ak_log, w_k_d, D=D
                )
                sigma = max(sigma * 2 ** (-1 / scaling_N), blur)

            if n + 1 < len(ak_s):
                f_k = upsample(f_k, D=D)
                g_k = upsample(g_k, D=D)
                d_log = upsample(d_log, D=D)

    # --- Differentiable tail ---------------------------------------------------
    if backward_iterations > 0:
        ak_log = log_dens(a_k)  # finest scale, with gradients
        for _ in range(backward_iterations):
            f_k, g_k, d_log, bar_log = barycenter_iteration(
                f_k, g_k, d_log, eps, p, ak_log, w_k, D=D
            )

    return torch.exp(bar_log)
