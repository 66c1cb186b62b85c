r"""(Multiscale) Sinkhorn loop for debiased Wasserstein barycenters.

Counterpart of :mod:`geomloss_tpu.solvers.barycenters`: batched solution of
``argmin_A sum_k w_k * S_eps(A, B_k)`` on a fixed support, with the
Janati-Cuturi-Gramfort debiasing density and epsilon-scaling across
scales. The iterations run under ``torch.no_grad()``; a final
``backward_iterations`` tail runs with autograd on (the envelope
shortcut), so gradients reach the measures and the weights.
"""

from typing import Any, Callable, List, Optional

import torch

from ..utils.typing import CostMatrices, DescentParameters
from .sinkhorn_loop import _detach

__all__ = ["barycenter_iteration", "sinkhorn_barycenter_loop"]


def _log_normalize(v):
    """``v - logsumexp(v)`` over every axis after the first two."""
    dims = tuple(range(2, v.ndim))
    return v - torch.logsumexp(v, dim=dims, keepdim=True)


def barycenter_iteration(*, softmin, f_k, g_k, log_d, eps, C, log_b_k, w_k):
    """One symmetric Sinkhorn iteration for the barycenter problem.

    The matrix, grid (``ImagesBarycenter``) and abstract front ends all
    call it with their own ``softmin`` adapter and cost descriptor ``C``
    (a :class:`~geomloss_tpu_torch.utils.typing.CostMatrices`).

    Shapes: ``f_k, g_k, log_b_k`` are ``(B, K, ...)``; ``log_d`` is
    ``(B, 1, ...)``; ``w_k`` is ``(B, K)``.

    When ``C.xx is None`` the debiasing density is not updated and the
    barycenter is instead gauge-pinned to the simplex (the potentials'
    free additive constant otherwise leaves the mass unnormalized).
    """

    def pseudo_step(g_k):
        # From the measures to the barycenter:
        ft_k = softmin(eps, C.xy, log_b_k + g_k / eps)  # (B, K, ...)
        log_bar = log_d - torch.einsum("bk...,bk->b...", ft_k, w_k)[:, None, ...] / eps
        if C.xx is None:
            log_bar = _log_normalize(log_bar)
        return ft_k, log_bar

    ft_k, log_bar = pseudo_step(g_k)

    # Symmetric Sinkhorn updates:
    gt_k = softmin(eps, C.yx, log_bar + f_k / eps)
    f_k = (f_k + ft_k) / 2
    g_k = (g_k + gt_k) / 2

    # Pseudo-step with the updated potentials:
    _, log_bar = pseudo_step(g_k)

    if C.xx is not None:
        # Update the de-biasing measure (Janati et al.'s correction):
        log_d = 0.5 * (log_d + log_bar + softmin(eps, C.xx, log_d) / eps)

    return f_k, g_k, log_d, log_bar


def sinkhorn_barycenter_loop(
    *,
    softmin: Callable,
    log_b_k_list: List[Any],
    w_k,
    C_list: List[CostMatrices],
    descent: DescentParameters,
    extrapolate: Optional[Callable] = None,
    backward_iterations: int = 5,
):
    """Multiscale symmetric Sinkhorn loop for debiased barycenters.

    ``descent.scale_list[i]`` is the scale (an index into ``log_b_k_list``
    and ``C_list``) of iteration i at temperature ``descent.eps_list[i]``.
    Between two scales, ``extrapolate(self=, other=, log_weights=, C=,
    C_fine=, eps=, dampen=None)`` carries ``f_k``, ``g_k`` and ``log_d`` to
    the next one.

    Returns the ``(B, 1, ...)`` barycenter masses at the finest scale.
    """
    eps_list = list(descent.eps_list)
    scale_list = list(descent.scale_list)
    n_iter = len(eps_list)

    with torch.no_grad():
        log_b_k_list_d = [_detach(m) for m in log_b_k_list]
        w_k_d = w_k.detach()

        log_b_k = log_b_k_list_d[scale_list[0]]
        C = C_list[scale_list[0]]
        eps = eps_list[0]

        f_k = softmin(eps, C.xy, log_b_k)
        g_k = softmin(eps, C.yx, log_b_k)

        log_d = _log_normalize(torch.ones_like(log_b_k).sum(dim=1, keepdim=True))  # (B, 1, ...)
        log_bar = log_d

        # Constant-scale segments:
        bounds = [0] + [i for i in range(1, n_iter) if scale_list[i] != scale_list[i - 1]] + [n_iter]
        for s_idx, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            log_b_k = log_b_k_list_d[scale_list[lo]]
            C = C_list[scale_list[lo]]
            for i in range(lo, hi):
                f_k, g_k, log_d, log_bar = barycenter_iteration(
                    softmin=softmin, f_k=f_k, g_k=g_k, log_d=log_d,
                    eps=eps_list[i], C=C, log_b_k=log_b_k, w_k=w_k_d,
                )
            if s_idx == len(bounds) - 2:
                break

            # Jump to the next scale:
            eps = eps_list[hi - 1]
            C_fine = C_list[scale_list[hi]]
            f_k = extrapolate(
                self=f_k, other=g_k, log_weights=log_b_k,
                C=C.xy, C_fine=C_fine.xy, eps=eps, dampen=None,
            )
            g_k = extrapolate(
                self=g_k, other=f_k, log_weights=log_bar,
                C=C.yx, C_fine=C_fine.yx, eps=eps, dampen=None,
            )
            log_d = extrapolate(
                self=log_d, other=0 * log_d, log_weights=log_d,
                C=C.xx, C_fine=C_fine.xx, eps=eps, dampen=None,
            )

    # Differentiable tail:
    eps = eps_list[-1]
    scale = scale_list[-1]
    C = C_list[scale]
    for _ in range(backward_iterations):
        f_k, g_k, log_d, log_bar = barycenter_iteration(
            softmin=softmin, f_k=f_k, g_k=g_k, log_d=log_d,
            eps=eps, C=C, log_b_k=log_b_k_list[scale], w_k=w_k,
        )

    return torch.exp(log_bar)
