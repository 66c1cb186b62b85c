r"""The Sinkhorn loop of the ``ot.solve*`` API.

Counterpart of :mod:`geomloss_tpu.solvers.sinkhorn_ot`. Compared with the
loop of ``SamplesLoss`` (:mod:`.sinkhorn_loop`), the softmin separates log
weights from dual potentials — ``softmin(eps, log_b, C, g)`` — the
schedule is a :class:`~geomloss_tpu_torch.utils.typing.DescentParameters`
driven by ``scale_list``, and the initialization is an
:math:`\varepsilon = \infty` softmin with a symmetric constant offset.

The descent runs as a Python loop under ``torch.no_grad()`` on detached
inputs, scale by scale, then one differentiable extrapolation at the end
(the envelope theorem).
"""

from typing import Any, Callable, List, Optional

import torch

from ..utils.typing import CostMatrices, DescentParameters, SinkhornPotentials
from .annealing import dampening as scalar_dampening
from .sinkhorn_loop import _detach
from .unbalanced import dampening, dot_products

__all__ = ["sinkhorn_initialization", "sinkhorn_loop"]


def sinkhorn_initialization(log_a, log_b, C_xy, softmin, dampen):
    """Optimal solution at eps = +infinity, with a symmetric constant offset.

    The first axis of ``log_a`` is the batch axis of the dot product: for
    unbatched ``(N,)`` inputs the offset is pointwise, as in the JAX
    package.
    """
    f_ba = softmin(float("inf"), log_b, C_xy, 0 * log_b)
    constant_offset = 0.5 * dot_products(torch.exp(log_a), f_ba)
    f_ba = f_ba - constant_offset.reshape((-1,) + (1,) * (f_ba.ndim - 1))
    return dampen(f_ba)


def _segments(scale_list):
    """``(lo, hi)`` bounds of the runs of constant scale."""
    bounds = [0] + [i for i in range(1, len(scale_list)) if scale_list[i] != scale_list[i - 1]]
    return list(zip(bounds, bounds[1:] + [len(scale_list)]))


def sinkhorn_loop(
    *,
    softmin: Callable,
    log_a_list: List[Any],
    log_b_list: List[Any],
    C_list: List[CostMatrices],
    descent: DescentParameters,
    kernel_truncation: Optional[Callable] = None,
    extrapolate: Optional[Callable] = None,
    debias: bool = True,
    last_extrapolation: bool = True,
) -> SinkhornPotentials:
    """Symmetric Sinkhorn loop with annealing and (optional) multiscale jumps.

    ``descent`` holds Python lists. Between two scales,
    ``kernel_truncation(C=, CT=, C_fine=, CT_fine=, f=, g=, eps=)`` (when
    given) prunes the fine costs and ``extrapolate(self=, other=,
    log_weights=, C=, C_fine=, eps=, dampen=)`` carries each potential to
    the fine scale. Gradients only flow through the final extrapolation,
    through ``C_list[scale]``; log weights and duals are detached there.
    """
    eps_list = list(descent.eps_list)
    rho_list = list(descent.rho_list)
    scale_list = list(descent.scale_list)
    n_iter = len(eps_list)
    assert len(rho_list) == n_iter and len(scale_list) == n_iter

    with torch.no_grad():
        log_a_list_d = [_detach(v) for v in log_a_list]
        log_b_list_d = [_detach(v) for v in log_b_list]
        C_list_d = [_detach(v) for v in C_list]

        scale = scale_list[0]
        dampen = dampening(eps=eps_list[0], rho=rho_list[0])
        log_a, log_b, C = log_a_list_d[scale], log_b_list_d[scale], C_list_d[scale]

        # --- Initialization at eps = +infty ---------------------------------------
        f_ba = sinkhorn_initialization(log_a, log_b, C.xy, softmin, dampen)
        g_ab = sinkhorn_initialization(log_b, log_a, C.yx, softmin, dampen)
        if debias:
            f_aa = sinkhorn_initialization(log_a, log_a, C.xx, softmin, dampen)
            g_bb = sinkhorn_initialization(log_b, log_b, C.yy, softmin, dampen)
        else:
            f_aa, g_bb = torch.zeros_like(f_ba), torch.zeros_like(g_ab)

        segments = _segments(scale_list)
        for s_idx, (lo, hi) in enumerate(segments):
            scale = scale_list[lo]
            log_a, log_b = log_a_list_d[scale], log_b_list_d[scale]
            for i in range(lo, hi):
                e, d = eps_list[i], scalar_dampening(eps_list[i], rho_list[i])
                ft_ba = d * softmin(e, log_b, C.xy, g_ab)
                gt_ab = d * softmin(e, log_a, C.yx, f_ba)
                if debias:
                    ft_aa = d * softmin(e, log_a, C.xx, f_aa)
                    gt_bb = d * softmin(e, log_b, C.yy, g_bb)
                f_ba, g_ab = 0.5 * (f_ba + ft_ba), 0.5 * (g_ab + gt_ab)
                if debias:
                    f_aa, g_bb = 0.5 * (f_aa + ft_aa), 0.5 * (g_bb + gt_bb)

            if s_idx == len(segments) - 1:
                break

            # --- Jump to the next scale -----------------------------------------
            # Every segment but the last ends before the last iteration, so
            # a jump never replaces the last extrapolation.
            eps, rho = eps_list[hi - 1], rho_list[hi - 1]
            dampen = dampening(eps=eps, rho=rho)
            C_fine = C_list_d[scale_list[hi]]
            if kernel_truncation is not None:
                C_fine_xy, C_fine_yx = kernel_truncation(
                    C=C.xy, CT=C.yx, C_fine=C_fine.xy, CT_fine=C_fine.yx,
                    f=f_ba, g=g_ab, eps=eps,
                )
                C_fine_xx = C_fine_yy = None
                if debias:
                    C_fine_xx, _ = kernel_truncation(C=C.xx, C_fine=C_fine.xx, f=f_aa, eps=eps)
                    C_fine_yy, _ = kernel_truncation(C=C.yy, C_fine=C_fine.yy, f=g_bb, eps=eps)
                C_fine = CostMatrices(xy=C_fine_xy, yx=C_fine_yx, xx=C_fine_xx, yy=C_fine_yy)

            f_ba, g_ab = (
                extrapolate(self=f_ba, other=g_ab, log_weights=log_b, C=C.xy, C_fine=C_fine.xy,
                            eps=eps, dampen=dampen),
                extrapolate(self=g_ab, other=f_ba, log_weights=log_a, C=C.yx, C_fine=C_fine.yx,
                            eps=eps, dampen=dampen),
            )
            if debias:
                f_aa = extrapolate(self=f_aa, other=f_aa, log_weights=log_a, C=C.xx, C_fine=C_fine.xx,
                                   eps=eps, dampen=dampen)
                g_bb = extrapolate(self=g_bb, other=g_bb, log_weights=log_b, C=C.yy, C_fine=C_fine.yy,
                                   eps=eps, dampen=dampen)
            C = C_fine

    # Final temperature and damping:
    eps = eps_list[-1]
    dampen = dampening(eps=eps, rho=rho_list[-1])
    scale = scale_list[-1]

    if last_extrapolation:
        log_a_g, log_b_g = _detach(log_a_list[scale]), _detach(log_b_list[scale])
        C_g = C_list[scale]
        f_ba, g_ab = (
            dampen(softmin(eps, log_b_g, C_g.xy, g_ab.detach())),
            dampen(softmin(eps, log_a_g, C_g.yx, f_ba.detach())),
        )
        if debias:
            f_aa = dampen(softmin(eps, log_a_g, C_g.xx, f_aa.detach()))
            g_bb = dampen(softmin(eps, log_b_g, C_g.yy, g_bb.detach()))

    if not debias:
        f_aa, g_bb = None, None

    return SinkhornPotentials(f_aa=f_aa, g_bb=g_bb, g_ab=g_ab, f_ba=f_ba)
