r"""Sinkhorn divergence between sampled measures — point-cloud backends.

Counterpart of :mod:`geomloss_tpu.models.sinkhorn_samples`:

* ``sinkhorn_tensorized``: dense cost matrices.
* ``sinkhorn_online``: implicit costs, streamed through the softmin
  operators of :mod:`..ops.softmin` (the Hopper kernels on CUDA tensors).

Cost structures are built with a *detached* second argument, and the loop
only back-propagates through the final extrapolation.
"""

from functools import partial

import torch

from ..ops.costs import cost_routines
from ..ops.softmin import (
    sinkhorn_step_points,
    softmin_dense,
    softmin_extrapolation,
    softmin_extrapolation_sym,
    softmin_points,
)
from ..solvers.annealing import scaling_parameters
from ..solvers.sinkhorn_loop import log_weights, sinkhorn_cost, sinkhorn_loop

__all__ = ["sinkhorn_tensorized", "sinkhorn_online"]


def sinkhorn_tensorized(
    a,
    x,
    b,
    y,
    p=2,
    blur=0.05,
    reach=None,
    diameter=None,
    scaling=0.5,
    cost=None,
    debias=True,
    potentials=False,
    **kwargs,
):
    """Dense Sinkhorn divergence on batched point clouds.

    Args:
        a: ``(B, N)`` weights; x: ``(B, N, D)`` points;
        b: ``(B, M)`` weights; y: ``(B, M, D)`` points.
        cost: optional callable ``(B,N,D),(B,M,D) -> (B,N,M)``.

    Returns:
        ``(B,)`` divergence values, or a pair of ``(B, N)`` / ``(B, M)``
        potentials when ``potentials=True``.
    """
    if cost is None:
        cost = cost_routines[p]

    C_xy = cost(x, y.detach())
    C_yx = cost(y, x.detach())
    C_xx = cost(x, x.detach()) if debias else None
    C_yy = cost(y, y.detach()) if debias else None

    diameter, eps, eps_list, rho = scaling_parameters(
        x, y, p, blur, reach, diameter, scaling
    )

    f_aa, g_bb, g_ab, f_ba = sinkhorn_loop(
        softmin_dense, log_weights(a), log_weights(b),
        C_xx, C_yy, C_xy, C_yx, eps_list, rho, debias=debias,
    )

    if potentials == "raw":
        return f_ba, g_ab, f_aa, g_bb
    return sinkhorn_cost(
        eps, rho, a, b, f_aa, g_bb, g_ab, f_ba,
        batch=True, debias=debias, potentials=potentials,
    )


def _unbatch(fn, *args):
    """Apply ``fn`` to each batch entry of ``(B, ...)`` arguments and stack
    (``None`` outputs stay ``None``)."""
    if args[0].ndim < 3:
        return fn(*args)
    outs = [fn(*(a[i] for a in args)) for i in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(
            None if outs[0][d] is None else torch.stack([o[d] for o in outs])
            for d in range(len(outs[0]))
        )
    return torch.stack(outs)


def sinkhorn_online(
    a,
    x,
    b,
    y,
    p=2,
    blur=0.05,
    reach=None,
    diameter=None,
    scaling=0.5,
    cost=None,
    debias=True,
    potentials=False,
    impl="auto",
    init_potentials=None,
    warm_start_iters=3,
    **kwargs,
):
    """Streaming (O(N+M) memory) Sinkhorn divergence on batched point clouds.

    Each softmin call fuses the pairwise cost with an online log-sum-exp;
    for the built-in costs, each annealing iteration reads both softmin
    directions off one pass over the absorbed Gibbs matrix.

    Warm starting: pass the raw 4-tuple ``init_potentials = (f_ba, g_ab,
    f_aa, g_bb)`` from a previous solve (``potentials="raw"``) to skip the
    annealing and run ``warm_start_iters`` iterations at the target
    temperature.
    """
    softmin = partial(softmin_points, p=p, impl=impl, cost=cost)

    if cost is None:

        def fused_step(eps, C_xy, C_yx, a_log, b_log, f, g, sym=False):
            step = partial(sinkhorn_step_points, eps, p=p, impl=impl, sym=sym)
            return _unbatch(step, C_xy[0], C_yx[0], a_log, b_log, f, g)

        def fused_last(
            eps, damping, C_xy, C_yx, C_xx, C_yy,
            a_log, b_log, f_ba, g_ab, f_aa, g_bb,
        ):
            # Gradients flow to x / y through their own direction only.
            S_xy, S_yx = _unbatch(
                lambda *t: softmin_extrapolation(*t, eps, p, impl),
                C_xy[0], C_yx[0], f_ba.detach(), g_ab.detach(),
                a_log.detach(), b_log.detach(),
            )
            f_new, g_new = damping * S_xy, damping * S_yx
            if debias:
                S_xx = _unbatch(
                    lambda *t: softmin_extrapolation_sym(*t, eps, p, impl),
                    C_xx[0], f_aa.detach(), a_log.detach(),
                )
                S_yy = _unbatch(
                    lambda *t: softmin_extrapolation_sym(*t, eps, p, impl),
                    C_yy[0], g_bb.detach(), b_log.detach(),
                )
                f_aa, g_bb = damping * S_xx, damping * S_yy
            return f_new, g_new, f_aa, g_bb

    else:
        fused_step = None
        fused_last = None

    # Center the clouds on their detached joint mean: costs are
    # translation-invariant, gradients pass through unchanged, and the
    # expansion form's score noise (relative to |x||y|) then scales with the
    # diameter instead of the distance to the origin.
    ctr = (0.5 * (x.mean(dim=-2, keepdim=True) + y.mean(dim=-2, keepdim=True))).detach()
    x, y = x - ctr, y - ctr

    C_xy, C_yx = (x, y.detach()), (y, x.detach())
    C_xx, C_yy = ((x, x.detach()), (y, y.detach())) if debias else (None, None)

    if init_potentials is not None:
        eps = blur**p
        rho = None if reach is None else reach**p
        eps_list = [eps] * warm_start_iters
        # The max-pass-free absorbed step assumes potentials from an averaged
        # update on THESE clouds; external warm-start potentials can overflow
        # exp2 when the clouds moved. The warm iterations go through the
        # max-shifted two-pass LSE instead (the differentiable extrapolation
        # stays fused: it follows an averaged update at the same eps).
        fused_step = None
    else:
        diameter, eps, eps_list, rho = scaling_parameters(
            x, y, p, blur, reach, diameter, scaling
        )

    f_aa, g_bb, g_ab, f_ba = sinkhorn_loop(
        softmin, log_weights(a), log_weights(b),
        C_xx, C_yy, C_xy, C_yx, eps_list, rho,
        debias=debias, init_potentials=init_potentials,
        fused_step=fused_step, fused_last=fused_last,
    )

    if potentials == "raw":
        return f_ba, g_ab, f_aa, g_bb
    return sinkhorn_cost(
        eps, rho, a, b, f_aa, g_bb, g_ab, f_ba,
        batch=True, debias=debias, potentials=potentials,
    )
