r"""The symmetric Sinkhorn loop with epsilon-scaling — solver core.

Counterpart of :mod:`geomloss_tpu.solvers.sinkhorn_loop`. The annealing
schedule is a Python list; the iterations run as a Python loop under
``torch.no_grad()`` (the envelope theorem: no autograd through the loop),
followed by one differentiable last extrapolation with detached duals.
Multiscale jumps (the grid path) are Python-level events between
iterations, with truncation and extrapolation hooks. The multiscale
backend of ``SamplesLoss`` runs its own loop (``models/multiscale.py``).
"""

from typing import Callable, Optional, Sequence

import torch

from ..utils import profiling
from .annealing import dampening

__all__ = [
    "log_weights",
    "unbalanced_weight",
    "scal",
    "sinkhorn_cost",
    "sinkhorn_loop",
]


def log_weights(a):
    """log(a) with zero/negative weights clamped to -100000."""
    return torch.where(
        a > 0, torch.log(torch.clamp(a, min=1e-30)), torch.full_like(a, -100000.0)
    )


def scal(a, f, batch=False):
    """Weighted sum <a, f>."""
    if batch:
        B = a.shape[0]
        return (a.reshape(B, -1) * f.reshape(B, -1)).sum(-1)
    return torch.dot(a.reshape(-1), f.reshape(-1))


class _ScaleFwBw(torch.autograd.Function):
    """Multiply by ``fw`` in the forward pass and by ``bw`` in the backward."""

    @staticmethod
    def forward(ctx, x, fw, bw):
        ctx.bw = bw
        return fw * x

    @staticmethod
    def backward(ctx, g):
        return ctx.bw * g, None, None


def unbalanced_weight(x, *, eps, rho, mode="reference"):
    r"""Scaling of exponentiated potentials in the unbalanced Sinkhorn cost.

    ``mode="reference"`` (default) scales by ``rho + eps/2`` in both
    directions, the reference's effective behaviour; ``mode="sejourne"``
    scales by ``rho + eps/2`` forward and ``rho + eps`` backward
    (Sejourne et al., arXiv:1910.12958, Prop. 12).
    """
    if mode == "reference":
        return (rho + eps / 2) * x
    if mode == "sejourne":
        return _ScaleFwBw.apply(x, rho + eps / 2, rho + eps)
    raise ValueError(f"Unknown unbalanced_weight mode: {mode!r}")


def sinkhorn_cost(
    eps,
    rho,
    a,
    b,
    f_aa,
    g_bb,
    g_ab,
    f_ba,
    batch=False,
    debias=True,
    potentials=False,
    unbalanced_mode="reference",
):
    r"""Combine dual potentials into the Sinkhorn divergence value: the four
    cases {debiased, biased} x {balanced, unbalanced}, plus the
    ``potentials`` early exit."""
    if potentials:
        if debias:
            return f_ba - f_aa, g_ab - g_bb
        return f_ba, g_ab

    def uw(v):
        return unbalanced_weight(v, eps=eps, rho=rho, mode=unbalanced_mode)

    if debias:
        if rho is None:
            return scal(a, f_ba - f_aa, batch=batch) + scal(
                b, g_ab - g_bb, batch=batch
            )
        return scal(
            a, uw(torch.exp(-f_aa / rho) - torch.exp(-f_ba / rho)), batch=batch
        ) + scal(
            b, uw(torch.exp(-g_bb / rho) - torch.exp(-g_ab / rho)), batch=batch
        )
    if rho is None:
        return scal(a, f_ba, batch=batch) + scal(b, g_ab, batch=batch)
    return scal(a, uw(1 - torch.exp(-f_ba / rho)), batch=batch) + scal(
        b, uw(1 - torch.exp(-g_ab / rho)), batch=batch
    )


def _detach(C):
    """``C`` with every tensor detached: tuples keep their type (a
    ``CostMatrices`` stays one), ``None`` and other leaves pass through."""
    if isinstance(C, torch.Tensor):
        return C.detach()
    if isinstance(C, tuple):
        detached = (_detach(c) for c in C)
        return type(C)(*detached) if hasattr(C, "_fields") else tuple(detached)
    return C


def sinkhorn_loop(
    softmin: Callable,
    a_logs,
    b_logs,
    C_xxs,
    C_yys,
    C_xys,
    C_yxs,
    eps_list: Sequence[float],
    rho: Optional[float],
    jumps: Sequence[int] = (),
    kernel_truncation: Optional[Callable] = None,
    truncate: float = 5,
    cost=None,
    extrapolate: Optional[Callable] = None,
    debias: bool = True,
    last_extrapolation: bool = True,
    init_potentials=None,
    fused_step: Optional[Callable] = None,
    fused_last: Optional[Callable] = None,
):
    r"""(Possibly multiscale) symmetric Sinkhorn loop with annealing.

    Returns the four optimal dual potentials ``(f_aa, g_bb, g_ab, f_ba)``
    (``None`` for the first two when ``debias=False``). Gradients only flow
    through the final extrapolation.

    The log weights and costs are per-scale lists, coarsest first (a bare
    tensor or cost is one scale). Iteration ``jumps[i]`` runs at scale
    ``i`` and is followed by a jump to scale ``i + 1``:
    ``kernel_truncation(C_xy, C_yx, C_xy_fine, C_yx_fine, f_ba, g_ab, eps,
    truncate=, cost=)`` gives the fine costs (for ``xy``, ``xx`` and
    ``yy``), then ``extrapolate(f_ba, g_ab, eps, damping, C_xy, b_log,
    C_xy_fine)`` carries each potential to the fine scale, all four from
    the previous iterates. A jump at the last iteration extrapolates with
    autograd on, from the attached coarse log weights onto the attached fine
    costs, and takes the place of the last extrapolation.

    ``softmin(eps, C, h)`` is the softmin of the backend. ``fused_step(eps,
    C_ab, C_ba, a_log, b_log, f, g, sym=False)``, when given, replaces the
    2 or 4 softmin calls of each iteration (and of the eps0 initialization)
    by fused updates returning both raw softmin directions at once (one
    direction, ``(S, None)``, when ``sym=True``). ``fused_last(eps,
    damping, C_xy, C_yx, C_xx, C_yy, a_log, b_log, f_ba, g_ab, f_aa, g_bb)``
    replaces the differentiable last extrapolation.

    ``init_potentials`` warm-starts the loop with a ``(f_ba, g_ab[, f_aa,
    g_bb])`` tuple from a previous solve.
    """
    if not isinstance(a_logs, list):
        a_logs, b_logs = [a_logs], [b_logs]
        C_xys, C_yxs = [C_xys], [C_yxs]
        if debias:
            C_xxs, C_yys = [C_xxs], [C_yys]

    Nits = len(eps_list)
    jumps = sorted(j for j in jumps if 0 <= j < Nits)

    with torch.no_grad(), profiling.span("solver.eps_loop"):
        a_logs_d = [v.detach() for v in a_logs]
        b_logs_d = [v.detach() for v in b_logs]
        C_xys_d = [_detach(C) for C in C_xys]
        C_yxs_d = [_detach(C) for C in C_yxs]
        C_xxs_d = [_detach(C) for C in C_xxs] if debias else None
        C_yys_d = [_detach(C) for C in C_yys] if debias else None

        k = 0  # scale index
        a_log_d, b_log_d = a_logs_d[0], b_logs_d[0]
        C_xy_d, C_yx_d = C_xys_d[0], C_yxs_d[0]
        C_xx_d, C_yy_d = (C_xxs_d[0], C_yys_d[0]) if debias else (None, None)

        eps = eps_list[0]
        damping = dampening(eps, rho)

        # --- Initialization --------------------------------------------------
        if init_potentials is not None:
            init = [v.detach() for v in init_potentials]
            f_ba, g_ab = init[0], init[1]
            if debias:
                f_aa, g_bb = init[2], init[3]
        elif fused_step is not None:
            # The eps0 initialization is the fused step at zero potentials:
            zf, zg = torch.zeros_like(a_log_d), torch.zeros_like(b_log_d)
            S_xy, S_yx = fused_step(eps, C_xy_d, C_yx_d, a_log_d, b_log_d, zf, zg)
            f_ba, g_ab = damping * S_xy, damping * S_yx
            if debias:
                f_aa = damping * fused_step(
                    eps, C_xx_d, C_xx_d, a_log_d, a_log_d, zf, zf, sym=True
                )[0]
                g_bb = damping * fused_step(
                    eps, C_yy_d, C_yy_d, b_log_d, b_log_d, zg, zg, sym=True
                )[0]
        else:
            g_ab = damping * softmin(eps, C_yx_d, a_log_d)
            f_ba = damping * softmin(eps, C_xy_d, b_log_d)
            if debias:
                f_aa = damping * softmin(eps, C_xx_d, a_log_d)
                g_bb = damping * softmin(eps, C_yy_d, b_log_d)
        if not debias:
            f_aa, g_bb = torch.zeros_like(f_ba), torch.zeros_like(g_ab)

        # --- Main descent: Jacobi-style updates, then averaging --------------
        for it, eps in enumerate(eps_list):
            damp = dampening(eps, rho)
            with profiling.span("solver.eps_step"):
                if fused_step is not None:
                    S_xy, S_yx = fused_step(
                        eps, C_xy_d, C_yx_d, a_log_d, b_log_d, f_ba, g_ab
                    )
                    ft_ba, gt_ab = damp * S_xy, damp * S_yx
                    if debias:
                        ft_aa = damp * fused_step(
                            eps, C_xx_d, C_xx_d, a_log_d, a_log_d, f_aa, f_aa, sym=True
                        )[0]
                        gt_bb = damp * fused_step(
                            eps, C_yy_d, C_yy_d, b_log_d, b_log_d, g_bb, g_bb, sym=True
                        )[0]
                else:
                    ft_ba = damp * softmin(eps, C_xy_d, b_log_d + g_ab / eps)
                    gt_ab = damp * softmin(eps, C_yx_d, a_log_d + f_ba / eps)
                    if debias:
                        ft_aa = damp * softmin(eps, C_xx_d, a_log_d + f_aa / eps)
                        gt_bb = damp * softmin(eps, C_yy_d, b_log_d + g_bb / eps)
                f_ba = 0.5 * (f_ba + ft_ba)
                g_ab = 0.5 * (g_ab + gt_ab)
                if debias:
                    f_aa = 0.5 * (f_aa + ft_aa)
                    g_bb = 0.5 * (g_bb + gt_bb)

            if it not in jumps:
                continue
            # --- Jump to the next scale ---------------------------------------
            if it == Nits - 1:
                # Extrapolate with autograd on, from the attached coarse log
                # weights onto the attached fine costs, and skip the last
                # extrapolation:
                with torch.enable_grad():
                    f_ba, g_ab, f_aa, g_bb = _extrapolate_all(
                        extrapolate, eps, damp, debias, f_ba, g_ab, f_aa, g_bb,
                        (C_xy_d, C_yx_d, C_xx_d, C_yy_d), a_logs[k], b_logs[k],
                        (C_xys[k + 1], C_yxs[k + 1],
                         C_xxs[k + 1] if debias else None, C_yys[k + 1] if debias else None),
                    )
                last_extrapolation = False
            else:
                C_xy_f, C_yx_f = kernel_truncation(
                    C_xy_d, C_yx_d, C_xys_d[k + 1], C_yxs_d[k + 1], f_ba, g_ab, eps,
                    truncate=truncate, cost=cost,
                )
                C_xx_f = C_yy_f = None
                if debias:
                    C_xx_f, _ = kernel_truncation(
                        C_xx_d, C_xx_d, C_xxs_d[k + 1], C_xxs_d[k + 1], f_aa, f_aa, eps,
                        truncate=truncate, cost=cost,
                    )
                    C_yy_f, _ = kernel_truncation(
                        C_yy_d, C_yy_d, C_yys_d[k + 1], C_yys_d[k + 1], g_bb, g_bb, eps,
                        truncate=truncate, cost=cost,
                    )
                f_ba, g_ab, f_aa, g_bb = _extrapolate_all(
                    extrapolate, eps, damp, debias, f_ba, g_ab, f_aa, g_bb,
                    (C_xy_d, C_yx_d, C_xx_d, C_yy_d), a_log_d, b_log_d,
                    (C_xy_f, C_yx_f, C_xx_f, C_yy_f),
                )
                C_xy_d, C_yx_d, C_xx_d, C_yy_d = C_xy_f, C_yx_f, C_xx_f, C_yy_f
            k += 1
            a_log_d, b_log_d = a_logs_d[k], b_logs_d[k]

    # After the loop, the temperature is the final schedule value:
    eps = eps_list[-1]
    damping = dampening(eps, rho)

    # --- Differentiable last extrapolation ----------------------------------
    if last_extrapolation:
        with profiling.span("solver.last_extrapolation"):
            a_log, b_log = a_logs[k], b_logs[k]
            C_xy, C_yx = C_xys[k], C_yxs[k]
            C_xx, C_yy = (C_xxs[k], C_yys[k]) if debias else (None, None)
            if fused_last is not None:
                f_ba, g_ab, f_aa, g_bb = fused_last(
                    eps, damping, C_xy, C_yx, C_xx, C_yy, a_log, b_log,
                    f_ba, g_ab, f_aa, g_bb,
                )
            else:
                f_ba, g_ab = (
                    damping * softmin(eps, C_xy, (b_log + g_ab / eps).detach()),
                    damping * softmin(eps, C_yx, (a_log + f_ba / eps).detach()),
                )
                if debias:
                    f_aa = damping * softmin(eps, C_xx, (a_log + f_aa / eps).detach())
                    g_bb = damping * softmin(eps, C_yy, (b_log + g_bb / eps).detach())

    if debias:
        return f_aa, g_bb, g_ab, f_ba
    return None, None, g_ab, f_ba


def _extrapolate_all(extrapolate, eps, damping, debias, f_ba, g_ab, f_aa, g_bb, C, a_log, b_log, C_fine):
    """The four potentials of a jump carried to the fine scale, each from
    the previous iterates (the cross terms in parallel)."""
    C_xy, C_yx, C_xx, C_yy = C
    C_xy_f, C_yx_f, C_xx_f, C_yy_f = C_fine
    f_new = extrapolate(f_ba, g_ab, eps, damping, C_xy, b_log, C_xy_f)
    g_new = extrapolate(g_ab, f_ba, eps, damping, C_yx, a_log, C_yx_f)
    if debias:
        f_aa = extrapolate(f_aa, f_aa, eps, damping, C_xx, a_log, C_xx_f)
        g_bb = extrapolate(g_bb, g_bb, eps, damping, C_yy, b_log, C_yy_f)
    return f_new, g_new, f_aa, g_bb
