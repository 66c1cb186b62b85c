r"""Sinkhorn divergences between measures sampled on 1D/2D/3D grids.

Counterpart of :mod:`geomloss_tpu.models.sinkhorn_images`: a multiscale
pyramid of log-densities, epsilon-scaling with a jump to the next level
when the temperature drops below the current pixel width, the separable
softmin of :mod:`..ops.grid` (D one-dimensional matmul passes per call)
and (bi/tri)linear extrapolation between scales. ``ImagesLoss`` and
``VolumesLoss`` wrap it as ``nn.Module`` losses.
"""

from functools import partial

import torch

from ..ops.grid import log_dens, pyramid, softmin_grid, upsample
from ..solvers.annealing import scaling_parameters
from ..solvers.sinkhorn_loop import sinkhorn_cost, sinkhorn_loop

__all__ = ["sinkhorn_divergence", "ImagesLoss", "VolumesLoss"]


def _extrapolate(f_ba, g_ab, eps, damping, C_xy, b_log, C_xy_fine, D=None):
    return upsample(f_ba, D=D)


def _kernel_truncation(
    C_xy, C_yx, C_xy_fine, C_yx_fine, f_ba, g_ab, eps, truncate=None, cost=None
):
    # On grids we rely on separability instead of truncation:
    return C_xy_fine, C_yx_fine


def sinkhorn_divergence(
    a,
    b,
    p=2,
    blur=None,
    reach=None,
    axes=None,
    scaling=0.5,
    cost=None,
    debias=True,
    potentials=False,
    verbose=False,
    _return_raw_potentials=False,
    **kwargs,
):
    r"""Debiased Sinkhorn divergence between measures on 1D/2D/3D grids.

    Args:
        a, b: ``(B, Nx)``, ``(B, Nx, Ny)`` or ``(B, Nx, Ny, Nz)`` tensors of
            non-negative densities on the unit interval/square/cube.
        p: exponent of the ground cost ``|x - y|^p / p`` (1 or 2).
        blur: target blur scale; defaults to one pixel (``1 / Nx``).
        reach: unbalanced-OT scale (``rho = reach**p``), None = balanced.
        scaling: epsilon-scaling ratio in ``[0.5, 1)`` (the pyramid halves
            resolution per level, so faster schedules would skip scales).
        debias, potentials: as in :class:`~geomloss_tpu_torch.SamplesLoss`.

    Returns:
        ``(B,)`` divergence values or a pair of grid-shaped potentials;
        with ``_return_raw_potentials``, ``((f_aa, g_bb, g_ab, f_ba), eps)``.
    """
    D = a.ndim - 1  # number of grid axes

    if blur is None:
        blur = 1 / a.shape[-1]

    # Multiscale decomposition (Binary/Quad/OcTree), coarsest (2-wide) first:
    a_s, b_s = pyramid(a, D=D)[1:], pyramid(b, D=D)[1:]
    a_logs = [log_dens(m) for m in a_s]
    b_logs = [log_dens(m) for m in b_s]

    depth = len(a_logs)
    if cost is not None:
        raise NotImplementedError(
            "Custom costs are not supported on grids (the separable softmin "
            "relies on the |x-y|^p / p structure)."
        )
    C_s = [p] * depth  # the grid cost is implicit: we just pass p

    if scaling < 0.5:
        raise ValueError(
            f"Scaling value of {scaling} is too small: "
            "please use a number in [0.5, 1)."
        )

    diameter, eps, eps_list, rho = scaling_parameters(
        None, None, p, blur, reach, 1, scaling
    )

    # Jump from one pyramid level to the next when the annealing blur
    # becomes finer than the current pixel width:
    pyramid_scales = [diameter / m.shape[-1] for m in a_s]
    if verbose:
        print("Pyramid scales:", pyramid_scales)

    eps_list = list(eps_list)
    current_scale = pyramid_scales.pop(0)
    jumps = []
    for i, e in enumerate(eps_list[1:]):
        if current_scale**p > e and pyramid_scales:
            jumps.append(i + 1)
            current_scale = pyramid_scales.pop(0)

    # If the target blur is coarser than some pyramid levels, the schedule
    # above does not reach the finest scale: append extra iterations at the
    # final temperature, one per missing jump, so that the loop always ends
    # on the input resolution.
    while len(jumps) < len(a_s) - 1:
        eps_list.append(eps_list[-1])
        jumps.append(len(eps_list) - 1)

    if verbose:
        print("Temperatures: ", eps_list)
        print("Jumps: ", jumps)

    f_aa, g_bb, g_ab, f_ba = sinkhorn_loop(
        partial(softmin_grid, D=D),
        a_logs,
        b_logs,
        C_s,
        C_s,
        C_s,
        C_s,
        eps_list,
        rho,
        jumps=jumps,
        kernel_truncation=_kernel_truncation,
        extrapolate=partial(_extrapolate, D=D),
        debias=debias,
    )

    if _return_raw_potentials:
        return (f_aa, g_bb, g_ab, f_ba), eps

    return sinkhorn_cost(
        eps,
        rho,
        a,
        b,
        f_aa,
        g_bb,
        g_ab,
        f_ba,
        batch=True,
        debias=debias,
        potentials=potentials,
    )


class ImagesLoss(torch.nn.Module):
    """Sinkhorn divergence between batched 2D images, as a loss module:
    :func:`sinkhorn_divergence` with the ``SamplesLoss``-style constructor.
    Takes ``(B, N, N)`` batches or single ``(N, N)`` images."""

    _ndim = 3  # (B, Nx, Ny)

    def __init__(
        self,
        loss="sinkhorn",
        p=2,
        blur=None,
        reach=None,
        scaling=0.5,
        debias=True,
        potentials=False,
        verbose=False,
        **kwargs,
    ):
        super().__init__()
        if loss != "sinkhorn":
            raise NotImplementedError("Only loss='sinkhorn' is supported on grids.")
        self.p = p
        self.blur = blur
        self.reach = reach
        self.scaling = scaling
        self.debias = debias
        self.potentials = potentials
        self.verbose = verbose

    def _divergence(self, a, b):
        return sinkhorn_divergence(
            a,
            b,
            p=self.p,
            blur=self.blur,
            reach=self.reach,
            scaling=self.scaling,
            debias=self.debias,
            potentials=self.potentials,
            verbose=self.verbose,
        )

    def forward(self, a, b):
        if a.ndim == self._ndim - 1:  # unbatched input
            out = self._divergence(a[None], b[None])
            if self.potentials:
                return out[0][0], out[1][0]
            return out[0]
        if a.ndim != self._ndim:
            raise ValueError(
                f"Expected a {self._ndim - 1}D grid or a batched "
                f"{self._ndim}D array, received shape {tuple(a.shape)}."
            )
        return self._divergence(a, b)


class VolumesLoss(ImagesLoss):
    """Sinkhorn divergence between batched 3D volumes (see :class:`ImagesLoss`)."""

    _ndim = 4  # (B, Nx, Ny, Nz)
