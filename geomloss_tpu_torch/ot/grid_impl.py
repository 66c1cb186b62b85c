r"""``ot.solve_grid`` / ``ot.barycenter_grid``: OT on 1D/2D/3D grids.

Counterpart of :mod:`geomloss_tpu.ot.grid_impl`:

* ``solve_grid`` runs the multiscale grid solver of
  :func:`geomloss_tpu_torch.models.sinkhorn_images.sinkhorn_divergence`
  (or, with ``axes=`` / ``periodic=``, a flat annealed loop on explicit
  axis coordinates) and returns an ``OTResultGrid`` whose density and plan
  operators apply the separable Gibbs kernel in the log domain (no
  ``(prod N)^2`` matrix);
* ``barycenter_grid`` wraps
  :func:`geomloss_tpu_torch.models.barycenter_images.ImagesBarycenter`.

The domain is the unit cube with cell-centred coordinates per axis and the
ground cost is ``|x - y|^p / p`` (separable: Euclidean for p = 2,
Manhattan for p = 1). No kernel of the port is on this path.
"""

import math

import torch

from ..models.sinkhorn_images import sinkhorn_divergence
from ..ops.grid import log_dens, softmin_grid, softmin_grid_coords
from ..solvers.annealing import scaling_parameters
from ..solvers.sinkhorn_loop import sinkhorn_cost as legacy_sinkhorn_cost
from ..solvers.sinkhorn_loop import sinkhorn_loop
from ..utils.cache import lazy_properties
from ..utils.typing import SinkhornPotentials
from ..utils.validation import ArrayProperties, convert_inputs
from .result import LinearOperator, OTResult

__all__ = ["solve_grid", "barycenter_grid", "OTResultGrid"]


def _log_apply(eps, p, log_v, g_over_eps, D, coords=None, periods=None):
    """log sum_j exp(log_v_j + g_j/eps - C_ij/eps), separably."""
    if coords is not None:
        out = softmin_grid_coords(eps, p, log_v + g_over_eps, coords, periods, D=D)
    else:
        out = softmin_grid(eps, p, log_v + g_over_eps, D=D)
    return -out / eps


def _parse_axes(axes, periodic, grid_shape, dtype, device):
    """Normalize the ``axes`` / ``periodic`` forms into per-axis coordinate
    tensors, periods, maximum distances and cell widths.

    A length-2 Python list / tuple of scalars is ALWAYS read as
    ``[vmin, vmax)`` bounds: pass a tensor or array to mean two explicit
    coordinates on a 2-cell axis.

    Returns:
        ``(coords, periods, extents, pixels)`` where ``extents[d]`` is
        the largest distance along axis ``d`` (half the period on a torus)
        and ``pixels[d]`` the cell width.
    """
    D = len(grid_shape)

    def centers(n, vmin, vmax):
        return vmin + (torch.arange(n, dtype=dtype, device=device) + 0.5) / n * (vmax - vmin)

    # periodic -> D-tuple of bools:
    if isinstance(periodic, bool) or periodic is None:
        periodic = (bool(periodic),) * D
    periodic = tuple(bool(t) for t in periodic)
    if len(periodic) != D:
        raise ValueError(f"Expected {D} periodic flags; got {len(periodic)}.")

    # axes -> per-axis (coords, extent):
    def is_pair(v):
        return (
            isinstance(v, (tuple, list))
            and len(v) == 2
            and all(isinstance(t, (int, float)) for t in v)
        )

    if axes is None:
        per_axis = [(0.0, 1.0)] * D
    elif is_pair(axes):
        per_axis = [tuple(axes)] * D
    elif isinstance(axes, (tuple, list)) and len(axes) == D:
        per_axis = list(axes)
    else:
        raise ValueError(
            "axes must be a [vmin, vmax) pair, a D-uple of pairs, or a "
            f"D-uple of coordinate arrays; got {axes!r}."
        )

    coords, periods, extents, pixels = [], [], [], []
    for d, (spec, n, per) in enumerate(zip(per_axis, grid_shape, periodic)):
        if is_pair(spec):
            vmin, vmax = float(spec[0]), float(spec[1])
            coords.append(centers(n, vmin, vmax))
            L = vmax - vmin
            pixels.append(L / n)
            if not per:
                # Largest distance = the span of the cell centres, not the
                # interval length (as the explicit-coordinates form reads
                # the same points):
                L = L * (n - 1) / n
        else:
            c = torch.as_tensor(spec, dtype=dtype, device=device)
            if c.ndim != 1 or c.shape[0] != n:
                raise NotImplementedError(
                    "Per-axis coordinates must be (N_d,) arrays (per-batch "
                    f"coordinates are not supported); axis {d} got shape "
                    f"{tuple(c.shape)} for N_d={n}."
                )
            coords.append(c)
            if per:
                raise ValueError(
                    "A periodic axis needs [vmin, vmax) bounds (the period "
                    "cannot be inferred from explicit coordinates)."
                )
            L = float((c.max() - c.min()).item())
            pixels.append(L / max(n - 1, 1))
        periods.append(L if per else None)
        extents.append(L / 2 if per else L)
    return tuple(coords), tuple(periods), extents, pixels


def _solve_grid_coords(
    a, b, p, blur, reach, scaling, debias, coords, periods, extents, pixels
):
    """Flat (single-scale) annealed symmetric Sinkhorn on a grid with
    explicit axis coordinates / periodicity."""
    if not (0.5 <= scaling < 1):
        raise ValueError(
            "Scaling value of 'solve_grid' should be in [0.5, 1); "
            f"received {scaling}."
        )
    D = a.ndim - 1
    diameter = math.sqrt(sum(e**2 for e in extents)) if p == 2 else sum(extents)
    if blur is None:
        # Default: one pixel (the coarsest axis).
        blur = max(pixels)
    diameter, eps, eps_list, rho = scaling_parameters(
        None, None, p, blur, reach, diameter, scaling
    )

    def softmin(e, C, h):
        return softmin_grid_coords(e, p, h, coords, periods, D=D)

    f_aa, g_bb, g_ab, f_ba = sinkhorn_loop(
        softmin, log_dens(a), log_dens(b), p, p, p, p, list(eps_list), rho, debias=debias,
    )
    return (f_aa, g_bb, g_ab, f_ba), eps


@lazy_properties
class OTResultGrid(OTResult):
    """Result of an OT problem between grid measures.

    ``density_operator`` applies the transport-plan density through
    separable log-domain convolutions: memory stays linear in the grid
    size even though the implicit plan has ``(prod N)^2`` entries.
    """

    def __init__(
        self, *, a, b, p, reg, unbalanced, debias, potentials,
        array_properties, coords=None, periods=None,
    ):
        super().__init__(
            a=a,
            b=b,
            potentials=potentials,
            array_properties=array_properties,
            batchsize=array_properties.B,
            reg=reg,
            reg_type="KL",
            unbalanced=unbalanced,
            unbalanced_type="KL",
            debias=debias,
        )
        self._p = p
        self._coords = coords
        self._periods = periods
        self._D = a.ndim - 1
        grid_shape = tuple(a.shape[1:])
        B = array_properties.B
        self._shapes = {
            "a": (B,) + grid_shape,
            "b": (B,) + grid_shape,
            "B": (B,),
        }

    _cached_properties = (
        "potential_a",
        "potential_b",
        "potential_aa",
        "potential_bb",
        "density_operator",
        "plan_operator",
        "value",
        "marginal_a",
        "marginal_b",
        "citation",
    )

    def _value(self):
        """Sinkhorn cost from the dual potentials (grid convention:
        eps = blur**p, cost |x-y|^p / p)."""
        pots = self._potentials
        return legacy_sinkhorn_cost(
            self._reg,
            self._unbalanced,
            self._a,
            self._b,
            pots.f_aa,
            pots.g_bb,
            pots.g_ab,
            pots.f_ba,
            batch=True,
            debias=self._debias,
        )

    def _density_operator(self):
        """Separable, log-domain application of the plan density
        exp((f + g - C)/eps). Signed inputs go through a pos/neg split; the
        channels are folded into the batch axis."""
        eps, p, D = self._reg, self._p, self._D
        f = self._potentials.f_ba
        g = self._potentials.g_ab
        coords, periods = self._coords, self._periods

        def apply_one_sign(v, g_pot, f_pot):  # v: (V, B, *grid)
            log_v = torch.where(v > 0, torch.log(torch.clamp(v, min=1e-30)), torch.full_like(v, -1e4))
            lse = _log_apply(eps, p, log_v, g_pot / eps, D, coords, periods)
            return torch.exp(f_pot / eps + lse)

        def apply(s, g_pot, f_pot):  # s: (B, *grid, V)
            v = s.movedim(-1, 0)
            pos = apply_one_sign(torch.clamp(v, min=0.0), g_pot, f_pot)
            neg = apply_one_sign(torch.clamp(-v, min=0.0), g_pot, f_pot)
            return (pos - neg).movedim(0, -1)

        return LinearOperator.from_streaming(
            matmat=lambda s: apply(s, g, f),
            rmatmat=lambda s: apply(s, f, g),
            input_shape=self._shapes["b"],
            output_shape=self._shapes["a"],
        )


@convert_inputs("a", "b")
def solve_grid(
    a=None,
    b=None,
    cost="sqeuclidean",
    axes=None,
    periodic=False,
    p=None,
    blur=None,
    reach=None,
    reg=None,
    unbalanced=None,
    debias=True,
    scaling=0.5,
    method="auto",
    max_iter=None,
    tol=None,
) -> OTResultGrid:
    r"""Solves an OT problem between measures sampled on a common grid.

    Args:
        a, b: ``(B, Nx[, Ny[, Nz]])`` non-negative densities on the unit
            cube (a batch axis is required).
        cost / p: ``"sqeuclidean"`` (p=2, cost |x-y|^2/2 separable) or p=1
            (separable Manhattan cost).
        axes: ``[vmin, vmax)`` bounds, a D-uple of them, or a D-uple of
            ``(N_d,)`` coordinate arrays.
        periodic: a bool or a D-uple of bools (torus axes).
        blur: geometric regularization shortcut, ``reg = blur**p`` (the
            grid convention, unlike ``solve_sample``'s ``p * blur**p``).
        reach: unbalanced shortcut, ``unbalanced = reach**p``.
        scaling: epsilon-annealing ratio in [0.5, 1).

    Returns:
        :class:`OTResultGrid` with lazily computed ``value``,
        ``potential_a/b``, ``marginal_a/b`` and separable
        ``density_operator`` / ``plan_operator``.
    """
    if a is None or b is None:
        raise ValueError("solve_grid requires both 'a' and 'b' densities.")
    if cost == "sqeuclidean":
        p = 2 if p is None else p
    if p not in (1, 2):
        raise NotImplementedError("Only p = 1 or 2 are supported on grids.")

    if reg is not None:
        if blur is not None:
            raise ValueError(
                "Parameters 'reg' and 'blur' are redundant. "
                "Please specify only one of them."
            )
        blur = reg ** (1.0 / p)
    if unbalanced is not None:
        if reach is not None:
            raise ValueError(
                "Parameters 'unbalanced' and 'reach' are redundant. "
                "Please specify only one of them."
            )
        reach = unbalanced ** (1.0 / p)

    D = a.ndim - 1
    if D not in (1, 2, 3):
        raise ValueError(
            "Expected batched grids (B, Nx[, Ny[, Nz]]); "
            f"received an array of shape {tuple(a.shape)}."
        )
    if a.shape != b.shape:
        raise ValueError(
            f"'a' and 'b' should live on the same grid; received {tuple(a.shape)} "
            f"and {tuple(b.shape)}."
        )

    use_coords = axes is not None or (periodic not in (False, None))
    if use_coords:
        # Explicit axis coordinates / [vmin, vmax) bounds and per-axis
        # periodic (torus) boundaries, on a flat annealed loop.
        coords, periods, extents, pixels = _parse_axes(axes, periodic, a.shape[1:], a.dtype, a.device)
        (f_aa, g_bb, g_ab, f_ba), reg_val = _solve_grid_coords(
            a, b, p, blur, reach, scaling, debias, coords, periods, extents, pixels,
        )
    else:
        coords = periods = None
        (f_aa, g_bb, g_ab, f_ba), reg_val = sinkhorn_divergence(
            a,
            b,
            p=p,
            blur=blur,
            reach=reach,
            scaling=scaling,
            debias=debias,
            _return_raw_potentials=True,
        )
    rho = None if reach is None else reach**p

    array_properties = ArrayProperties(
        B=a.shape[0],
        N=math.prod(a.shape[1:]),
        M=math.prod(b.shape[1:]),
        dtype=a.dtype,
        device=str(a.device),
        library="torch",
    )

    return OTResultGrid(
        a=a,
        b=b,
        p=p,
        reg=reg_val,
        unbalanced=rho,
        debias=debias,
        potentials=SinkhornPotentials(f_aa=f_aa, g_bb=g_bb, g_ab=g_ab, f_ba=f_ba),
        array_properties=array_properties,
        coords=coords,
        periods=periods,
    )


@convert_inputs("a", "weights")
def barycenter_grid(
    a=None,
    weights=None,
    blur=0,
    p=2,
    scaling_N=10,
    backward_iterations=5,
    **kwargs,
):
    """Debiased Sinkhorn barycenter of measures on a 1D/2D/3D grid, by the
    multiscale barycenter loop of
    :func:`geomloss_tpu_torch.models.barycenter_images.ImagesBarycenter`.

    Args:
        a: ``(B, K, Nx[, Ny[, Nz]])`` batch of K densities per problem
            (1D signals, 2D images or 3D volumes).
        weights: ``(B, K)`` barycentric weights.

    Returns:
        ``(B, Nx[, Ny[, Nz]])`` tensor of barycenter masses.
    """
    from ..models.barycenter_images import ImagesBarycenter

    if a is None:
        raise ValueError("barycenter_grid requires the densities 'a'.")
    if a.ndim not in (3, 4, 5):
        raise ValueError(
            "barycenter_grid expects (B, K, Nx[, Ny[, Nz]]) densities; "
            f"received shape {tuple(a.shape)}."
        )
    if weights is None:
        B, K = a.shape[:2]
        weights = torch.full((B, K), 1.0 / K, dtype=a.dtype, device=a.device)

    bar = ImagesBarycenter(
        a,
        weights,
        blur=blur,
        p=p,
        scaling_N=scaling_N,
        backward_iterations=backward_iterations,
    )
    return bar[:, 0]
