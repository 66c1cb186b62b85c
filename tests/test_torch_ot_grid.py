"""The port's ``ot.solve_grid`` and ``ot.barycenter_grid`` against the
JAX package, in float64.

``solve_grid`` on its pyramid route (16^2 and 8^3, p in {1, 2}, balanced
and unbalanced, debias on and off) and on its flat route with ``axes=`` /
``periodic=`` (bounds, a torus, explicit per-axis coordinates; 1D and
16^2): the value, the potentials, the marginals, and the density and plan
operators on signed inputs with channels (the pos/neg split) within
1e-10, the value's gradient in both densities within 1e-8; and
``barycenter_grid`` at 16^2 (the barycenter and its gradient in the
weights), against the same calls of the JAX package under ``jax.jit``
(``torch_jax_parity``). At these sizes the JAX package's grid softmin is
exact (ROADMAP, the grid caveat).
"""

import numpy as np
import pytest
import torch

from geomloss_tpu import ot as jax_ot
from geomloss_tpu_torch import ot
from torch_jax_parity import assert_solve_parity

RTOL, GRAD_RTOL = 1e-10, 1e-8


def densities(shape, seed, floor=0.05):
    """Positive densities (a floor plus Gaussian bumps) on the unit grid,
    normalized per batch entry."""
    rng = np.random.RandomState(seed)
    grid = shape[1:]
    axes = np.meshgrid(*[(np.arange(n) + 0.5) / n for n in grid], indexing="ij")
    out = np.full(shape, floor)
    for i in range(shape[0]):
        for _ in range(2):
            c, s = 0.2 + 0.6 * rng.rand(len(grid)), 0.1 + 0.1 * rng.rand()
            out[i] += rng.rand() * np.exp(-sum((x - ci) ** 2 for x, ci in zip(axes, c)) / (2 * s**2))
    return out / out.reshape(shape[0], -1).sum(-1).reshape((shape[0],) + (1,) * len(grid))


def attrs(res, V, U):
    """Value, potentials, marginals, then the density operator on the
    signed ``V`` (grid shape plus channels) and the plan's transpose on
    ``U`` (grid shape)."""
    out = (res.value, res.potential_a, res.potential_b, res.marginal_a, res.marginal_b)
    if res._debias:
        out += (res.potential_aa, res.potential_bb)
    return out + (res.density_operator @ V, res.plan_operator.T @ U)


PYRAMID_CASES = {
    "p=2": dict(p=2),
    "p=1 blur=0.1": dict(cost="other", p=1, blur=0.1),
    "p=2 reach=0.5 no debias": dict(p=2, reach=0.5, debias=False),
    "reg and unbalanced": dict(reg=0.01, unbalanced=0.25),
}

AXES_CASES = {
    "bounds": dict(axes=(0.0, 2.0), blur=0.1, scaling=0.7),
    "torus on one axis": dict(axes=((0.0, 1.0), (-1.0, 1.0)), periodic=(True, False), blur=0.1),
    "coordinates": dict(axes=(np.linspace(0.0, 1.0, 16) ** 1.5, (0.0, 1.0)), blur=0.1, debias=False),
    "p=1 reach": dict(cost="other", p=1, axes=(0.0, 1.0), reach=0.5, blur=0.1),
}


def _check(shape, kw, seed, jit=True):
    a, b = densities(shape, seed), densities(shape, seed + 1)
    rng = np.random.RandomState(seed + 2)
    V, U = rng.randn(*shape, 2), rng.randn(*shape)
    res = assert_solve_parity(
        lambda a, b, V, U: attrs(jax_ot.solve_grid(a, b, **kw), V, U),
        lambda a, b, V, U: attrs(ot.solve_grid(a, b, **kw), V, U),
        [a, b, V, U], rtol=RTOL, jit=jit,
    )
    assert res[0].shape == (shape[0],) and res[-2].shape == shape + (2,)
    assert_solve_parity(
        lambda a, b: jax_ot.solve_grid(a, b, **kw).value,
        lambda a, b: ot.solve_grid(a, b, **kw).value,
        [a, b], rtol=RTOL, grad_rtol=GRAD_RTOL, argnums=(0, 1), jit=jit,
    )


@pytest.mark.parametrize("case", sorted(PYRAMID_CASES))
def test_solve_grid_pyramid_matches_jax(case):
    _check((2, 16, 16), PYRAMID_CASES[case], 10 * len(case))


def test_solve_grid_pyramid_3d_matches_jax():
    _check((1, 8, 8, 8), dict(blur=0.2), 3)


@pytest.mark.parametrize("case", sorted(AXES_CASES))
def test_solve_grid_axes_matches_jax(case):
    """Explicit coordinates run the JAX call eagerly: it reads their span
    as a float (the schedule's length depends on it)."""
    _check((2, 16, 16), AXES_CASES[case], 10 * len(case) + 1, jit=case != "coordinates")


def test_solve_grid_axes_1d_matches_jax():
    _check((3, 40), dict(axes=(-1.0, 2.0), periodic=True, blur=0.2, scaling=0.7), 5)


def test_barycenter_grid_matches_jax():
    """Three measures of 16^2, the barycenter and its gradient in the
    weights."""
    m = densities((3, 16, 16), 7)[None]
    w = np.array([[0.2, 0.5, 0.3]])
    kw = dict(scaling_N=2)
    bar = assert_solve_parity(
        lambda m, w: jax_ot.barycenter_grid(m, w, **kw), lambda m, w: ot.barycenter_grid(m, w, **kw),
        [m, w], rtol=RTOL, grad_rtol=GRAD_RTOL, argnums=(1,),
    )
    assert bar.shape == (1, 16, 16)
    # Default weights: uniform.
    got = ot.barycenter_grid(torch.tensor(m), scaling_N=2, backward_iterations=1)
    ref = ot.barycenter_grid(torch.tensor(m), torch.full((1, 3), 1 / 3, dtype=torch.float64), scaling_N=2,
                             backward_iterations=1)
    assert torch.equal(got, ref)
