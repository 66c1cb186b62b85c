"""The port's barycenters against the JAX package, in float64.

``ImagesBarycenter`` with K = 2 measures in D = 1, 2 and 3 (16, 16^2,
8^3), and ``sinkhorn_barycenter_loop`` on one scale (the grid softmin,
a debiasing density) and on two scales of dense 1D costs with
``CostMatrices(xx=None)`` (the simplex gauge): the barycenter and its
gradients in the measures and the weights, within 1e-9
(``torch_jax_parity``). Inputs are numpy arrays from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.scipy.special import logsumexp as jlse

from geomloss_tpu import ImagesBarycenter as JaxBarycenter
from geomloss_tpu.ops.grid import log_dens as jax_log_dens
from geomloss_tpu.ops.grid import softmin_grid as jax_softmin_grid
from geomloss_tpu.solvers.barycenters import sinkhorn_barycenter_loop as jax_loop
from geomloss_tpu.utils.typing import CostMatrices as JaxCostMatrices
from geomloss_tpu.utils.typing import DescentParameters as JaxDescent
from geomloss_tpu_torch import ImagesBarycenter
from geomloss_tpu_torch.ops.grid import log_dens, softmin_grid
from geomloss_tpu_torch.solvers.barycenters import sinkhorn_barycenter_loop
from geomloss_tpu_torch.utils.typing import CostMatrices, DescentParameters
from torch_jax_parity import assert_solve_parity

RTOL = 1e-9


def bumps(shape, seed):
    """K Gaussian bumps per batch entry on the unit grid, normalized."""
    rng = np.random.RandomState(seed)
    grid = shape[2:]
    axes = np.meshgrid(*[np.arange(n) / n for n in grid], indexing="ij")
    out = np.empty(shape)
    for idx in np.ndindex(*shape[:2]):
        c, s = 0.2 + 0.6 * rng.rand(len(grid)), 0.08 + 0.08 * rng.rand()
        out[idx] = np.exp(-sum((x - ci) ** 2 for x, ci in zip(axes, c)) / (2 * s**2)) + 1e-4
    return out / out.reshape(*shape[:2], -1).sum(-1).reshape(shape[:2] + (1,) * len(grid))


@pytest.mark.parametrize("shape", [(1, 2, 16), (1, 2, 16, 16), (1, 2, 8, 8, 8)])
def test_images_barycenter_matches_jax(shape):
    """Three epsilon-scaling steps a scale (``scaling_N=3``; the default 10
    only lengthens the schedule) and the default five differentiable
    iterations."""
    m = bumps(shape, len(shape))
    w = np.array([[0.3, 0.7]])
    kw = dict(scaling_N=3)
    bar = assert_solve_parity(
        lambda m, w: JaxBarycenter(m, w, **kw), lambda m, w: ImagesBarycenter(m, w, **kw),
        [m, w], rtol=RTOL, argnums=(0, 1),
    )
    assert bar.shape == (1, 1) + shape[2:]


def _loop_inputs(seed, n_fine=16):
    rng = np.random.RandomState(seed)
    x = (np.arange(n_fine) + 0.5) / n_fine
    b = np.stack([np.exp(-((x - c) ** 2) / (2 * 0.1**2)) + 1e-3 for c in (0.3, 0.7)])[None]
    b = b * (1 + 0.2 * rng.rand(*b.shape))
    return b / b.sum(-1, keepdims=True), np.array([[0.4, 0.6]])


PACKAGES = {
    "jax": (jnp, jlse, jnp.repeat, jax_loop, JaxCostMatrices, JaxDescent, jax_log_dens, jax_softmin_grid),
    "torch": (torch, torch.logsumexp, torch.repeat_interleave, sinkhorn_barycenter_loop, CostMatrices,
              DescentParameters, log_dens, softmin_grid),
}
EPS = [1.0, 0.3, 0.1, 0.03, 0.01, 0.01]


def _single_scale(pkg, b, w):
    """One scale of the grid softmin (D = 1) with a debiasing density."""
    xp, _, _, loop, Costs, Descent, log_d, softmin = PACKAGES[pkg]
    n = len(EPS)
    return loop(
        softmin=lambda eps, p, h: softmin(eps, p, h, D=1), log_b_k_list=[log_d(b)], w_k=w,
        C_list=[Costs(xy=2, yx=2, xx=2)], descent=Descent([0] * n, EPS, [None] * n), backward_iterations=3,
    )


def _two_scales(pkg, b, w):
    """Dense costs ``|x-y|^2 / 2`` on a coarse 1D grid of 8 cells and the
    fine one of 16, no debiasing density (``xx=None``: the barycenter is
    gauge-pinned to the simplex); nearest-neighbour extrapolation."""
    xp, lse, repeat, loop, Costs, Descent, _, _ = PACKAGES[pkg]
    xs = [(xp.arange(n, dtype=b.dtype) + 0.5) / n for n in (8, 16)]
    C_list = [Costs(xy=C, yx=C) for C in (((x[:, None] - x[None, :]) ** 2) / 2 for x in xs)]
    b_coarse = b.reshape(1, 2, 8, 2).sum(-1)

    def softmin(eps, C, h):
        return -eps * lse(h[..., None, :] - C / eps, -1)

    def extrapolate(*, self, other, log_weights, C, C_fine, eps, dampen):
        up = repeat(self, 2, -1)
        return up - np.log(2.0) if self.shape[1] == 1 else up

    return loop(
        softmin=softmin, log_b_k_list=[xp.log(b_coarse), xp.log(b)], w_k=w, C_list=C_list,
        descent=Descent([0, 0, 0, 1, 1, 1], EPS, [None] * 6), extrapolate=extrapolate, backward_iterations=2,
    )


@pytest.mark.parametrize("solve", [_single_scale, _two_scales])
def test_barycenter_loop_matches_jax(solve):
    b, w = _loop_inputs(solve is _two_scales)
    bar = assert_solve_parity(
        lambda b, w: solve("jax", b, w), lambda b, w: solve("torch", b, w), [b, w], rtol=RTOL, argnums=(0, 1)
    )
    if solve is _two_scales:  # the simplex gauge
        assert abs(bar.sum().item() - 1) < 1e-12
