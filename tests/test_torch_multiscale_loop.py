"""The port's multiscale Sinkhorn loop against the JAX package, in float64.

``solvers/sinkhorn_loop.py`` on two scales of small dense cost matrices:
a jump inside the schedule and one at the last iteration, debias on and
off, values and gradients within 1e-10 (``torch_jax_parity``); and one
scale given bare or as one-element lists, bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.scipy.special import logsumexp as jlse

from geomloss_tpu.ops.softmin import softmin_dense as jax_softmin
from geomloss_tpu.solvers.sinkhorn_loop import sinkhorn_loop as jax_loop
from geomloss_tpu_torch.ops.softmin import softmin_dense
from geomloss_tpu_torch.solvers.sinkhorn_loop import sinkhorn_loop
from torch_jax_parity import assert_solve_parity

RTOL = 1e-10


def _loop_problem(seed):
    """Fine clouds of 12 and 10 points in 2D; the coarse scale pools
    consecutive pairs (centroids, summed weights)."""
    rng = np.random.RandomState(seed)
    x, y = rng.rand(1, 12, 2), rng.rand(1, 10, 2) + 0.3
    a, b = rng.rand(1, 12) + 0.2, rng.rand(1, 10) + 0.2
    return x, y, a / a.sum(), b / b.sum()


PACKAGES = {
    "jax": (jnp, jlse, jnp.repeat, jax_loop, jax_softmin),
    "torch": (torch, torch.logsumexp, torch.repeat_interleave, sinkhorn_loop, softmin_dense),
}


def _run_loop(pkg, x, y, a, b, jump, debias):
    """The two-scale problem through one package's loop: dense costs
    ``|x-y|^2 / 2`` at each scale, an identity truncation, and an
    extrapolation that repeats each coarse potential on its two fine points
    and adds terms read from the source log weights and the fine costs (so
    that the last-iteration jump passes gradients). Returns the potentials
    concatenated."""
    xp, lse, repeat, loop, softmin = PACKAGES[pkg]

    def pool(v):
        return v.reshape(v.shape[0], -1, 2, *v.shape[2:]).sum(2)

    def cost(p, q):
        return ((p[:, :, None, :] - q[:, None, :, :]) ** 2).sum(-1) / 2

    xs, ys = [pool(x) / 2, x], [pool(y) / 2, y]
    a_logs, b_logs = [xp.log(pool(a)), xp.log(a)], [xp.log(pool(b)), xp.log(b)]
    C = {k: [cost(p, q) for p, q in zip(P, Q)] for k, P, Q in (("xy", xs, ys), ("yx", ys, xs), ("xx", xs, xs), ("yy", ys, ys))}

    def truncation(C_xy, C_yx, C_xy_fine, C_yx_fine, f, g, eps, truncate=None, cost=None):
        return C_xy_fine, C_yx_fine

    def extrapolate(f, g, eps, damping, C, b_log, C_fine):
        return repeat(f, 2, -1) + 0.01 * damping * lse(b_log, -1)[:, None] + 1e-3 * C_fine.mean(-1)

    eps_list = [1.0, 0.5, 0.25, 0.1, 0.05]
    out = loop(
        softmin, a_logs, b_logs, C["xx"], C["yy"], C["xy"], C["yx"], eps_list, 0.5,
        jumps=[jump], kernel_truncation=truncation, extrapolate=extrapolate, debias=debias,
    )
    return xp.concatenate([v for v in out if v is not None], -1)


@pytest.mark.parametrize("debias", [True, False])
@pytest.mark.parametrize("jump", [2, 4])
def test_multiscale_loop_matches_jax(jump, debias):
    """A jump inside the schedule (iteration 2 of 5) and at the last
    iteration (which extrapolates from the attached coarse weights onto the
    attached fine costs, in place of the last extrapolation); the four
    potentials and their gradients in the weights and the points."""
    assert_solve_parity(
        lambda *args: _run_loop("jax", *args, jump, debias),
        lambda *args: _run_loop("torch", *args, jump, debias),
        _loop_problem(jump + debias), rtol=RTOL, argnums=(0, 1, 2, 3),
    )


def test_loop_bare_tensors_equal_one_element_lists():
    """One scale given bare or as one-element lists: the same floats."""
    x, y, a, b = (torch.tensor(v) for v in _loop_problem(5))
    C = {k: ((p[:, :, None] - q[:, None]) ** 2).sum(-1) / 2 for k, p, q in (("xy", x, y), ("yx", y, x), ("xx", x, x), ("yy", y, y))}
    args = (torch.log(a), torch.log(b), C["xx"], C["yy"], C["xy"], C["yx"])
    eps_list = [1.0, 0.3, 0.1]
    bare = sinkhorn_loop(softmin_dense, *args, eps_list, None)
    listed = sinkhorn_loop(softmin_dense, *([v] for v in args), eps_list, None)
    assert all(torch.equal(u, v) for u, v in zip(bare, listed))
