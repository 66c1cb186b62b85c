"""The port's ``ot.solve``, ``ot.solve_batch`` and ``ot.barycenter``
against the JAX package, in float64.

The same seeded numpy inputs go through both packages. The JAX side runs
under ``jax.jit``: ``ot.barycenter`` with its ``maxmin_cost=``, and the
matrix solvers as the JAX package's own steps after their validation (the
schedule from ``annealing_parameters``, the ``sinkhorn_loop`` of
``solvers.sinkhorn_ot`` on ``softmin_dense``, an ``OTResultMatrix``),
which ``test_core_matches_public_jax_solve`` holds to the public
``ot.solve`` once. Values, potentials, plans and marginals within 1e-10,
gradients within 1e-8 (``torch_jax_parity``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomloss_tpu import ot as jax_ot
from geomloss_tpu.ot import solve_matrix as jsm
from geomloss_tpu.solvers.annealing import annealing_parameters
from geomloss_tpu.solvers.sinkhorn_ot import sinkhorn_loop
from geomloss_tpu.utils.typing import CostMatrices
from geomloss_tpu.utils.validation import ArrayProperties
from geomloss_tpu_torch import ot
from torch_jax_parity import assert_solve_parity, close

RTOL, GRAD_RTOL = 1e-10, 1e-8

#: What is compared of a result, in order.
ATTRS = ("value", "value_linear", "potential_a", "potential_b", "plan", "marginal_a", "marginal_b")


def jax_solve_batch(C, a, b, *, reg, unbalanced=None, max_iter, squeeze=False):
    """The JAX ``solve_batch`` after its validation, as a function of
    arrays that ``jax.jit`` traces (the schedule from the concrete cost)."""
    B, N, M = C.shape
    descent = annealing_parameters(maxmin_cost=float(np.max(C) - np.min(C)), eps=reg, rho=unbalanced,
                                   n_iter=max_iter)

    def run(C, a, b):
        pots = sinkhorn_loop(
            softmin=jsm.softmin_dense, log_a_list=[jsm.stable_log(a)], log_b_list=[jsm.stable_log(b)],
            C_list=[CostMatrices(xy=C, yx=jnp.swapaxes(C, 1, 2))], descent=descent, debias=False,
            last_extrapolation=True,
        )
        res = jsm.OTResultMatrix(
            a=a, b=b, C=C, potentials=pots,
            array_properties=ArrayProperties(B=B, N=N, M=M, dtype=C.dtype, device="cpu", library="jax"),
            reg=reg, reg_type="KL", unbalanced=unbalanced, unbalanced_type="KL",
        )
        if squeeze:
            res._squeeze_batchdim()
        return res

    return run


def attrs(res, V, U):
    """The compared attributes, then the plan applied to ``V`` (the shape
    of ``b`` plus channels) and its transpose to ``U`` (that of ``a``)."""
    return tuple(getattr(res, k) for k in ATTRS) + (res.plan_operator @ V, res.plan_operator.T @ U)


def problem(seed, B, N, M, mass_b=1.0):
    rng = np.random.RandomState(seed)
    x, y = rng.rand(B, N, 2), rng.rand(B, M, 2)
    C = ((x[:, :, None] - y[:, None]) ** 2).sum(-1)
    a = rng.rand(B, N) + 0.1
    b = rng.rand(B, M) + 0.1
    a[:, 0] = 0.0  # a zero weight: stable_log's clamp
    a /= a.sum(1, keepdims=True)
    b *= mass_b / b.sum(1, keepdims=True)
    return C, a, b


CASES = {
    "balanced": dict(reg=0.05, max_iter=40),
    "small reg": dict(reg=2e-3, max_iter=80),
    "unbalanced": dict(reg=0.05, unbalanced=0.5, max_iter=40),
    "one iteration": dict(reg=0.1, max_iter=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_batch_matches_jax(case):
    kw = CASES[case]
    C, a, b = problem(1, 3, 9, 11, mass_b=1.0 if "unbalanced" not in kw else 1.7)
    V, U = np.random.RandomState(2).randn(3, 11, 2), np.random.RandomState(3).randn(3, 9)
    run = jax_solve_batch(C, a, b, **kw)
    assert_solve_parity(
        lambda C, a, b, V, U: attrs(run(C, a, b), V, U),
        lambda C, a, b, V, U: attrs(ot.solve_batch(C, a=a, b=b, **kw), V, U),
        [C, a, b, V, U], rtol=RTOL,
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_matches_jax(case):
    kw = CASES[case]
    C, a, b = problem(3, 1, 10, 8, mass_b=1.0 if "unbalanced" not in kw else 0.6)
    C, a, b = C[0], a[0], b[0]
    V, U = np.random.RandomState(4).randn(8, 3), np.random.RandomState(5).randn(10)
    run = jax_solve_batch(C[None], a[None], b[None], squeeze=True, **kw)
    res = assert_solve_parity(
        lambda C, a, b, V, U: attrs(run(C[None], a[None], b[None]), V, U),
        lambda C, a, b, V, U: attrs(ot.solve(C, a=a, b=b, **kw), V, U),
        [C, a, b, V, U], rtol=RTOL,
    )
    assert res[0].shape == () and res[4].shape == (10, 8) and res[7].shape == (10, 3) and res[8].shape == (8,)


@pytest.mark.parametrize("unbalanced", [None, 0.5])
def test_solve_gradients_match_jax(unbalanced):
    """The value's gradient in the cost and both marginals."""
    kw = dict(reg=0.05, unbalanced=unbalanced, max_iter=40)
    C, a, b = problem(5, 2, 7, 9)
    run = jax_solve_batch(C, a, b, **kw)
    assert_solve_parity(
        lambda C, a, b: run(C, a, b).value,
        lambda C, a, b: ot.solve_batch(C, a=a, b=b, **kw).value,
        [C, a, b], rtol=RTOL, grad_rtol=GRAD_RTOL, argnums=(0, 1, 2),
    )


def test_core_matches_public_jax_solve():
    """The jitted reference above is the public JAX ``ot.solve``."""
    C, a, b = problem(6, 1, 6, 5)
    kw = dict(reg=0.05, max_iter=30)
    res = jax_ot.solve(jnp.asarray(C[0]), a=jnp.asarray(a[0]), b=jnp.asarray(b[0]), **kw)
    run = jax_solve_batch(C, a, b, squeeze=True, **kw)
    core = jax.jit(lambda C, a, b: attrs(run(C, a, b), jnp.ones((5, 1)), jnp.ones(6)))(C, a, b)
    for k, v in zip(ATTRS, core):
        close(torch.tensor(np.asarray(v)), getattr(res, k), 1e-13)
    port = ot.solve(torch.tensor(C[0]), a=torch.tensor(a[0]), b=torch.tensor(b[0]), **kw)
    for k in ATTRS:
        close(getattr(port, k), getattr(res, k), RTOL)


def test_solve_defaults_and_density():
    """Uniform default marginals, the density and its operator, the
    citation and the batch-squeezed shapes."""
    C, _, _ = problem(7, 1, 5, 6)
    C = C[0]
    kw = dict(reg=0.1, max_iter=20)
    got = ot.solve(torch.tensor(C), **kw)
    ref = jax_ot.solve(jnp.asarray(C), **kw)
    close(got.density, ref.density, RTOL)
    close(got.density_operator @ torch.ones(6, dtype=torch.float64), ref.density_operator @ jnp.ones(6), RTOL)
    assert got.citation == ref.citation
    assert got.lazy_plan is None and got.density.shape == (5, 6)


# --- barycenter ---------------------------------------------------------------


def bar_problem(seed, K=3, N=8, M=6):
    rng = np.random.RandomState(seed)
    xs, z = rng.rand(K, N, 1), rng.rand(M, 1)
    cost = ((xs[:, :, None, :] - z[None, None]) ** 2).sum(-1)
    a = rng.rand(K, N) + 0.2
    w = rng.rand(K) + 0.5
    cost_bar = ((z[:, None] - z[None]) ** 2).sum(-1)
    return cost, a, w, cost_bar


@pytest.mark.parametrize("backward_iterations", [0, 5])
@pytest.mark.parametrize("debias", [False, True])
def test_barycenter_matches_jax(backward_iterations, debias):
    """Masses within 1e-10, and their gradient in the costs, the masses of
    the measures and the weights within 1e-8: ``backward_iterations=0``
    differentiates through the whole descent."""
    cost, a, w, cost_bar = bar_problem(8)
    kw = dict(reg=0.02, max_iter=15, backward_iterations=backward_iterations)
    maxmin = float(cost.max() - cost.min())
    cb = [cost_bar] if debias else []

    def jax_fn(cost, a, w, *cb):
        return jax_ot.barycenter(cost, a, w, cost_bar=cb[0] if cb else None, maxmin_cost=maxmin, **kw).masses

    def torch_fn(cost, a, w, *cb):
        return ot.barycenter(cost, a, w, cost_bar=cb[0] if cb else None, **kw).masses

    assert_solve_parity(jax_fn, torch_fn, [cost, a, w, *cb], rtol=RTOL, grad_rtol=GRAD_RTOL, argnums=(0, 1, 2))


def test_barycenter_batched_forms_match_jax():
    """(B, K, N, M) costs with (N,) masses and (K,) weights broadcast, the
    potentials and defaults."""
    cost, _, _, cost_bar = bar_problem(9, K=2, N=5, M=4)
    cost = np.stack([cost, 1.5 * cost])
    a = np.random.RandomState(10).rand(5) + 0.1
    kw = dict(reg=0.05, max_iter=10)
    maxmin = float(cost.max() - cost.min())
    got = ot.barycenter(torch.tensor(cost), torch.tensor(a), torch.tensor([0.3, 0.7], dtype=torch.float64),
                        cost_bar=torch.tensor(cost_bar), **kw)
    masses, pots = jax.jit(lambda c, a, w, cb: (lambda r: (r.masses, r.potentials))(
        jax_ot.barycenter(c, a, w, cost_bar=cb, maxmin_cost=maxmin, **kw)))(cost, a, np.array([0.3, 0.7]), cost_bar)
    assert got.masses.shape == (2, 4)
    close(got.masses, masses, RTOL)
    for u, v in zip(got.potentials, pots):
        close(u, v, RTOL)
    got = ot.barycenter(torch.tensor(cost[0]), **kw)
    ref = jax_ot.barycenter(jnp.asarray(cost[0]), **kw)
    assert got.masses.shape == (4,) and repr(got) == repr(ref)
    close(got.masses, ref.masses, RTOL)
