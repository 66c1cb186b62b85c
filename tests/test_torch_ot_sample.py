"""The port's ``ot.solve_sample`` against the JAX package, in float64.

Both branches: dense cost matrices, and the streaming branch
(``STREAMING_THRESHOLD`` monkeypatched to 0 in both packages' modules,
as ``tests/test_solve_sample_streaming.py`` does), where every softmin is
``lse_points`` (kernel 1 on the card; its plain version here) and the
result's density applies ``gibbs_apply`` (kernel 4). Debias on and off,
balanced and unbalanced: the value, ``value_linear``, the potentials, the
plan, ``lazy_plan @ V`` (one and three channels) and its transpose,
``a_to_b``, ``b_to_a`` and the marginals within 1e-10, and the value's
gradients in ``X_a`` and ``X_b`` within 1e-8 (``torch_jax_parity``).

The JAX side runs under ``jax.jit``, as the JAX package's own steps after
the validation of ``solve_sample`` (the schedule from the concrete
diameter, the ``sinkhorn_loop`` of ``solvers.sinkhorn_ot`` on
``softmin_sample``, an ``OTResultSample``); ``test_core_matches_public``
holds it to the public JAX ``ot.solve_sample`` once. Then the Brenier and
unbalanced Gaussian oracles of ``tests/oracle_utils.py`` hold the port's
``solve_sample`` to closed forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geomloss_tpu.ot.sample_impl as jss
import geomloss_tpu_torch.ot.sample_impl as tss
from geomloss_tpu import ot as jax_ot
from geomloss_tpu.solvers.annealing import annealing_parameters, max_diameter
from geomloss_tpu.solvers.sinkhorn_ot import sinkhorn_loop
from geomloss_tpu.utils.typing import CostMatrices
from geomloss_tpu.utils.validation import ArrayProperties
from geomloss_tpu_torch import ot
from oracle_utils import brenier_pair, gaussian_grid_weights, uot_gaussian_1d
from torch_jax_parity import assert_solve_parity, close

RTOL, GRAD_RTOL = 1e-10, 1e-8


def jax_sample_result(X_a, X_b, a, b, *, descent, reg, unbalanced, debias):
    """The JAX ``solve_sample`` after its validation and schedule: its
    costs (point pairs above ``STREAMING_THRESHOLD``), the
    ``sinkhorn_loop`` of ``solvers.sinkhorn_ot`` and the result."""
    N, M = X_a.shape[0], X_b.shape[0]
    if N * M > jss.STREAMING_THRESHOLD:
        C = CostMatrices(xy=(X_a, X_b), yx=(X_b, X_a), xx=(X_a, X_a) if debias else None,
                         yy=(X_b, X_b) if debias else None)
    else:
        cm = jss.cost_matrix
        C = CostMatrices(xy=cm(X_a, X_b), yx=cm(X_b, X_a), xx=cm(X_a, X_a) if debias else None,
                         yy=cm(X_b, X_b) if debias else None)
    pots = sinkhorn_loop(softmin=jss.softmin_sample, log_a_list=[jss.stable_log(a)], log_b_list=[jss.stable_log(b)],
                         C_list=[C], descent=descent, debias=debias, last_extrapolation=True)
    return jss.OTResultSample(
        X_a=X_a, X_b=X_b, a=a, b=b, C=C, cost="sqeuclidean", reg=reg, reg_type="KL", unbalanced=unbalanced,
        unbalanced_type="KL", debias=debias, potentials=pots,
        array_properties=ArrayProperties(B=0, N=N, M=M, dtype=X_a.dtype, device="cpu", library="jax"),
    )


def jax_solve_sample(X_a, X_b, *, reg, unbalanced=None, debias, max_iter):
    """:func:`jax_sample_result` as a function of ``(X_a, X_b, a, b)``
    that ``jax.jit`` traces, on the schedule ``solve_sample`` reads from
    the concrete clouds."""
    descent = annealing_parameters(maxmin_cost=max_diameter(jnp.asarray(X_a), jnp.asarray(X_b)) ** 2, eps=reg,
                                   rho=unbalanced, n_iter=max_iter)
    return lambda X_a, X_b, a, b: jax_sample_result(X_a, X_b, a, b, descent=descent, reg=reg,
                                                    unbalanced=unbalanced, debias=debias)


#: What is compared of a result, in order (then the operators' products).
ATTRS = ("value", "value_linear", "potential_a", "potential_b", "plan", "marginal_a", "marginal_b", "a_to_b",
         "b_to_a")


def attrs(res, V, U):
    """The compared attributes, the self potentials when debiased, then
    ``lazy_plan @ V[:, 0]``, ``lazy_plan @ V`` and ``lazy_plan.T @ U``."""
    out = tuple(getattr(res, k) for k in ATTRS)
    if res._debias:
        out += (res.potential_aa, res.potential_bb)
    lazy = res.lazy_plan
    return out + (lazy @ V[:, 0], lazy @ V, lazy.T @ U)


def clouds(seed, N=23, M=29, D=2, mass_b=1.0):
    rng = np.random.RandomState(seed)
    x, y = rng.rand(N, D), 0.2 + rng.rand(M, D)
    a, b = rng.rand(N) + 0.1, rng.rand(M) + 0.1
    b[3] = 0.0  # a zero weight: stable_log's clamp
    return x, y, a / a.sum(), mass_b * b / b.sum()


@pytest.fixture(params=["dense", "streaming"])
def branch(request, monkeypatch):
    if request.param == "streaming":
        monkeypatch.setattr(jss, "STREAMING_THRESHOLD", 0)
        monkeypatch.setattr(tss, "STREAMING_THRESHOLD", 0)
    return request.param


@pytest.mark.parametrize("unbalanced", [None, 0.3])
@pytest.mark.parametrize("debias", [True, False])
def test_solve_sample_matches_jax(branch, debias, unbalanced):
    kw = dict(reg=0.01, unbalanced=unbalanced, debias=debias, max_iter=30)
    x, y, a, b = clouds(int(debias), mass_b=1.0 if unbalanced is None else 1.4)
    V, U = np.random.RandomState(7).randn(29, 3), np.random.RandomState(8).randn(23, 2)
    run = jax_solve_sample(x, y, **kw)
    out = assert_solve_parity(
        lambda x, y, a, b, V, U: attrs(run(x, y, a, b), V, U),
        lambda x, y, a, b, V, U: attrs(ot.solve_sample(x, y, a, b, **kw), V, U),
        [x, y, a, b, V, U], rtol=RTOL,
    )
    assert out[0].shape == () and out[7].shape == (23, 2) and out[-2].shape == (23, 3)


@pytest.mark.parametrize("unbalanced", [None, 0.3])
@pytest.mark.parametrize("debias", [True, False])
def test_solve_sample_gradients_match_jax(branch, debias, unbalanced):
    """The value's gradient in both clouds (the last extrapolation; on
    the streaming branch through ``lse_points``' analytic backward)."""
    kw = dict(reg=0.02, unbalanced=unbalanced, debias=debias, max_iter=20)
    x, y, a, b = clouds(2 + int(debias), N=17, M=13, D=3)
    run = jax_solve_sample(x, y, **kw)
    assert_solve_parity(
        lambda x, y, a, b: run(x, y, a, b).value,
        lambda x, y, a, b: ot.solve_sample(x, y, a, b, **kw).value,
        [x, y, a, b], rtol=RTOL, grad_rtol=GRAD_RTOL, argnums=(0, 1),
    )


def test_core_matches_public():
    """The jitted reference above is the public JAX ``ot.solve_sample``,
    here with ``blur=`` and ``reach=`` and uniform default marginals."""
    x, y, _, _ = clouds(4, N=12, M=10)
    res = jax_ot.solve_sample(jnp.asarray(x), jnp.asarray(y), blur=0.1, reach=0.5, max_iter=10, debias=True)
    n, m = np.full(12, 1 / 12), np.full(10, 1 / 10)
    run = jax_solve_sample(x, y, reg=2 * 0.1**2, unbalanced=2 * 0.5**2, debias=True, max_iter=10)
    core = jax.jit(lambda x, y, a, b: attrs(run(x, y, a, b), jnp.ones((10, 1)), jnp.ones((12, 1))))(x, y, n, m)
    for k, v in zip(ATTRS, core):
        close(torch.tensor(np.asarray(v)), getattr(res, k), 1e-13)
    port = ot.solve_sample(torch.tensor(x), torch.tensor(y), blur=0.1, reach=0.5, max_iter=10, debias=True)
    for k in ATTRS:
        close(getattr(port, k), getattr(res, k), RTOL)


def test_density_and_citation():
    """The dense density, its operator on the dense branch, and the
    attributes a result without debias refuses, as in JAX."""
    x, y, a, b = clouds(5, N=9, M=11)
    kw = dict(reg=0.05, debias=False, max_iter=15)
    got = ot.solve_sample(torch.tensor(x), torch.tensor(y), torch.tensor(a), torch.tensor(b), **kw)
    run = jax_solve_sample(x, y, **kw)
    dens, dens_t = jax.jit(lambda *v: (lambda r: (r.density, r.density_operator.T @ jnp.ones(9)))(run(*v)))(
        x, y, a, b)
    close(got.density, dens, RTOL)
    close(got.density_operator.T @ torch.ones(9, dtype=torch.float64), dens_t, RTOL)
    assert got.citation == jss.OTResultSample._citation(None) and got.density_operator.shape == (9, 11)
    with pytest.raises(ValueError, match="debias = True"):
        got.potential_aa


# --- Oracles ------------------------------------------------------------------------


@pytest.mark.parametrize("streaming", [False, True])
def test_brenier_oracle(streaming, monkeypatch):
    """Gradients of a convex function: the diagonal pairing is the exact
    optimal plan, with a known value (``oracle_utils.brenier_pair``;
    solve_sample's cost is |x - y|^2, twice the oracle's)."""
    if streaming:
        monkeypatch.setattr(tss, "STREAMING_THRESHOLD", 0)
    x, y, w, value = brenier_pair(4, 15, 2, strength=1.0)
    t = [torch.tensor(v) for v in (x, y, w)]
    res = ot.solve_sample(X_a=t[0], X_b=t[1], a=t[2], b=t[2], reg=1e-3, max_iter=2000)
    np.testing.assert_allclose(float(res.value_linear), 2 * value, rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(float(res.value), 2 * value, rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(res.plan.numpy(), np.diag(w), atol=1e-2)
    # The barycentric map sends each point to its image:
    np.testing.assert_allclose(res.a_to_b.numpy(), y, atol=2e-2)


def test_unbalanced_gaussian_oracle():
    """Unbalanced entropic OT between 1D Gaussians has a closed-form value,
    plan mass and plan (``oracle_utils.uot_gaussian_1d``; the conventions
    of ``tests/test_unbalanced_gaussians.py``: grids on [-1, 2], ``reg =
    2 blur^2``, ``unbalanced = reach^2``)."""
    mu_a, sa, ma, mu_b, sb, mb, blur, reach = 0.2, 0.15, 1.0, 0.8, 0.2, 1.0, 0.3, 1.0
    gx, gy = np.linspace(-1, 2, 96), np.linspace(-1, 2, 112)
    a, b = gaussian_grid_weights(gx, mu_a, sa, ma), gaussian_grid_weights(gy, mu_b, sb, mb)
    oracle = uot_gaussian_1d(ma, mu_a, sa**2, mb, mu_b, sb**2, sigma=blur, gamma=reach**2)
    res = ot.solve_sample(torch.tensor(gx[:, None]), torch.tensor(gy[:, None]), torch.tensor(a), torch.tensor(b),
                          reg=2 * blur**2, unbalanced=reach**2, max_iter=1000)
    np.testing.assert_allclose(float(res.value), oracle["value"], rtol=1e-2, atol=1e-3)
    plan = res.plan.numpy()
    np.testing.assert_allclose(plan.sum(), oracle["mass"], rtol=1e-2)
    expected = (gx[1] - gx[0]) * (gy[1] - gy[0]) * oracle["plan"](gx, gy)
    np.testing.assert_allclose(plan, expected, atol=1e-2 * expected.max())
    np.testing.assert_allclose(res.marginal_a.numpy(), expected.sum(-1), atol=2e-2 * expected.sum(-1).max())
