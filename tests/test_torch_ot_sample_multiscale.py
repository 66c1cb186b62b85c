"""The port's ``ot.solve_sample(method="multiscale")``,
``ot.solve_sample_batch`` and ``ot.barycenter_sample`` against the JAX
package, in float64.

* ``method="multiscale"`` at N = M = 256 (the two-scale descent through
  the loop's jump branch: Hilbert-ordered clusters, truncation,
  extrapolation), debias on and off, against the public JAX call: value,
  potentials, plan and marginals within 1e-10.
* ``solve_sample_batch`` at B = 3, dense and streaming, debias on and
  off: each problem's value, potentials, marginals and ``lazy_plan @ V``
  within 1e-10, and the gradient of their values' sum in ``X_a`` within
  1e-8, against the JAX package's ``jax.vmap`` of its solver core under
  ``jax.jit`` (one schedule from the global diameter, as
  ``solve_sample_batch`` builds it).
* ``barycenter_sample`` at K = 2 clouds of N = 64 points, ``n_iter=2``,
  unbatched and batched, against the public JAX call: the support within
  1e-10.
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
from geomloss_tpu_torch import ot
from test_torch_ot_sample import jax_sample_result
from torch_jax_parity import assert_solve_parity, close

RTOL, GRAD_RTOL = 1e-10, 1e-8


@pytest.mark.parametrize("debias", [True, False])
def test_multiscale_matches_jax(debias):
    rng = np.random.RandomState(11 + debias)
    x, y = rng.rand(256, 2), 0.3 + 0.8 * rng.rand(256, 2)
    a = rng.rand(256) + 0.2
    kw = dict(reg=2e-3, max_iter=40, debias=debias, method="multiscale")
    ref = jax_ot.solve_sample(jnp.asarray(x), jnp.asarray(y), jnp.asarray(a / a.sum()), **kw)
    got = ot.solve_sample(torch.tensor(x), torch.tensor(y), torch.tensor(a / a.sum()), **kw)
    for k in ("value", "potential_a", "potential_b", "plan", "marginal_a", "marginal_b", "value_linear"):
        close(getattr(got, k), getattr(ref, k), RTOL)
    if debias:
        close(got.potential_aa, ref.potential_aa, RTOL)


def jax_solve_sample_batch(X_a, X_b, *, reg, debias, max_iter):
    """The JAX ``solve_sample_batch`` after its validation: ``jax.vmap``
    of its single-problem core with one schedule from the global diameter;
    returns a function of ``(X_a, X_b, a, b, V)`` giving each problem's
    value, potentials, marginals and ``lazy_plan @ V``."""
    D = X_a.shape[-1]
    diam = max_diameter(jnp.asarray(X_a).reshape(-1, D), jnp.asarray(X_b).reshape(-1, D))
    descent = annealing_parameters(maxmin_cost=diam**2, eps=reg, n_iter=max_iter)

    def one(xa, xb, aa, bb, V):
        res = jax_sample_result(xa, xb, aa, bb, descent=descent, reg=reg, unbalanced=None, debias=debias)
        return res.value, res.potential_a, res.potential_b, res.marginal_a, res.marginal_b, res.lazy_plan @ V

    return jax.vmap(one)


def batch_attrs(results, V):
    cols = [(r.value, r.potential_a, r.potential_b, r.marginal_a, r.marginal_b, r.lazy_plan @ v)
            for r, v in zip(results, V)]
    return tuple(torch.stack(c) for c in zip(*cols))


@pytest.mark.parametrize("debias", [True, False])
@pytest.mark.parametrize("streaming", [False, True])
def test_solve_sample_batch_matches_jax(streaming, debias, monkeypatch):
    if streaming:
        monkeypatch.setattr(jss, "STREAMING_THRESHOLD", 0)
        monkeypatch.setattr(tss, "STREAMING_THRESHOLD", 0)
    rng = np.random.RandomState(20 + 2 * streaming + debias)
    x, y = rng.rand(3, 14, 2), rng.rand(3, 11, 2) + 0.1
    a, b = rng.rand(3, 14) + 0.1, rng.rand(3, 11) + 0.1
    a, b = a / a.sum(1, keepdims=True), b / b.sum(1, keepdims=True)
    V = rng.randn(3, 11, 3)
    kw = dict(reg=0.01, debias=debias, max_iter=25)
    run = jax_solve_sample_batch(x, y, **kw)
    out = assert_solve_parity(
        lambda x, y, a, b, V: run(x, y, a, b, V),
        lambda x, y, a, b, V: batch_attrs(ot.solve_sample_batch(x, y, a, b, **kw), V),
        [x, y, a, b, V], rtol=RTOL,
    )
    assert out[0].shape == (3,) and out[-1].shape == (3, 14, 3)
    # The gradient of the values' sum in X_a (the cotangent weighs each
    # problem differently):
    assert_solve_parity(
        lambda x, y, a, b, V: run(x, y, a, b, V)[0],
        lambda x, y, a, b, V: torch.stack([r.value for r in ot.solve_sample_batch(x, y, a, b, **kw)]),
        [x, y, a, b, V], rtol=RTOL, grad_rtol=GRAD_RTOL, argnums=(0,),
    )


def test_solve_sample_batch_defaults():
    """Uniform marginals, blur=, a list of results of the single-problem
    type."""
    rng = np.random.RandomState(30)
    x, y = rng.rand(2, 9, 3), rng.rand(2, 12, 3)
    got = ot.solve_sample_batch(torch.tensor(x), torch.tensor(y), blur=0.1, max_iter=10)
    ref = jax_solve_sample_batch(x, y, reg=2 * 0.1**2, debias=False, max_iter=10)
    vals = jax.jit(ref)(x, y, np.full((2, 9), 1 / 9), np.full((2, 12), 1 / 12), np.ones((2, 12, 1)))
    assert isinstance(got, list) and all(isinstance(r, ot.OTResultSample) for r in got)
    close(torch.stack([r.value for r in got]), vals[0], RTOL)


@pytest.mark.parametrize("batched", [False, True])
def test_barycenter_sample_matches_jax(batched):
    rng = np.random.RandomState(40 + batched)
    xa = rng.randn(2, 64, 2) * np.array([[[0.1]], [[0.2]]]) + np.array([[[0.0, 0.0]], [[1.0, 0.5]]])
    kw = dict(blur=0.1, n_iter=2)
    if batched:
        xa = np.stack([xa, xa[:, ::-1] * 0.5])
        w = np.array([[0.3, 0.7], [0.5, 0.5]])
    else:
        w = np.array([0.3, 0.7])
    a = rng.rand(*xa.shape[:-1]) + 0.5
    ref = jax_ot.barycenter_sample(jnp.asarray(xa), jnp.asarray(a), jnp.asarray(w), **kw)
    got = ot.barycenter_sample(torch.tensor(xa), torch.tensor(a), torch.tensor(w), **kw)
    assert got.samples.shape == ref.samples.shape and repr(got) == repr(ref)
    close(got.samples, ref.samples, RTOL)
    close(got.masses, ref.masses, RTOL)
    assert got.reg == ref.reg
