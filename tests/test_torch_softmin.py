"""The port's softmin layer against the JAX package's, in float64.

Same inputs (numpy, from a seed) through ``geomloss_tpu.ops.softmin`` and
``geomloss_tpu_torch.ops.softmin``: values within 1e-10 relative, the
analytic backward passes (JAX custom VJPs, port autograd Functions)
within 1e-8 relative to the largest gradient entry. The port's ``dense``
and ``blocked`` implementations are both held against JAX's ``dense``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomloss_tpu.ops import softmin as jsm
from geomloss_tpu_torch.ops import softmin as tsm

VAL_RTOL = 1e-10
GRAD_RTOL = 1e-8
IMPLS = ["dense", "blocked"]


def _data(N=70, M=90, D=3, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.rand(N, D),
        y=rng.rand(M, D) + 0.1,
        h=rng.randn(M),
        f=0.05 * rng.randn(N),
        g=0.05 * rng.randn(M),
        la=np.log(rng.rand(N) + 0.5) - np.log(N),
        lb=np.log(rng.rand(M) + 0.5) - np.log(M),
        u=rng.randn(N),
        v=rng.randn(M),
    )


def _close(got, expected, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    expected = np.asarray(expected)
    np.testing.assert_allclose(got, expected, rtol=rtol, atol=rtol * np.abs(expected).max())


def _leaf(a):
    return torch.tensor(a, dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("p", [1, 2])
def test_lse_points_value_and_grad(p, impl):
    d = _data(seed=p)
    eps = 0.3

    def jf(x, y, h):
        return jnp.dot(jsm.lse_points(x, y, h, eps, p, "dense"), d["u"])

    jv, jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2)))(d["x"], d["y"], d["h"])
    x, y, h = _leaf(d["x"]), _leaf(d["y"]), _leaf(d["h"])
    tv = torch.dot(tsm.lse_points(x, y, h, eps, p, impl), torch.tensor(d["u"]))
    tv.backward()
    _close(tv, jv, VAL_RTOL)
    for t, j in zip((x.grad, y.grad, h.grad), jg):
        _close(t, j, GRAD_RTOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("p", [1, 2])
def test_softmin_extrapolation_value_and_grad(p, impl):
    d = _data(seed=10 + p)
    eps = 0.3
    consts = [jnp.asarray(d[k]) for k in ("f", "g", "la", "lb")]

    def jf(x, y):
        S_xy, S_yx = jsm.softmin_extrapolation(x, y, *consts, eps, p, "dense")
        return jnp.dot(S_xy, d["u"]) + jnp.dot(S_yx, d["v"])

    jv, jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(d["x"], d["y"])
    x, y = _leaf(d["x"]), _leaf(d["y"])
    tconsts = [torch.tensor(d[k]) for k in ("f", "g", "la", "lb")]
    S_xy, S_yx = tsm.softmin_extrapolation(x, y, *tconsts, eps, p, impl)
    tv = torch.dot(S_xy, torch.tensor(d["u"])) + torch.dot(S_yx, torch.tensor(d["v"]))
    tv.backward()
    _close(tv, jv, VAL_RTOL)
    _close(x.grad, jg[0], GRAD_RTOL)
    _close(y.grad, jg[1], GRAD_RTOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("p", [1, 2])
def test_softmin_extrapolation_sym_value_and_grad(p, impl):
    d = _data(seed=20 + p)
    eps = 0.3

    def jf(x):
        S = jsm.softmin_extrapolation_sym(x, jnp.asarray(d["f"]), jnp.asarray(d["la"]), eps, p, "dense")
        return jnp.dot(S, d["u"])

    jv, jg = jax.jit(jax.value_and_grad(jf))(d["x"])
    x = _leaf(d["x"])
    S = tsm.softmin_extrapolation_sym(x, torch.tensor(d["f"]), torch.tensor(d["la"]), eps, p, impl)
    tv = torch.dot(S, torch.tensor(d["u"]))
    tv.backward()
    _close(tv, jv, VAL_RTOL)
    _close(x.grad, jg, GRAD_RTOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("p", [1, 2])
def test_sinkhorn_step_points(p, sym, impl):
    d = _data(seed=30 + p)
    eps = 0.2
    if sym:
        args = [d["x"], d["x"], d["la"], d["la"], d["f"], d["f"]]
    else:
        args = [d["x"], d["y"], d["la"], d["lb"], d["f"], d["g"]]
    j = jsm.sinkhorn_step_points(eps, *map(jnp.asarray, args), p=p, impl="dense", sym=sym)
    t = tsm.sinkhorn_step_points(eps, *map(torch.tensor, args), p=p, impl=impl, sym=sym)
    _close(t[0], j[0], VAL_RTOL)
    if sym:
        assert t[1] is None
    else:
        _close(t[1], j[1], VAL_RTOL)


@pytest.mark.parametrize("p,kind", [(2, "gibbs"), (1, "gibbs"), (1, "energy")])
def test_gibbs_matvec_value_and_grad(p, kind):
    d = _data(seed=40 + p)
    eps = 0.4

    def jf(x, y, v):
        return jnp.dot(jsm.gibbs_matvec(x, y, v, eps, p, kind, "dense"), d["u"])

    jv, jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2)))(d["x"], d["y"], d["v"])
    for impl in IMPLS:
        x, y, v = _leaf(d["x"]), _leaf(d["y"]), _leaf(d["v"])
        tv = torch.dot(tsm.gibbs_matvec(x, y, v, eps, p, kind, impl), torch.tensor(d["u"]))
        tv.backward()
        _close(tv, jv, VAL_RTOL)
        for t, j in zip((x.grad, y.grad, v.grad), jg):
            _close(t, j, GRAD_RTOL)


def _fold_counts():
    from geomloss_tpu_torch.utils import profiling

    return [profiling.totals.get(k, 0) for k in ("matvec.forwards", "matvec.grad_in_forward")]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("wrt", ["x", "xyv"])
def test_gibbs_matvec_energy_folded_forward(wrt, impl):
    """The energy matvec with x requiring grad makes the gradient's apply in
    its forward (the energy_grad kind): its value within 1e-6 of the
    unfolded matvec's, its gradients (in x alone, or with y and v) equal to
    the unfolded ones and within GRAD_RTOL of the JAX package's."""
    d = _data(seed=44)
    u = torch.tensor(d["u"])

    def jf(x, y, v):
        return jnp.dot(jsm.gibbs_matvec(x, y, v, 1.0, 1, "energy", "dense"), d["u"])

    jv, jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2)))(d["x"], d["y"], d["v"])
    runs = {}
    for fold in (True, False):
        leaves = [torch.tensor(d[k], requires_grad=k in wrt) for k in "xyv"]
        before = _fold_counts()
        out = tsm._GibbsMatvec.apply(*leaves, 1.0, 1, "energy", impl, fold)
        assert np.subtract(_fold_counts(), before).tolist() == [1, int(fold)]
        grads = torch.autograd.grad(torch.dot(out, u), [t for t in leaves if t.requires_grad])
        runs[fold] = out.detach(), grads
    (v1, g1), (v0, g0) = runs[True], runs[False]
    torch.testing.assert_close(v1, v0, rtol=1e-6, atol=1e-6 * v0.abs().max().item())
    _close(torch.dot(v1, u), jv, VAL_RTOL)
    for a, b, j in zip(g1, g0, [g for k, g in zip("xyv", jg) if k in wrt]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0)
        _close(a, j, GRAD_RTOL)


def test_gibbs_apply_energy_grad_kind():
    """The fused kind: the energy kind's value of v and the inv_dist kind's
    apply of v [1, y], on the dense path, the plain twin and the wrapper
    (its twin on the CPU); an unknown kind still raises."""
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    d = _data(N=40, M=50, D=4, seed=45)
    x, y, v = (torch.tensor(d[k]) for k in "xyv")
    zx, zy = torch.zeros(40, dtype=x.dtype), torch.zeros(50, dtype=x.dtype)
    value = tsm.gibbs_apply(x, y, zx, zy, v[:, None], 1.0, 1, kind="energy", impl="dense")[:, 0]
    R = tsm.gibbs_apply(x, y, zx, zy, v[:, None] * torch.cat([torch.ones(50, 1, dtype=x.dtype), y], 1), 1.0, 1,
                        kind="inv_dist", impl="dense")
    for got in (tsm.gibbs_apply(x, y, zx, zy, v, 1.0, 1, kind="energy_grad", impl="dense"),
                ck.gibbs_apply_blocked(x, y, zx, zy, v, 1.0, 1, "energy_grad", block_m=16),
                ck.gibbs_apply(x, y, zx, zy, v, 1.0, 1, "energy_grad")):
        assert got[0].shape == (40,) and got[1].shape == (40, 5)
        _close(got[0], value, VAL_RTOL)
        _close(got[1], R, VAL_RTOL)
    with pytest.raises(ValueError, match="kind"):
        ck.gibbs_apply(x, y, zx, zy, v[:, None], 1.0, 1, "energy_grad_2")


_FOLD_CASES = {"grad": ("energy", 1, True, True), "no_grad": ("energy", 1, False, True),
               "x_constant": ("energy", 1, True, False), "gibbs_p2": ("gibbs", 2, True, True),
               "gibbs_p1": ("gibbs", 1, True, True)}


@pytest.mark.parametrize("case", list(_FOLD_CASES))
def test_gibbs_matvec_fold_counters(case):
    """``matvec.forwards`` counts every forward of the streaming matvec and
    ``matvec.grad_in_forward`` the folded ones: the energy kind with grad
    enabled and x requiring grad, never a gibbs kind."""
    kind, p, grad, x_grad = _FOLD_CASES[case]
    d = _data(seed=46)
    x = torch.tensor(d["x"], requires_grad=x_grad)
    before = _fold_counts()
    with torch.set_grad_enabled(grad):
        tsm.gibbs_matvec(x, torch.tensor(d["y"]), torch.tensor(d["v"]), 0.4, p, kind, "blocked")
    assert np.subtract(_fold_counts(), before).tolist() == [1, int(case == "grad")]


def test_lse_points_custom_value_and_grad():
    """User cost callables: plain autograd over checkpointed blocks."""
    d = _data(seed=50)
    eps = 0.25

    def jcost(x, y):
        return jnp.abs(x[:, :, None, :] - y[:, None, :, :]).sum(-1)

    def tcost(x, y):
        return (x[:, :, None, :] - y[:, None, :, :]).abs().sum(-1)

    def jf(x, y, h):
        return jnp.dot(jsm.lse_points_custom(x, y, h, eps, jcost, block_m=32), d["u"])

    jv, jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2)))(d["x"], d["y"], d["h"])
    x, y, h = _leaf(d["x"]), _leaf(d["y"]), _leaf(d["h"])
    tv = torch.dot(tsm.lse_points_custom(x, y, h, eps, tcost, block_m=32), torch.tensor(d["u"]))
    tv.backward()
    _close(tv, jv, VAL_RTOL)
    for t, j in zip((x.grad, y.grad, h.grad), jg):
        _close(t, j, GRAD_RTOL)


def test_softmin_dense_and_batched_points():
    d = _data(seed=60)
    eps = 0.3
    C = np.random.RandomState(1).rand(2, 5, 7)
    h = np.random.RandomState(2).randn(2, 7)
    _close(tsm.softmin_dense(eps, torch.tensor(C), torch.tensor(h)),
           jsm.softmin_dense(eps, jnp.asarray(C), jnp.asarray(h)), VAL_RTOL)
    xb = np.stack([d["x"], d["x"][::-1]])
    yb = np.stack([d["y"], d["y"] * 0.5])
    hb = np.stack([d["h"], -d["h"]])
    j = jsm.softmin_points(eps, (jnp.asarray(xb), jnp.asarray(yb)), jnp.asarray(hb), p=2, impl="dense")
    t = tsm.softmin_points(eps, (torch.tensor(xb), torch.tensor(yb)), torch.tensor(hb), p=2, impl="blocked")
    _close(t, j, VAL_RTOL)


def test_unknown_impl_raises():
    x = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="implementation"):
        tsm.gibbs_apply(x, x, x[:, 0], x[:, 0], x, 0.1, 2, impl="pallas")
