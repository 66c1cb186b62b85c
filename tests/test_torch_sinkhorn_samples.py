"""The port's Sinkhorn slice against the JAX package, in float64.

``SamplesLoss("sinkhorn")`` with the tensorized and online backends, the
same inputs (numpy, from a seed) through both packages: values within
1e-10 relative, gradients within 1e-8 relative to the largest entry.
Also: a few kernel (MMD) routes of the same front end against the JAX
package (the whole MMD slice is in ``test_torch_kernel_samples.py``), the
port imports no JAX, and state crosses between the packages through
``utils.interop``.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomloss_tpu import SamplesLoss as JaxLoss
from geomloss_tpu.models.sinkhorn_samples import sinkhorn_online as jax_online
from geomloss_tpu.solvers.sinkhorn_loop import unbalanced_weight as jax_uw
from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.models.sinkhorn_samples import sinkhorn_online
from geomloss_tpu_torch.ops.softmin import softmin_dense
from geomloss_tpu_torch.solvers.sinkhorn_loop import sinkhorn_loop, unbalanced_weight
from geomloss_tpu_torch.ops.block_sparse import TileMask
from geomloss_tpu_torch.utils import from_numpy, tile_mask_from_numpy, to_numpy

VAL_RTOL = 1e-10
GRAD_RTOL = 1e-8
KW = dict(blur=0.1, diameter=2.0, scaling=0.7)


def _clouds(N=230, M=310, seed=0, batch=None):
    rng = np.random.RandomState(seed)
    lead = () if batch is None else (batch,)
    x = rng.rand(*lead, N, 3)
    y = rng.rand(*lead, M, 3) + 0.2
    a = rng.rand(*lead, N) + 0.2
    b = rng.rand(*lead, M) + 0.2
    return x, y, a / a.sum(-1, keepdims=True), b / b.sum(-1, keepdims=True)


def _close(got, expected, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    expected = np.asarray(expected)
    np.testing.assert_allclose(got, expected, rtol=rtol, atol=rtol * np.abs(expected).max())


def _leaf(a):
    return torch.tensor(a, dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("reach", [None, 0.5])
@pytest.mark.parametrize("debias", [True, False])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("backend", ["tensorized", "online"])
def test_samples_loss_two_args(backend, p, debias, reach):
    x, y, _, _ = _clouds(seed=p)
    kw = dict(p=p, debias=debias, reach=reach, backend=backend, **KW)
    jv, jg = jax.jit(jax.value_and_grad(lambda x: JaxLoss("sinkhorn", **kw)(x, jnp.asarray(y))))(jnp.asarray(x))
    xt = _leaf(x)
    tv = SamplesLoss("sinkhorn", **kw)(xt, torch.tensor(y))
    tv.backward()
    _close(tv, jv, VAL_RTOL)
    _close(xt.grad, jg, GRAD_RTOL)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("backend", ["tensorized", "online"])
def test_samples_loss_four_args_weights_grad(backend, p):
    x, y, a, b = _clouds(seed=3 + p)
    kw = dict(p=p, backend=backend, **KW)

    def jf(a, x, b, y):
        return JaxLoss("sinkhorn", **kw)(a, x, b, y)

    jv, jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, (a, x, b, y)))
    leaves = [_leaf(v) for v in (a, x, b, y)]
    tv = SamplesLoss("sinkhorn", **kw)(*leaves)
    tv.backward()
    _close(tv, jv, VAL_RTOL)
    for t, j in zip(leaves, jg):
        _close(t.grad, j, GRAD_RTOL)


@pytest.mark.parametrize("debias", [True, False])
@pytest.mark.parametrize("backend", ["tensorized", "online"])
def test_samples_loss_potentials(backend, debias):
    x, y, a, b = _clouds(N=200, M=260, seed=7)
    kw = dict(p=2, backend=backend, debias=debias, potentials=True, reach=0.5, **KW)
    jF, jG = jax.jit(JaxLoss("sinkhorn", **kw).__call__)(*map(jnp.asarray, (a, x, b, y)))
    tF, tG = SamplesLoss("sinkhorn", **kw)(*map(torch.tensor, (a, x, b, y)))
    assert tF.shape == jF.shape and tG.shape == jG.shape
    _close(tF, jF, VAL_RTOL)
    _close(tG, jG, VAL_RTOL)


@pytest.mark.parametrize("backend", ["tensorized", "online"])
def test_samples_loss_batched(backend):
    x, y, a, b = _clouds(N=120, M=150, seed=8, batch=2)
    kw = dict(p=2, backend=backend, **KW)
    jv = jax.jit(JaxLoss("sinkhorn", **kw).__call__)(*map(jnp.asarray, (a, x, b, y)))
    tv = SamplesLoss("sinkhorn", **kw)(*map(torch.tensor, (a, x, b, y)))
    assert tuple(tv.shape) == (2,)
    _close(tv, jv, VAL_RTOL)


@pytest.mark.parametrize("p", [1, 2])
def test_online_through_the_kernel_twins(p):
    """The online solve through the plain twins of the CUDA kernels (the
    absorbed, max-pass-free step) against JAX's max-shifted dense LSEs."""
    x, y, a, b = _clouds(N=250, M=280, seed=9, batch=1)
    kw = dict(p=p, **KW)

    def jf(x):
        return jax_online(jnp.asarray(a), x, jnp.asarray(b), jnp.asarray(y), impl="dense", **kw)[0]

    jv, jg = jax.jit(jax.value_and_grad(jf))(jnp.asarray(x))
    xt = _leaf(x)
    tv = sinkhorn_online(torch.tensor(a), xt, torch.tensor(b), torch.tensor(y), impl="blocked", **kw)[0]
    tv.backward()
    _close(tv, jv, VAL_RTOL)
    _close(xt.grad, jg, GRAD_RTOL)


def test_warm_start_matches_jax():
    """Raw potentials of a JAX solve, carried over through numpy, warm-start
    both packages on a moved cloud: same value and gradient."""
    x, y, a, b = _clouds(N=210, M=240, seed=11, batch=1)
    kw = dict(p=2, **KW)
    ja, jb, jy = jnp.asarray(a), jnp.asarray(b), jnp.asarray(y)
    raw = jax.jit(lambda x: jax_online(ja, x, jb, jy, potentials="raw", **kw))(jnp.asarray(x))
    x2 = x + 0.01

    def jf(x):
        return jax_online(ja, x, jb, jy, init_potentials=raw, warm_start_iters=3, **kw)[0]

    jv, jg = jax.jit(jax.value_and_grad(jf))(jnp.asarray(x2))
    t_raw = from_numpy(tuple(np.asarray(r) for r in raw), device="cpu", dtype=torch.float64)
    xt = _leaf(x2)
    tv = sinkhorn_online(
        torch.tensor(a), xt, torch.tensor(b), torch.tensor(y),
        init_potentials=t_raw, warm_start_iters=3, **kw,
    )[0]
    tv.backward()
    _close(tv, jv, VAL_RTOL)
    _close(xt.grad, jg, GRAD_RTOL)
    # The port's own raw potentials match JAX's:
    own = sinkhorn_online(*map(torch.tensor, (a, x, b, y)), potentials="raw", **kw)
    for t, j in zip(to_numpy(own), raw):
        _close(torch.from_numpy(t), j, VAL_RTOL)


def test_unbalanced_weight_sejourne_grad():
    v = np.random.RandomState(0).randn(6)
    jg = jax.grad(lambda v: jax_uw(v, eps=0.1, rho=0.5, mode="sejourne").sum())(jnp.asarray(v))
    vt = _leaf(v)
    unbalanced_weight(vt, eps=0.1, rho=0.5, mode="sejourne").sum().backward()
    _close(vt.grad, jg, VAL_RTOL)
    _close(unbalanced_weight(vt, eps=0.1, rho=0.5, mode="sejourne"), 0.55 * v, VAL_RTOL)


def _half_sqdist(x, y):
    return ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1) / 2


def _gauss(x, y, blur=0.05):
    return torch.exp(-((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1) / (2 * blur**2))


def _jgauss(x, y, blur=0.05):
    return jnp.exp(-((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1) / (2 * blur**2))


@pytest.mark.parametrize(
    "loss,backend,custom",
    [
        ("energy", "multiscale", False),
        ("energy", "online", False),
        ("gaussian", "tensorized", False),
        ("hausdorff", "online", True),
    ],
)
def test_kernel_routes_match_jax(loss, backend, custom):
    """Four MMD routes through the front end, value and gradient in x
    (hausdorff with a user kernel; the energy kernel's multiscale route is
    its streaming fallback)."""
    x, y, a, b = _clouds(N=50, M=60, seed=len(loss))
    kw = dict(blur=0.1, backend=backend)
    jl = JaxLoss(loss, kernel=_jgauss if custom else None, **kw)
    tl = SamplesLoss(loss, kernel=_gauss if custom else None, **kw)
    # Under jax.jit: one compilation instead of one per operation.
    jv, jg = jax.jit(jax.value_and_grad(lambda x: jl(jnp.asarray(a), x, jnp.asarray(b), jnp.asarray(y))))(
        jnp.asarray(x)
    )
    xt = _leaf(x)
    tv = tl(torch.tensor(a), xt, torch.tensor(b), torch.tensor(y))
    (tg,) = torch.autograd.grad(tv, xt)
    _close(tv, jv, VAL_RTOL)
    _close(tg, jg, GRAD_RTOL)


@pytest.mark.parametrize("route", ["mid_phase", "custom_cost"])
def test_multiscale_routes_run(monkeypatch, route):
    """The two multiscale routes that used to raise now run: the mid phase
    above ``N_FINE_OK`` points (lowered here, as the JAX tests do) and a
    custom cost, both through ``SamplesLoss``; finite value and gradient."""
    from geomloss_tpu_torch.models import multiscale

    rng = np.random.RandomState(7)
    x = torch.tensor(rng.rand(2048, 3), requires_grad=True)
    y = torch.tensor(rng.rand(2048, 3) + 0.1)
    kw = dict(diameter=2.0)
    mid_runs = []
    run_mid_phase = multiscale.run_mid_phase
    monkeypatch.setattr(multiscale, "run_mid_phase", lambda *a, **k: mid_runs.append(1) or run_mid_phase(*a, **k))
    if route == "mid_phase":
        monkeypatch.setattr(multiscale, "N_FINE_OK", 512)
    else:
        kw["cost"] = _half_sqdist
    v = SamplesLoss("sinkhorn", backend="multiscale", **kw)(x, y)
    (g,) = torch.autograd.grad(v, x)
    assert torch.isfinite(v) and torch.isfinite(g).all()
    assert len(mid_runs) == (route == "mid_phase")


def test_labels_form_and_loop_jumps_run():
    """The labels form runs the multiscale backend, with a custom cost too
    (``|x-y|^2 / 2`` gives the built-in p = 2 value); the loop takes a jump:
    two scales (pooled pairs, then the cloud) with ``jumps=[0]`` return
    finite potentials of the fine scale."""
    x = torch.rand(20, 3, dtype=torch.float64)
    w = torch.full((20,), 1 / 20, dtype=torch.float64)
    lab = torch.zeros(20, dtype=torch.int64)
    custom = SamplesLoss("sinkhorn", cost=_half_sqdist)(lab, w, x, lab, w, x.flip(0) + 0.1)
    builtin = SamplesLoss("sinkhorn")(lab, w, x, lab, w, x.flip(0) + 0.1)
    _close(custom, builtin.detach().numpy(), VAL_RTOL)
    y = x.flip(0) + 0.1
    xs, ys = [x.reshape(10, 2, 3).mean(1), x], [y.reshape(10, 2, 3).mean(1), y]
    logs = [torch.log(w.reshape(10, 2).sum(1)), torch.log(w)]
    C = {k: [_half_sqdist(p[None], q[None])[0] for p, q in zip(P, Q)] for k, P, Q in (("xy", xs, ys), ("yx", ys, xs), ("xx", xs, xs), ("yy", ys, ys))}
    out = sinkhorn_loop(
        softmin_dense, logs, logs, C["xx"], C["yy"], C["xy"], C["yx"], [1.0, 0.1], None, jumps=[0],
        kernel_truncation=lambda C_xy, C_yx, C_xy_f, C_yx_f, *a, **k: (C_xy_f, C_yx_f),
        extrapolate=lambda f, g, eps, damping, C, b_log, C_f: f.repeat_interleave(2),
    )
    assert all(v.shape == (20,) and torch.isfinite(v).all() for v in out)


@pytest.mark.parametrize(
    "args",
    [
        lambda: (np.ones(5) / 5, np.random.rand(5, 3), np.ones((1, 6)) / 6, np.random.rand(6, 3)),
        lambda: (np.random.rand(5, 3), np.random.rand(6, 2)),
        lambda: (np.ones(4) / 4, np.random.rand(5, 3), np.ones(6) / 6, np.random.rand(6, 3)),
        lambda: (np.random.rand(5, 3),),
    ],
)
def test_check_shapes_errors_match_jax(args):
    arrays = args()
    with pytest.raises(ValueError) as je:
        JaxLoss("sinkhorn")(*map(jnp.asarray, arrays))
    with pytest.raises(ValueError) as te:
        SamplesLoss("sinkhorn")(*map(torch.tensor, arrays))
    assert str(te.value) == str(je.value)


def test_interop_round_trip():
    tree = {"raw": (np.arange(3.0), None), "w": [np.ones((2, 2), np.float32)]}
    t = from_numpy(tree, device="cpu", dtype=torch.float64)
    assert t["raw"][0].dtype == torch.float64 and t["raw"][1] is None
    back = to_numpy(t)
    np.testing.assert_array_equal(back["raw"][0], tree["raw"][0])
    np.testing.assert_array_equal(back["w"][0], tree["w"][0])


def test_interop_defaults_to_the_card():
    """State carried across lands on the card unless the caller asks for the
    CPU: without a card the default raises torch's own error rather than
    quietly returning CPU tensors."""
    tree = (np.arange(3.0), None)
    if torch.cuda.is_available():
        assert from_numpy(tree)[0].is_cuda
        return
    with pytest.raises((AssertionError, RuntimeError)):
        from_numpy(tree)
    with pytest.raises((AssertionError, RuntimeError)):
        tile_mask_from_numpy(TileMask(np.zeros((2, 1), np.int32), np.ones(2, np.int32), None, None))


def test_port_imports_no_jax():
    code = textwrap.dedent(
        """
        import sys
        import geomloss_tpu_torch
        from geomloss_tpu_torch import models, ops, solvers, utils
        from geomloss_tpu_torch.ops import cuda_kernels
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "geomloss_tpu.")) or m == "geomloss_tpu")
        print(bad)
        sys.exit(1 if bad else 0)
        """
    )
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
