"""The port's kernel (MMD) losses against the JAX package.

Inputs are made with numpy from a seed and fed to both packages:

* ``double_grad``: identity forward, doubled gradient;
* ``kernel_tensorized`` and ``kernel_online`` (dense float64 paths at these
  sizes in both packages): values, potentials and gradients in a, x, b, y
  within 1e-10, for the gaussian, laplacian and energy kernels, a batch of
  2, and a user kernel (a torch callable and its jnp twin);
* ``kernel_multiscale`` (the JAX package's Pallas kernels in interpret
  mode, the port's plain twins): values within a tolerance scaled by the
  size of the three MMD terms, which nearly cancel, potentials, gradients
  in a, x, b, y at the float32 tolerances of
  ``tests/test_kernel_multiscale.py``; a user kernel over the kept tiles;
  the energy and ``truncate=None`` fallbacks within 1e-10;
* ``SamplesLoss`` routes the four kernel losses; ``hausdorff`` without a
  kernel fails as in the JAX package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomloss_tpu import SamplesLoss as JaxLoss
from geomloss_tpu.models import kernel_samples as jks
from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.models import kernel_samples as tks
from torch_parity_utils import _apply_weights64, p1_floor_bound

RTOL = 1e-10
BLUR = 0.1


def _clouds(N, M, seed, batch=None):
    """Centred clouds in the unit cube and random positive weights,
    float64."""
    rng = np.random.RandomState(seed)
    lead = () if batch is None else (batch,)
    x = rng.rand(*lead, N, 3) - 0.5
    y = rng.rand(*lead, M, 3) - 0.4
    a = rng.rand(*lead, N) + 0.2
    b = rng.rand(*lead, M) + 0.2
    return a / a.sum(-1, keepdims=True), x, b / b.sum(-1, keepdims=True), y


def _cauchy(x, y, blur=0.05):
    sq = ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1)
    return 1.0 / (1.0 + sq / blur**2)


def _jcauchy(x, y, blur=0.05):
    sq = ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1)
    return 1.0 / (1.0 + sq / blur**2)


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


def _close(got, expected, rtol, atol=None):
    expected = _np(expected)
    if atol is None:
        atol = rtol * np.abs(expected).max()
    np.testing.assert_allclose(_np(got), expected, rtol=rtol, atol=atol)


def _jax_run(fn, a, x, b, y, **kw):
    """JAX value and gradients in (a, x, b, y), and the potentials (under
    ``jax.jit``: one compilation instead of one per operation)."""
    args = tuple(map(jnp.asarray, (a, x, b, y)))
    value, grads = jax.jit(jax.value_and_grad(lambda *t: fn(*t, **kw).sum(), argnums=(0, 1, 2, 3)))(*args)
    return value, grads, jax.jit(lambda *t: fn(*t, potentials=True, **kw))(*args)


def _torch_run(fn, a, x, b, y, **kw):
    leaves = [torch.tensor(v, requires_grad=True) for v in (a, x, b, y)]
    value = fn(*leaves, **kw).sum()
    grads = torch.autograd.grad(value, leaves)
    return value, grads, fn(*(t.detach() for t in leaves), potentials=True, **kw)


def test_double_grad():
    x = torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64, requires_grad=True)
    w = torch.tensor([0.5, 1.5, -1.0], dtype=torch.float64)
    y = tks.double_grad(x)
    assert torch.equal(y, x.detach())
    (g,) = torch.autograd.grad((y * w).sum(), x)
    assert torch.equal(g, 2 * w)
    jg = jax.grad(lambda v: (jks.double_grad(v) * jnp.asarray(_np(w))).sum())(jnp.asarray(_np(x)))
    np.testing.assert_array_equal(_np(g), np.asarray(jg))


@pytest.mark.parametrize("name", ["gaussian", "laplacian", "energy", "custom"])
@pytest.mark.parametrize("route", ["tensorized", "online"])
def test_dense_routes_match_jax(route, name):
    """Both packages take dense float64 kernel matrices at these sizes, on a
    batch of two problems; a user kernel runs densely on both routes."""
    a, x, b, y = _clouds(120, 140, seed=len(name), batch=2)
    jfn, tfn = getattr(jks, f"kernel_{route}"), getattr(tks, f"kernel_{route}")
    jkw = dict(blur=BLUR, name=None if name == "custom" else name, kernel=_jcauchy if name == "custom" else None)
    tkw = dict(jkw, kernel=_cauchy if name == "custom" else None)
    jv, jg, (jF, jG) = _jax_run(jfn, a, x, b, y, **jkw)
    tv, tg, (tF, tG) = _torch_run(tfn, a, x, b, y, **tkw)
    _close(tv, jv, RTOL)
    _close(tF, jF, RTOL)
    _close(tG, jG, RTOL)
    for g, h in zip(tg, jg):
        _close(g, h, RTOL)


def _terms(a, x, b, y, name):
    """The three MMD terms, 1/2 <a, Kxx a>, 1/2 <b, Kyy b>, <a, Kxy b>, in
    float64 (dense)."""
    k = tks.kernel_routines[name]
    xx, yy, xy = (k(torch.tensor(p), torch.tensor(q), blur=BLUR).numpy() for p, q in ((x, x), (y, y), (x, y)))
    return 0.5 * a @ xx @ a, 0.5 * b @ yy @ b, a @ xy @ b


def _floor_shift(a, x, b, y):
    """Bound on what the Pallas p = 1 noise floor changes in a laplacian MMD
    value (``torch_parity_utils.p1_floor_bound`` with phi = psi = 0, eps =
    blur): the self terms' self pairs, 1/2 sum_i a_i^2 (1 - exp(-1e-4 /
    blur)) each, and any near pair."""
    zx, zy = np.zeros(len(x)), np.zeros(len(y))
    fxx = p1_floor_bound(x, x, zx, zx, a[:, None], BLUR, "gibbs")[:, 0]
    fyy = p1_floor_bound(y, y, zy, zy, b[:, None], BLUR, "gibbs")[:, 0]
    fxy = p1_floor_bound(x, y, zx, zy, b[:, None], BLUR, "gibbs")[:, 0]
    return 0.5 * a @ fxx + 0.5 * b @ fyy + a @ fxy, (fxx, fyy, fxy)


@pytest.fixture(scope="module", params=["gaussian", "laplacian", "custom"])
def multiscale_runs(request):
    """One multiscale solve of each package (value, gradients, potentials)
    at N = 2000, M = 2100 (tiles of 512, truncate = 3): the JAX one runs its
    Pallas kernels in interpret mode."""
    name = request.param
    a, x, b, y = _clouds(2000, 2100, seed=len(name))
    kw = dict(blur=BLUR, truncate=3)
    if name == "custom":
        jkw, tkw = dict(kw, kernel=_jcauchy), dict(kw, kernel=_cauchy)
    else:
        jkw = tkw = dict(kw, name=name)
    return name, (a, x, b, y), _jax_run(jks.kernel_multiscale, a, x, b, y, **jkw), _torch_run(
        tks.kernel_multiscale, a, x, b, y, **tkw
    )


def test_multiscale_value_matches_jax(multiscale_runs):
    """Loss within 1e-5 of the size of its terms (the MMD is their small
    difference: a relative error of the loss would measure the
    cancellation), plus for the laplacian the Pallas noise-floor shift."""
    name, (a, x, b, y), (jv, _, _), (tv, _, _) = multiscale_runs
    if name == "custom":
        # A user kernel: both packages evaluate it in float64 over the
        # same kept tiles.
        _close(tv, jv, 1e-12)
        return
    txx, tyy, txy = _terms(a, x, b, y, name)
    atol = 1e-5 * (txx + tyy + abs(txy))
    if name == "laplacian":
        atol += _floor_shift(a, x, b, y)[0]
    assert abs(float(tv) - float(jv)) <= atol, (float(tv), float(jv), atol)


def test_multiscale_gradients_match_jax(multiscale_runs):
    """Gradients in a, x, b, y at the tolerance of
    tests/test_kernel_multiscale.py (rtol 1e-3, atol 1e-3 of the largest
    entry)."""
    name, _, (_, jg, _), (_, tg, _) = multiscale_runs
    for g, h in zip(tg, jg):
        _close(g, h, 1e-12 if name == "custom" else 1e-3)


def test_multiscale_potentials_match_jax(multiscale_runs):
    """Potentials F = K_xx a - K_xy b and G = K_yy b - K_yx a, in the user's
    point order, within 1e-5 of the size of their two terms, plus twice
    the float32 error of the Pallas kernels' expansion-form distances
    carried through each weight (``torch_parity_utils.apply_tolerance``),
    plus the laplacian floor shift."""
    name, (a, x, b, y), (_, _, (jF, jG)), (_, _, (tF, tG)) = multiscale_runs
    if name == "custom":
        _close(tF, jF, 1e-12)
        _close(tG, jG, 1e-12)
        return
    k = tks.kernel_routines[name]
    t = torch.tensor
    size_F = k(t(x), t(x), blur=BLUR).numpy() @ a + k(t(x), t(y), blur=BLUR).numpy() @ b
    size_G = k(t(y), t(y), blur=BLUR).numpy() @ b + k(t(y), t(x), blur=BLUR).numpy() @ a
    p = 2 if name == "gaussian" else 1
    dW = {}
    for key, (u, v) in {"xx": (x, x), "xy": (x, y), "yy": (y, y), "yx": (y, x)}.items():
        dW[key] = 2 * _apply_weights64(u, v, np.zeros(len(u)), np.zeros(len(v)), BLUR**p, p, "gibbs")[1]
    atol_F = 1e-5 * size_F + dW["xx"] @ a + dW["xy"] @ b
    atol_G = 1e-5 * size_G + dW["yy"] @ b + dW["yx"] @ a
    if name == "laplacian":
        _, (fxx, fyy, fxy) = _floor_shift(a, x, b, y)
        zx, zy = np.zeros(len(x)), np.zeros(len(y))
        fyx = p1_floor_bound(y, x, zy, zx, a[:, None], BLUR, "gibbs")[:, 0]
        atol_F, atol_G = atol_F + fxx + fxy, atol_G + fyy + fyx
    assert np.all(np.abs(_np(tF) - _np(jF)) <= atol_F)
    assert np.all(np.abs(_np(tG) - _np(jG)) <= atol_G)


def test_multiscale_custom_kernel_truncates():
    """A user kernel runs over the kept tiles, not densely: a compactly
    supported kernel with a small radius gives its dense value, through
    the gather-based sparse matvec (three calls: xx, yy, xy)."""
    a, x, b, y = _clouds(1500, 1600, seed=5)
    calls = []
    real = tks._kernel_matvec_sparse_custom

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    def bump(x, y, blur=0.05):
        sq = ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1)
        return torch.clamp(1.0 - sq / blur**2, min=0.0)

    tks._kernel_matvec_sparse_custom = spy
    try:
        t = [torch.tensor(v) for v in (a, x, b, y)]
        trunc = tks.kernel_multiscale(*t, blur=0.25, kernel=bump, kernel_radius=0.25)
    finally:
        tks._kernel_matvec_sparse_custom = real
    assert len(calls) == 3
    dense = tks.kernel_tensorized(*(v[None] for v in t), blur=0.25, kernel=bump)[0]
    _close(trunc, dense, 1e-10)


@pytest.mark.parametrize("case", ["energy", "truncate_none"])
def test_multiscale_fallbacks_match_jax(case):
    """The energy kernel and ``truncate=None`` take the exact streaming
    route in both packages (dense at this size): within 1e-10."""
    a, x, b, y = _clouds(300, 320, seed=7)
    kw = dict(blur=BLUR, name="energy") if case == "energy" else dict(blur=BLUR, name="gaussian", truncate=None)
    jv, jg, (jF, jG) = _jax_run(jks.kernel_multiscale, a, x, b, y, **kw)
    tv, tg, (tF, tG) = _torch_run(tks.kernel_multiscale, a, x, b, y, **kw)
    _close(tv, jv, RTOL)
    _close(tF, jF, RTOL)
    _close(tG, jG, RTOL)
    for g, h in zip(tg, jg):
        _close(g, h, RTOL)


@pytest.mark.parametrize("loss", ["gaussian", "laplacian", "energy", "hausdorff"])
def test_samples_loss_routes_kernel_losses(loss):
    """The front end's auto route (tensorized at this size) and the online
    route give JAX's value; ``hausdorff`` needs ``kernel=``: without it
    both packages fail on the missing named kernel."""
    a, x, b, y = _clouds(80, 90, seed=3)
    kernel = (_cauchy, _jcauchy) if loss == "hausdorff" else (None, None)
    for backend in ("auto", "online"):
        jv = jax.jit(JaxLoss(loss, blur=BLUR, kernel=kernel[1], backend=backend))(*map(jnp.asarray, (a, x, b, y)))
        tv = SamplesLoss(loss, blur=BLUR, kernel=kernel[0], backend=backend)(*map(torch.tensor, (a, x, b, y)))
        _close(tv, jv, RTOL)
    if loss == "hausdorff":
        with pytest.raises(KeyError):
            JaxLoss("hausdorff", blur=BLUR)(*map(jnp.asarray, (a, x, b, y)))
        with pytest.raises(KeyError):
            SamplesLoss("hausdorff", blur=BLUR)(*map(torch.tensor, (a, x, b, y)))
