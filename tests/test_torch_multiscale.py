"""The port's multiscale Sinkhorn solve against the JAX package.

``sinkhorn_multiscale`` of both packages on the same clouds (numpy, from a
seed) at N = M = 2048, with 128-point tiles and 128 coarse clusters so that
the truncation prunes: the port in float64 through the plain twins of its
kernels, the JAX package as its own tests run it on the CPU (the banded
walk kernels in interpret mode). On the JAX package's coarse keep rule both
solves visit the same kept tile pairs; the JAX kernels compute in float32,
which sets the tolerances. The port's default rule (seam radii) is held to
its own float64 solve on tables of every tile.

The port-only checks hold the truncated solve against the exact fine
phase (``truncate=None``) at the bounds of
``tests/test_samples_loss_golden.py``, and exercise the unbalanced,
``potentials=True``, labels and ``SamplesLoss`` routes.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomloss_tpu.models.multiscale import sinkhorn_multiscale as jax_multiscale
from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.models import multiscale as tms
from geomloss_tpu_torch.models import samples_loss
from geomloss_tpu_torch.models.multiscale import sinkhorn_multiscale
from torch_parity_utils import P1_FLOOR_SHIFT

N = 2048
KW = dict(blur=0.05, diameter=2.0, scaling=0.5, tile=128, target_clusters=128)


def _clouds(seed, n=N):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3)
    y = rng.rand(n, 3) + 0.1
    a = rng.rand(n) + 0.5
    b = rng.rand(n) + 0.5
    return a / a.sum(), x, b / b.sum(), y


def _port(a, x, b, y, **kw):
    """Value and gradient in x of the port's solve, float64, plain twins."""
    xt = torch.tensor(x, requires_grad=True)
    v = sinkhorn_multiscale(torch.tensor(a), xt, torch.tensor(b), torch.tensor(y), impl="blocked", **kw)
    v.backward()
    return v.item(), xt.grad.numpy()


@pytest.fixture(scope="module")
def jax_solves():
    """The two JAX solves of this file (each ~25 s in interpret mode)."""
    out = {}
    for p in (2, 1):
        a, x, b, y = _clouds(seed=p)
        aj, bj, yj = map(jnp.asarray, (a, b, y))
        v, g = jax.value_and_grad(lambda x: jax_multiscale(aj, x, bj, yj, p=p, **KW))(jnp.asarray(x))
        out[p] = float(v), np.asarray(g)
    return out


def _rel(got, ref):
    return np.linalg.norm(np.asarray(got) - ref) / np.linalg.norm(ref)


def _jax_coarse_rule(monkeypatch):
    """The classic path's coarse tables on the JAX package's keep rule
    (``masks_from_coarse`` at an infinite slack: the centroids alone)."""
    build = tms.masks_from_coarse
    monkeypatch.setattr(tms, "masks_from_coarse", lambda *a, **k: build(*a, **dict(k, eps_min=math.inf)))


@pytest.mark.parametrize("p", [2, 1])
def test_multiscale_matches_jax(jax_solves, monkeypatch, p):
    """On the JAX package's coarse keep rule, the port's solve against
    JAX's. The port's default rule subtracts the cluster blocks' seam radii
    and keeps more tiles: its solve is held to the same float64 solve whose
    coarse tables keep every tile (value 1e-5 relative, gradient 1e-3
    relative L2; measured 1.8e-6 and 3.2e-4 at p = 2, 2.4e-7 and 2.6e-6 at
    p = 1), which the JAX rule misses by 7.6e-6 and 1.33e-3 at p = 2."""
    jv, jg = jax_solves[p]
    clouds = _clouds(seed=p)
    v_default, g_default = _port(*clouds, p=p, **KW)
    build = tms.masks_from_coarse
    _jax_coarse_rule(monkeypatch)
    v, g = _port(*clouds, p=p, **KW)
    # The JAX fine phase and extrapolation run in float32 (its banded
    # kernels cast): values within 1e-5 relative, gradients within 1e-4
    # relative L2. For p=1 the JAX kernels' noise floor moves each debias
    # potential by at most P1_FLOOR_SHIFT (torch_parity_utils), the value
    # by at most twice that, and the gradient (measured 2.1e-4) gets a
    # bound of 1e-3.
    assert abs(v - jv) <= 1e-5 * abs(jv) + (2 * P1_FLOOR_SHIFT if p == 1 else 0.0)
    assert _rel(g, jg) <= (1e-4 if p == 2 else 1e-3)
    monkeypatch.setattr(tms, "masks_from_coarse", lambda *a, **k: build(*a[:8], 1e6, *a[9:], **k))
    v_all, g_all = _port(*clouds, p=p, **KW)
    assert abs(v_default - v_all) <= 1e-5 * abs(v_all)
    assert _rel(g_default, g_all) <= 1e-3


@pytest.mark.parametrize("reach", [None, 0.5])
def test_truncated_matches_exact_fine_phase(reach):
    """Truncated against truncate=None at the bounds of
    tests/test_samples_loss_golden.py: value rtol 1e-3, gradient rtol 1e-2
    (here in relative L2: at N = 2048 the gradient's entries are ~1e-5,
    where the golden test's atol of 1e-6 is not small), balanced and
    unbalanced."""
    clouds = _clouds(seed=3)
    v, g = _port(*clouds, reach=reach, **KW)
    v_x, g_x = _port(*clouds, reach=reach, truncate=None, **KW)
    np.testing.assert_allclose(v, v_x, rtol=1e-3, atol=1e-7)
    assert _rel(g, g_x) <= 1e-2


def test_potentials_in_user_order():
    """potentials=True de-sorts to the user's order (with padding: 2000
    points in 2048 slots): <a, F> + <b, G> is the debiased value for
    non-uniform weights, and F, G are within 5e-2 (relative L2) of the
    tensorized solve's potentials, where a misplaced de-sort is off by
    ~1.4 (the coarse warm start leaves ~2e-2)."""
    a, x, b, y = _clouds(seed=4, n=2000)
    T = lambda *v: [torch.tensor(u) for u in v]  # noqa: E731
    F, G = sinkhorn_multiscale(*T(a, x, b, y), potentials=True, **KW)
    value = sinkhorn_multiscale(*T(a, x, b, y), **KW)
    assert F.shape == (2000,) and G.shape == (2000,)
    np.testing.assert_allclose((torch.tensor(a) * F).sum() + (torch.tensor(b) * G).sum(), value, rtol=1e-10)
    dense = SamplesLoss("sinkhorn", p=2, blur=0.05, diameter=2.0, scaling=0.5, potentials=True, backend="tensorized")
    Ft, Gt = dense(*T(a, x, b, y))
    assert _rel(F, Ft.numpy()) <= 5e-2 and _rel(G, Gt.numpy()) <= 5e-2


def test_labels_form():
    """The 6-argument form with cluster labels runs the multiscale backend
    with label-coherent blocks: close to the exact (truncate=None) solve."""
    a, x, b, y = _clouds(seed=6)
    lx = (x[:, 0] > 0.5).astype(np.int64)
    ly = (y[:, 1] > 0.6).astype(np.int64)
    loss = SamplesLoss("sinkhorn", p=2, blur=0.05, diameter=2.0, scaling=0.5)
    T = torch.tensor
    v = loss(T(lx), T(a), T(x), T(ly), T(b), T(y))
    v_x = sinkhorn_multiscale(T(a), T(x), T(b), T(y), truncate=None, **KW)
    assert torch.isfinite(v)
    np.testing.assert_allclose(v.item(), v_x.item(), rtol=1e-3)


@pytest.mark.parametrize("backend,n", [("multiscale", 50), ("auto", 10_001)])
def test_samples_loss_routes_to_multiscale(monkeypatch, backend, n):
    """backend="multiscale", and "auto" above 1e8 pairs (p = 2, D <= 3),
    call sinkhorn_multiscale on the unbatched clouds."""
    seen = {}

    def solve(a, x, b, y, **kw):
        seen.update(shapes=(a.shape, x.shape, b.shape, y.shape), p=kw["p"])
        return sinkhorn_multiscale(a[:50], x[:50], b[:50], y[:50], **kw)

    monkeypatch.setitem(samples_loss.routines["sinkhorn"], "multiscale", solve)
    _, x, _, y = _clouds(seed=7, n=n)
    v = SamplesLoss("sinkhorn", backend=backend, p=2, blur=0.05, diameter=2.0)(torch.tensor(x), torch.tensor(y))
    assert seen == dict(shapes=((n,), (n, 3), (n,), (n, 3)), p=2)
    assert v.ndim == 0 and torch.isfinite(v)


#: (N_FINE_OK, N, M, seed) -> (loss, the gradient's L2 norm, its projection
#: on uniform(0.5, 1.5) weights from the seed, the mid phase's runs), on the
#: JAX package's keep rules. The losses are those recorded bit for bit
#: before the prologue of sinkhorn_multiscale moved into multiscale_prologue
#: (shared with the row-sharded solve), 0x1.ef869a650aeacp-7 and
#: 0x1.23fc6a108d58ap-6, to 5 and 3 ulps: CPUs of other vector units, or
#: ATEN_CPU_CAPABILITY=default, sum in another order and move the last digits.
PROLOGUE_FLOATS = {
    (1 << 20, 1500, 1700, 0): (0.015122247112308558, 0.004483461143127144, -0.27726593377269426, 0),
    (512, 2000, 1900, 2): (0.017821410731092825, 0.004283336154157108, -0.3092978078267792, 1),
}


@pytest.mark.parametrize("case", list(PROLOGUE_FLOATS))
def test_prologue_refactor_changes_no_float(monkeypatch, case):
    """SamplesLoss("sinkhorn", backend="multiscale"), classic and with the
    mid path forced (N_FINE_OK lowered), p = 2, float64: the loss within
    1e-12 relative, the gradient's norm and seeded projection within
    1e-10 relative of the values recorded on the tree before the refactor.
    The tables are built with the keep rules of that tree, the JAX
    package's: the classic path's coarse tables by the centroids alone
    (``masks_from_coarse`` at an infinite slack), the mid path's fine
    tables by the sub-blocks' centroids (``build_tile_masks`` at an
    infinite slack); the port's default rules keep more tiles
    (tests/test_torch_coarse_keep_rule.py, tests/test_torch_mid_keep_rule.py).
    The mid case's extrapolations run on whole clouds (too few source
    points to truncate), so ``extrap_cols`` is not reached."""
    n_fine_ok, n, m, seed = case
    monkeypatch.setattr(tms, "N_FINE_OK", n_fine_ok)
    _jax_coarse_rule(monkeypatch)
    build = tms.build_tile_masks
    monkeypatch.setattr(tms, "build_tile_masks", lambda *a, **k: build(*a, **dict(k, eps_min=math.inf)))
    mid_runs = []
    run_mid = tms.run_mid_phase
    monkeypatch.setattr(tms, "run_mid_phase", lambda *a, **k: mid_runs.append(1) or run_mid(*a, **k))
    rng = np.random.RandomState(seed)
    x, y = rng.rand(n, 3), rng.rand(m, 3) + 0.1
    a, b = rng.rand(n) + 0.5, rng.rand(m) + 0.5
    a, x, b, y = (torch.tensor(v) for v in (a / a.sum(), x, b / b.sum(), y))
    x.requires_grad_(True)
    v = SamplesLoss("sinkhorn", p=2, blur=0.05, scaling=0.5, backend="multiscale")(a, x, b, y)
    (g,) = torch.autograd.grad(v, x)
    u = torch.tensor(np.random.RandomState(seed).uniform(0.5, 1.5, tuple(g.shape)))
    value, norm, proj, mids = PROLOGUE_FLOATS[case]
    assert len(mid_runs) == mids
    np.testing.assert_allclose(v.item(), value, rtol=1e-12, atol=0)
    np.testing.assert_allclose(torch.linalg.vector_norm(g).item(), norm, rtol=1e-10, atol=0)
    np.testing.assert_allclose((u * g).sum().item(), proj, rtol=1e-10, atol=0)
