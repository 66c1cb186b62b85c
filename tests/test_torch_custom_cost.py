"""Custom costs under the port's multiscale backend, against the JAX package.

A user cost callable ``(B, N, D), (B, M, D) -> (B, N, M)`` replaces the
built-in ``|x-y|^p / p``: the coarse phase streams it, the truncation
tables evaluate it between cluster centroids, and the fine phase runs a
gather-based truncated LSE with plain autograd (``lse_sparse_custom``; no
kernel, as in the JAX package). Both packages run the same solve at
N = M = 2048 in float64 on the same clouds (numpy, from a seed), with two
costs written once in each framework: ``|x-y|^2 / 2``, which must also
give the built-in p = 2 solve on the keep rule a custom cost takes (the
cluster centroids alone; the built-in cost's default subtracts the
blocks' seam radii), and ``|x-y|^1.5``, which is not built in.
The JAX custom path is plain XLA in float64 here, so the two packages
differ only by the order of float64 sums: value within 1e-10 relative,
gradient within 1e-8 relative L2.
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
from geomloss_tpu_torch.models.multiscale import sinkhorn_multiscale
from geomloss_tpu_torch.ops import block_sparse as tbs

N = 2048
KW = dict(p=2, blur=0.05, diameter=2.0, scaling=0.5, tile=128, target_clusters=128)


def _sq(X, Y):
    return ((X[:, :, None, :] - Y[:, None, :, :]) ** 2).sum(-1)


COSTS = {
    "half_sqdist": (lambda X, Y: _sq(X, Y) / 2, lambda X, Y: _sq(X, Y) / 2),
    # |x - y|^1.5, smoothed at 0 so that a self pair's gradient is 0:
    "dist_1.5": (lambda X, Y: (_sq(X, Y) + 1e-12) ** 0.75, lambda X, Y: (_sq(X, Y) + 1e-12) ** 0.75),
}


def _clouds(seed, n=N):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3)
    y = rng.rand(n, 3) + 0.1
    a = rng.rand(n) + 0.5
    b = rng.rand(n) + 0.5
    return a / a.sum(), x, b / b.sum(), y


def _port(a, x, b, y, **kw):
    xt = torch.tensor(x, requires_grad=True)
    v = sinkhorn_multiscale(torch.tensor(a), xt, torch.tensor(b), torch.tensor(y), **kw)
    (g,) = torch.autograd.grad(v, xt)
    return v.item(), g.numpy()


def _rel(got, ref):
    return np.linalg.norm(np.asarray(got) - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("name", list(COSTS))
def test_custom_cost_matches_jax(monkeypatch, name):
    jcost, tcost = COSTS[name]
    a, x, b, y = _clouds(seed=11)
    aj, bj, yj = map(jnp.asarray, (a, b, y))
    jv, jg = jax.value_and_grad(lambda x: jax_multiscale(aj, x, bj, yj, cost=jcost, **KW))(jnp.asarray(x))
    v, g = _port(a, x, b, y, cost=tcost, **KW)
    assert abs(v - float(jv)) <= 1e-10 * abs(float(jv))
    assert _rel(g, np.asarray(jg)) <= 1e-8
    if name == "half_sqdist":
        # The built-in p = 2 cost, through the block-sparse twins, on the
        # keep rule a custom cost takes (the centroids alone: the built-in
        # cost's default also subtracts the cluster blocks' seam radii):
        build = tms.masks_from_coarse
        monkeypatch.setattr(tms, "masks_from_coarse", lambda *a_, **k: build(*a_, **dict(k, eps_min=math.inf)))
        v2, g2 = _port(a, x, b, y, impl="blocked", **KW)
        assert abs(v - v2) <= 1e-10 * abs(v2)
        assert _rel(g, g2) <= 1e-8


def test_custom_cost_untruncated_matches_jax():
    """truncate=None: the fine phase streams the custom cost on whole clouds."""
    jcost, tcost = COSTS["dist_1.5"]
    a, x, b, y = _clouds(seed=12, n=1024)
    aj, bj, yj = map(jnp.asarray, (a, b, y))
    jv, jg = jax.value_and_grad(
        lambda x: jax_multiscale(aj, x, bj, yj, cost=jcost, truncate=None, **KW)
    )(jnp.asarray(x))
    v, g = _port(a, x, b, y, cost=tcost, truncate=None, **KW)
    assert abs(v - float(jv)) <= 1e-10 * abs(float(jv))
    assert _rel(g, np.asarray(jg)) <= 1e-8


def test_custom_cost_never_takes_the_mid_phase(monkeypatch):
    """Above N_FINE_OK a custom cost still runs the two-scale descent."""
    monkeypatch.setattr(tms, "N_FINE_OK", 512)

    def boom(*args, **kwargs):
        raise AssertionError("the mid phase ran")

    monkeypatch.setattr(tms, "run_mid_phase", boom)
    _, tcost = COSTS["half_sqdist"]
    a, x, b, y = _clouds(seed=13, n=1024)
    v, g = _port(a, x, b, y, cost=tcost, **KW)
    assert np.isfinite(v) and np.isfinite(g).all()


def test_samples_loss_routes_custom_cost_to_multiscale():
    _, tcost = COSTS["dist_1.5"]
    a, x, b, y = _clouds(seed=14, n=1024)
    T = torch.tensor
    loss = SamplesLoss("sinkhorn", p=2, blur=0.05, diameter=2.0, scaling=0.5, cost=tcost, backend="multiscale")
    v = loss(T(a), T(x), T(b), T(y))
    expected = sinkhorn_multiscale(T(a), T(x), T(b), T(y), p=2, blur=0.05, diameter=2.0, scaling=0.5, cost=tcost)
    assert torch.equal(v, expected)


@pytest.mark.parametrize("chunk_elems", [None, 1])
def test_lse_sparse_custom_chunks_and_gradient(monkeypatch, chunk_elems):
    """The chunked gather LSE equals the dense masked LSE, and its
    gradient (checkpointed chunks) equals autograd through the dense one;
    ``chunk_elems=1`` runs one row tile per chunk."""
    if chunk_elems is not None:
        monkeypatch.setattr(tbs, "CUSTOM_CHUNK_ELEMS", chunk_elems)
    rng = np.random.RandomState(4)
    block, nI, nJ, cap = 32, 4, 6, 3
    x = torch.tensor(rng.rand(nI * block, 2), requires_grad=True)
    y, h = torch.tensor(rng.rand(nJ * block, 2)), torch.tensor(rng.randn(nJ * block))
    cols = torch.tensor(np.stack([rng.permutation(nJ)[:cap] for _ in range(nI)]), dtype=torch.int32)
    cnt = torch.tensor([1, 3, 2, 3], dtype=torch.int32)
    cost = COSTS["dist_1.5"][1]
    out = tbs.lse_sparse_custom(x, y, h, 0.2, cols, cnt, cost, block)
    (gx,) = torch.autograd.grad(out.sum(), x)

    keep = torch.zeros(nI, nJ, dtype=torch.bool)
    for I in range(nI):
        keep[I, cols[I, : cnt[I]].long()] = True
    mask = keep.repeat_interleave(block, 0).repeat_interleave(block, 1)
    x2 = x.detach().clone().requires_grad_(True)
    dense = torch.logsumexp(torch.where(mask, h[None, :] - cost(x2[None], y[None])[0] / 0.2, -1e30), dim=1)
    (gd,) = torch.autograd.grad(dense.sum(), x2)
    torch.testing.assert_close(out, dense, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gx, gd, rtol=1e-12, atol=1e-12)
