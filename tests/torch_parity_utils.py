"""Shared inputs and tolerances of the port's kernel tests.

Imports no JAX, so that the card-only tests that use it run where JAX is
not installed.
"""

import numpy as np
import torch

# Value tolerances of tests/test_pallas_kernels.py (LSE and step values):
VAL_TOL = dict(rtol=2e-5, atol=2e-5)

#: The p = 1 noise floor, a property of the JAX package's Pallas kernels:
#: they set a pair's distance to 0 where its squared distance, computed in
#: the expansion form, lies below 2e-6 (|x|^2 + |y|^2). The port computes
#: distances from coordinate differences and takes sqrt(max(sq, 1e-8)), as
#: the JAX dense path does, so a self pair has distance sqrt(1e-8) = 1e-4
#: where the Pallas kernels have 0. A softmin value S_i = -eps log sum_j
#: w_ij then moves by at most eps * (1e-4 / eps) = 1e-4, for any eps: the
#: bound every p = 1 comparison of a symmetric (debias) problem with the
#: Pallas kernels adds to its tolerance.
P1_FLOOR_SHIFT = 1e-4

APPLY_KINDS = [
    (2, "gibbs"),
    (2, "gibbs_grad"),
    (1, "gibbs"),
    (1, "gibbs_grad"),
    (1, "energy"),
    (1, "inv_dist"),
]


def problem(N, M, D=3, seed=0):
    """float32 clouds in the unit cube and a standard normal dual vector."""
    rng = np.random.RandomState(seed)
    x = rng.rand(N, D).astype(np.float32)
    y = rng.rand(M, D).astype(np.float32)
    h = rng.randn(M).astype(np.float32)
    return x, y, h


def potentials(N, M, seed):
    """Small potentials and uniform log-weights for the absorbed steps."""
    rng = np.random.RandomState(seed)
    f = (0.05 * rng.randn(N)).astype(np.float32)
    g = (0.05 * rng.randn(M)).astype(np.float32)
    la = np.full(N, -np.log(N), np.float32)
    lb = np.full(M, -np.log(M), np.float32)
    return f, g, la, lb


def kept_table(n_tiles, m_tiles, cap, seed, sym=False):
    """A kept-tile table ``(cols, counts)`` (numpy int32) from a random keep
    score: ragged counts, every row and every column tile kept at least
    once; symmetric scores for ``sym``."""
    from geomloss_tpu_torch.ops.block_sparse import _cols_from_score

    rng = np.random.RandomState(seed)
    score = rng.rand(n_tiles, m_tiles) - 0.45
    score[np.arange(m_tiles) % n_tiles, np.arange(m_tiles)] += 2
    if sym:
        score = score + score.T + 2 * np.eye(n_tiles)
    cols, counts, _ = _cols_from_score(torch.tensor(score), cap)
    return cols.numpy(), counts.numpy()


def tensors(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _apply_weights64(x, y, phi, psi, eps, p, kind):
    """float64 weights of an apply, and the float32 error ``dW`` of the
    expansion form ``|x|^2 + |y|^2 - 2<x,y>`` carried through them."""
    xn, yn = x.astype(np.float64), y.astype(np.float64)
    sq = ((xn[:, None, :] - yn[None, :, :]) ** 2).sum(-1)
    d = np.sqrt(sq)
    dsq = 4 * 2.0**-23 * ((xn**2).sum(-1)[:, None] + (yn**2).sum(-1)[None, :])
    dd = np.maximum(d, 1e-3)
    if kind == "energy":
        return -d, dsq / (2 * dd)
    if kind == "inv_dist":
        W = np.where(sq > 1e-6, 1.0 / dd, 0.0)
        return W, W * dsq / (2 * dd**2)
    C = d if p == 1 else sq / 2
    W = np.exp(phi.astype(np.float64)[:, None] + psi[None, :] - C / eps)
    dW = W * (dsq / (2 * dd * eps) if p == 1 else dsq / (2 * eps))
    if kind == "gibbs_grad" and p == 1:
        W = np.where(sq > 1e-6, W / dd, 0.0)
        dW = np.where(sq > 1e-6, dW / dd + W * dsq / (2 * dd**2), 0.0)
    return W, dW


def apply_exact(x, y, phi, psi, V, eps, p, kind):
    """float64 ground truth of an apply, and the tolerance of
    tests/test_pallas_kernels.py against it: the float32 error of a
    cancelling sum depends on the summation order, so atol scales with
    ``max_i sum_j |w_ij| |V_j|``."""
    W, _ = _apply_weights64(x, y, phi, psi, eps, p, kind)
    V64 = V.astype(np.float64)
    scale = (np.abs(W) @ np.abs(V64)).max()
    return W @ V64, dict(rtol=2e-3, atol=3e-5 * scale)


def apply_tolerance(x, y, phi, psi, V, eps, p, kind):
    """rtol and (per-entry) atol between two float32 applies.

    The tolerance of :func:`apply_exact`, plus twice the float32 error of
    the expansion form (a few ulps of ``|x|^2 + |y|^2``) carried through
    each kind's weight: the Pallas kernels use that form for every kind,
    the port for p=2 only. It matters where ``1/d`` amplifies it
    (``inv_dist``, p=1 ``gibbs_grad``).
    """
    W, dW = _apply_weights64(x, y, phi, psi, eps, p, kind)
    absV = np.abs(V.astype(np.float64))
    scale = (np.abs(W) @ absV).max()
    return dict(rtol=2e-3, atol=3e-5 * scale + 2 * (dW @ absV))


def assert_apply_close(got, expected, rtol, atol):
    got = got.detach().cpu().numpy().astype(np.float64)
    expected = np.asarray(expected, np.float64)
    excess = np.abs(got - expected) - (atol + rtol * np.abs(expected))
    assert np.all(excess <= 0), f"max excess {excess.max()} at {np.argmax(excess)}"


def p1_floor_bound(x, y, phi, psi, V, eps, kind):
    """Per-row bound ``(N, 1)`` on what the Pallas p = 1 noise floor
    (:data:`P1_FLOOR_SHIFT`) changes in an apply ``sum_j w_ij V_j``.

    Where the Pallas kernels take a pair's distance as 0, the port takes
    ``d = max(|x_i - y_j|, 1e-4)``: a weight ``exp(phi_i + psi_j - d/eps)``
    then falls short of the Pallas one by at most ``exp(phi_i + psi_j) (1 -
    exp(-d/eps))``, which for a kernel value ``exp(-d/blur)`` and a self
    pair is ``1 - exp(-1e-4/blur)``, about ``1e-4/blur``. The pairs taken
    are those within twice the Pallas threshold, ``|x_i - y_j|^2 <= 4e-6
    (|x_i|^2 + |y_j|^2)``, a margin for the float32 error of its expansion
    form; ``gibbs_grad`` divides by the distance above its cut.
    """
    xn, yn = x.astype(np.float64), y.astype(np.float64)
    sq = ((xn[:, None, :] - yn[None, :, :]) ** 2).sum(-1)
    near = sq <= 4e-6 * ((xn**2).sum(-1)[:, None] + (yn**2).sum(-1)[None, :])
    d = np.maximum(np.sqrt(sq), 1e-4)
    W0 = np.exp(phi.astype(np.float64)[:, None] + psi.astype(np.float64)[None, :])
    dW = np.where(near, W0 * -np.expm1(-d / eps), 0.0)
    if kind == "gibbs_grad":
        dW = np.where(sq > 1e-6, dW / d, 0.0)
    return dW @ np.abs(V.astype(np.float64))
