"""Host-side code of the register-tiled pair blocks (kernels 2-6 and 8):
the packed points every one of them reads, and the channel groups of the
apply kernels 4 and 8.

No JAX, no card: the packing is checked against float64 scores computed
from the unpacked points.
"""

import math

import numpy as np
import pytest
import torch

from geomloss_tpu_torch.ops import cuda_kernels as ck


def _packed(D, p, seed, N=7, M=11, eps=0.3, cols_to=1):
    rng = np.random.RandomState(seed)
    x, y = rng.randn(N, D), rng.randn(M, D)
    phi, psi = rng.randn(N), rng.randn(M)
    packed = ck._pair_vectors(*(torch.tensor(a, dtype=torch.float32) for a in (x, y, phi, psi)), eps, p,
                              cols_to=cols_to)
    return (x, y, phi, psi), packed


def _scores(xv, yv, rb, cb, eps, p):
    """Base-2 log weights of every pair as the kernels form them from the
    packed points (in float64)."""
    xv, yv, rb, cb = (t.double() for t in (xv, yv, rb, cb))
    if p == 2:
        return rb[:, None] + xv @ yv.T
    sq = ((xv[:, None, :] - yv[None, :, :]) ** 2).sum(-1)
    return rb[:, None] + cb[None, :] - ck.LOG2E / eps * torch.sqrt(torch.clamp(sq, min=1e-8))


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("D", range(1, 10))
def test_packed_scores_match_float64(D, p):
    """p = 2 rows ``[c2 x, 0.., 1]`` against columns ``[y, 0.., bias]``,
    p = 1 the coordinates and the biases apart: every pair's score is
    ``log2(e) (phi_i + psi_j - C(x_i, y_j) / eps)``."""
    eps = 0.3
    (x, y, phi, psi), (xv, yv, rb, cb, kv) = _packed(D, p, seed=10 * D + p, eps=eps)
    assert kv == math.ceil((D + 1 if p == 2 else D) / 4)
    assert xv.shape == (7, 4 * kv) and yv.shape == (11, 4 * kv) and xv.is_contiguous() and yv.is_contiguous()
    diff = x[:, None, :] - y[None, :, :]
    cost = (diff**2).sum(-1) / 2 if p == 2 else np.sqrt((diff**2).sum(-1))
    ref = torch.tensor(ck.LOG2E * (phi[:, None] + psi[None, :] - cost / eps))
    # float32 packing: a few ulps of the largest term (|x|^2 c2 / 2 ~ 40).
    torch.testing.assert_close(_scores(xv, yv, rb, cb, eps, p), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("D", [1, 3, 8])
def test_padded_columns_weigh_zero(D, p):
    """Columns padded to a multiple of ``cols_to`` (kernel 2's stages) have
    bias -inf, so their weights are 0; the real columns are unchanged."""
    _, (xv, yv, rb, cb, kv) = _packed(D, p, seed=D, cols_to=8)
    _, (xv1, yv1, rb1, cb1, kv1) = _packed(D, p, seed=D)
    assert yv.shape == (16, 4 * kv) and cb.shape == (16,) and kv == kv1
    assert torch.equal(xv, xv1) and torch.equal(rb, rb1)
    assert torch.equal(yv[:11], yv1) and torch.equal(cb[:11], cb1)
    assert torch.isinf(cb[11:]).all() and (cb[11:] < 0).all()
    w = torch.exp2(_scores(xv, yv, rb, cb, 0.3, p))
    assert torch.isfinite(w[:, :11]).all() and (w[:, :11] > 0).all()
    assert torch.equal(w[:, 11:], torch.zeros(7, 5, dtype=w.dtype))


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("D", range(1, 13))
def test_symmetric_packing_scores(D, p):
    """Kernel 3 packs one cloud twice, as rows and as columns padded to whole
    tiles of 256: every pair (i, j) scores the float64 absorbed
    ``log2(e) (phi_i + phi_j - C(x_i, x_j) / eps)``, and the padded columns
    weigh 0."""
    N, eps = 300, 0.3
    rng = np.random.RandomState(D + 20 * p)
    x, phi = rng.randn(N, D), rng.randn(N)
    xt, pt = torch.tensor(x, dtype=torch.float32), torch.tensor(phi, dtype=torch.float32)
    xv, yv, rb, cb, kv = ck._pair_vectors(xt, xt, pt, pt, eps, p, cols_to=256)
    assert xv.shape == (N, 4 * kv) and yv.shape == (512, 4 * kv) and cb.shape == (512,)
    sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    # p = 1 floors the squared distance at 1e-8, as the twins do: the
    # diagonal's cost is 1e-4, not 0.
    cost = sq / 2 if p == 2 else np.sqrt(np.maximum(sq, 1e-8))
    ref = torch.tensor(ck.LOG2E * (phi[:, None] + phi[None, :] - cost / eps))
    scores = _scores(xv, yv, rb, cb, eps, p)
    torch.testing.assert_close(scores[:, :N], ref, rtol=0, atol=1e-4)
    assert torch.equal(torch.exp2(scores[:, N:]), torch.zeros(N, 512 - N, dtype=scores.dtype))
    assert torch.isfinite(scores[:, :N]).all()


@pytest.mark.parametrize("C,groups", [(1, (1, 1)), (2, (4, 4)), (4, (4, 4)), (5, (4, 8)), (8, (4, 8)), (9, (4, 12)),
                                      (33, (4, 36))])
def test_kernel8_channel_groups(C, groups):
    """The apply kernels (4 and 8) take one channel alone (no padding to
    four) and any other count in zero-padded groups of four; the groups,
    each applied on its own and put back together, give the apply of V."""
    ch, Cp = ck._channel_groups(C)
    assert (ch, Cp) == groups
    rng = np.random.RandomState(C)
    N, M = 50, 70
    x, y = torch.tensor(rng.rand(N, 3)), torch.tensor(rng.rand(M, 3))
    phi, psi = torch.tensor(-np.abs(rng.randn(N))), torch.tensor(0.1 * rng.randn(M))
    V = torch.tensor(rng.randn(M, C))
    v = ck._group_channels(V)
    assert v.shape == (Cp // ch, M, ch) and v.dtype == torch.float32 and v.is_contiguous()
    for k in range(Cp):
        want = V[:, k].float() if k < C else torch.zeros(M)
        assert torch.equal(v[k // ch, :, k % ch], want)
    assert torch.equal(ck._ungroup_channels(v, C), V.float())
    for p, kind in [(2, "gibbs"), (1, "energy")]:
        out = torch.stack([ck.gibbs_apply_blocked(x, y, phi, psi, vg.double(), 0.3, p, kind) for vg in v])
        torch.testing.assert_close(ck._ungroup_channels(out, C),
                                   ck.gibbs_apply_blocked(x, y, phi, psi, V.float().double(), 0.3, p, kind),
                                   rtol=1e-12, atol=1e-12)


def test_step_sums_twin_is_the_step_twin():
    """``sinkhorn_step_blocked`` is the raw sums of ``_step_sums`` (on the
    CPU: its twin) read through the floored update."""
    rng = np.random.RandomState(0)
    x, y = (torch.tensor(rng.rand(n, 3)) for n in (40, 30))
    f, g = torch.tensor(0.05 * rng.randn(40)), torch.tensor(0.05 * rng.randn(30))
    la, lb = torch.full((40,), -math.log(40.0), dtype=torch.float64), torch.full((30,), -math.log(30.0),
                                                                                  dtype=torch.float64)
    r, c = ck._step_sums(x, y, f, g, la, lb, 0.1, 2)
    S_xy, S_yx = ck.sinkhorn_step_blocked(x, y, f, g, la, lb, 0.1, 2)
    torch.testing.assert_close(S_xy, ck._absorbed_update(f, la, 0.1, r), rtol=0, atol=0)
    torch.testing.assert_close(S_yx, ck._absorbed_update(g, lb, 0.1, c), rtol=0, atol=0)
