"""The port's grid operators and clustering against the JAX package.

``ops/grid.py`` in float64 to 1e-10 (``softmin_grid`` in D = 1, 2, 3 and
p in {1, 2}, ``softmin_grid_coords`` on a periodic axis, ``pyramid`` and
``upsample`` with leading ``(B, K)`` axes, ``log_dens``, ``C_transform``),
``softmin_grid`` in float32 against its float64 form, the exact axis pass
(and the divergence on it) where the JAX package's matmul form
underflows, and ``ops/clustering.py``
against JAX's NumPy results, exactly. Inputs are numpy arrays from a seed.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from geomloss_tpu.ops import clustering as jclu
from geomloss_tpu import sinkhorn_divergence as jax_divergence
from geomloss_tpu.ops import grid as jgrid
from geomloss_tpu_torch import sinkhorn_divergence
from geomloss_tpu_torch.ops import clustering as tclu
from geomloss_tpu_torch.ops import grid as tgrid
from torch_jax_parity import assert_solve_parity, close
from torch_parity_utils import VAL_TOL

RTOL = 1e-10


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("shape", [(2, 8), (2, 8, 8), (2, 4, 4, 4)])
def test_softmin_grid_matches_jax(shape, p):
    h = np.random.RandomState(len(shape) + p).randn(*shape)
    assert_solve_parity(
        lambda h: jgrid.softmin_grid(0.07, p, h),
        lambda h: tgrid.softmin_grid(0.07, p, h),
        [h], rtol=RTOL, argnums=(0,),
    )


@pytest.mark.parametrize("p", [1, 2])
def test_softmin_grid_coords_periodic_matches_jax(p):
    """Explicit coordinates, the first axis a torus of period 1.3, over a
    (B, K) batch; gradients too."""
    rng = np.random.RandomState(p)
    h = rng.randn(2, 3, 7, 5)
    coords = (np.sort(rng.rand(7)) * 1.3, np.linspace(0.0, 0.8, 5))
    periods = (1.3, None)
    assert_solve_parity(
        lambda h: jgrid.softmin_grid_coords(0.05, p, h, coords, periods, D=2),
        lambda h: tgrid.softmin_grid_coords(0.05, p, h, coords, periods, D=2),
        [h], rtol=RTOL, argnums=(0,),
    )


@pytest.mark.parametrize("D", [1, 2, 3])
def test_pyramid_and_upsample_match_jax(D):
    """Sum pools down to one cell and x2 linear upsampling, over the last D
    axes of a (B, K, *grid) array; the 2D pools also against
    4 * avg_pool2d, as the JAX suite holds its own."""
    a = np.random.RandomState(D).rand(2, 3, *(8,) * D)
    tp = tgrid.pyramid(torch.tensor(a), D=D)
    jp = jgrid.pyramid(jnp.asarray(a), D=D)
    assert len(tp) == len(jp) == 4
    for t, j in zip(tp, jp):
        close(t, j, 1e-12)
    if D == 2:
        t = torch.tensor(a)
        for level in reversed(tp[:-1]):
            t = 4 * F.avg_pool2d(t, 2)
            close(level, t.numpy(), 1e-12)
    assert_solve_parity(
        lambda a: jgrid.upsample(a, D=D), lambda a: tgrid.upsample(a, D=D), [a], rtol=RTOL, argnums=(0,)
    )


def test_log_dens_zero_densities_match_jax():
    a = np.array([[0.0, 1e-40, 0.3, -0.2], [2.0, 0.0, 1e-10, 0.5]])
    close(tgrid.log_dens(torch.tensor(a)), jgrid.log_dens(jnp.asarray(a)), 0)
    assert tgrid.log_dens(torch.tensor(a))[0, 0].item() == -10000.0


@pytest.mark.parametrize("p", [1, 2])
def test_c_transform_matches_jax(p):
    G = np.random.RandomState(p).randn(2, 6, 5)
    close(tgrid.C_transform(torch.tensor(G), tau=0.8, p=p), jgrid.C_transform(jnp.asarray(G), tau=0.8, p=p), RTOL)


@pytest.mark.parametrize("eps", [1.0, 1 / 64])
@pytest.mark.parametrize("p", [1, 2])
def test_softmin_grid_float32_matches_float64(p, eps):
    """float32 against the float64 form, to the LSE tolerance of
    tests/test_pallas_kernels.py, at eps = 1 and at one pixel^2 of 64."""
    h = np.random.RandomState(p).randn(2, 64, 64)
    got = tgrid.softmin_grid(eps, p, torch.tensor(h, dtype=torch.float32))
    ref = tgrid.softmin_grid(eps, p, torch.tensor(h))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), ref, **VAL_TOL)


def test_softmin_grid_exact_where_the_jax_matmul_form_underflows():
    """At eps = one pixel^2 of 128, a ramp of 2,000 over the axis: the JAX
    package's ``m + log(exp(A - m) @ K.T)`` (one max per row) sums zeros
    for every output far below the row's max and returns its floor; the
    port takes one max per output entry and equals the dense float64 sum."""
    N = 128
    x = np.arange(N) / N
    h = np.stack([2000 * x, -2000 * x + np.sin(7 * x)])
    eps = 1 / N**2
    ref = -eps * np.array([[np.logaddexp.reduce(hr - (xi - x) ** 2 / (2 * eps)) for xi in x] for hr in h])
    close(tgrid.softmin_grid(eps, 2, torch.tensor(h)), ref, 1e-12)
    assert np.abs(np.asarray(jgrid.softmin_grid(eps, 2, jnp.asarray(h))) - ref).max() > 1e-3


def test_sinkhorn_divergence_converges_where_the_jax_form_underflows():
    """1D signals at blur one pixel, p = 2: from 128 samples the JAX
    package's per-row-max matmul form underflows and its divergence turns
    negative; the port's exact axis pass stays positive and converges with
    the resolution (within 2 % of its value at 1,024 samples), in float32
    within 1e-6 of float64."""
    x = {N: (np.arange(N) + 0.5) / N for N in (128, 256, 1024)}
    sig = {N: np.stack([np.exp(-((xs - c) ** 2) / (2 * s**2)) for c, s in ((0.3, 0.05), (0.6, 0.1))]) for N, xs in x.items()}
    a = {N: v / v.sum(-1, keepdims=True) for N, v in sig.items()}
    b = {N: v[::-1].copy() for N, v in a.items()}
    fine = sinkhorn_divergence(torch.tensor(a[1024]), torch.tensor(b[1024]))
    for N in (128, 256):
        got = sinkhorn_divergence(torch.tensor(a[N]), torch.tensor(b[N]))
        assert (got > 0).all() and ((got - fine).abs() <= 0.02 * fine).all()
        f32 = sinkhorn_divergence(*(torch.tensor(v[N], dtype=torch.float32) for v in (a, b)))
        assert ((f32.double() - got).abs() <= 1e-6 * got).all()
    assert (np.asarray(jax_divergence(jnp.asarray(a[128]), jnp.asarray(b[128]))) < 0).any()


def test_lse_axis_gradients():
    """The exact axis pass's backward (softmax weights recomputed by row
    chunk) against finite differences, in the rows and the log-kernel."""
    rng = np.random.RandomState(0)
    A = torch.tensor(rng.randn(5, 6), requires_grad=True)
    K_log = torch.tensor(-rng.rand(4, 6), requires_grad=True)
    assert torch.autograd.gradcheck(tgrid._LseAxis.apply, (A, K_log))


def test_lse_axis_chunks_give_the_same_floats(monkeypatch):
    """Row chunks of the exact pass: values and gradients bitwise equal to
    one chunk."""
    h = torch.tensor(np.random.RandomState(1).randn(3, 8, 8), requires_grad=True)
    outs = []
    for elems in (1 << 26, 64 * 5):
        monkeypatch.setattr(tgrid, "LSE_CHUNK_ELEMS", elems)
        v = tgrid.softmin_grid(0.01, 2, h)
        outs.append((v, *torch.autograd.grad(v.sin().sum(), h)))
    assert all(torch.equal(u, v) for u, v in zip(*outs))


def test_grid_cluster_and_ranges_match_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(300, 3)
    w = rng.rand(300)
    labels = tclu.grid_cluster(torch.tensor(x), 0.25)
    np.testing.assert_array_equal(labels, jclu.grid_cluster(x, 0.25))
    for t, j in zip(tclu.cluster_ranges_centroids(x, labels, w), jclu.cluster_ranges_centroids(x, labels, w)):
        np.testing.assert_array_equal(t, j)


def test_clusterize_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.rand(200, 2)
    a = rng.rand(200)
    (ta_c, ta_s), (tx_c, tx_s), t_ranges, t_perm = tclu.clusterize(a, torch.tensor(x), scale=0.3)
    (ja_c, ja_s), (jx_c, jx_s), j_ranges, j_perm = jclu.clusterize(a, x, scale=0.3)
    for t, j in ((ta_c, ja_c), (ta_s, ja_s), (tx_c, jx_c), (tx_s, jx_s), (t_perm, j_perm)):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(t_ranges, j_ranges)
    (a_list, x_list, ranges, perm) = tclu.clusterize(a, x, device="cpu")
    assert len(a_list) == len(x_list) == 1 and ranges == [] and perm is None
    np.testing.assert_array_equal(x_list[0].numpy(), x)
