"""The port's grid Sinkhorn divergences against the JAX package, in
float64.

``sinkhorn_divergence`` at 16^2 (blur one pixel and 0.1, p in
{1, 2}, reach None and 0.5, debias on and off, potentials), and
``ImagesLoss`` / ``VolumesLoss`` at 16^2 and 8^3, batched and unbatched:
the same inputs (numpy, from a seed) through both packages, values and
gradients within 1e-10 (``torch_jax_parity``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomloss_tpu import ImagesLoss as JaxImagesLoss
from geomloss_tpu import VolumesLoss as JaxVolumesLoss
from geomloss_tpu import sinkhorn_divergence as jax_divergence
from geomloss_tpu_torch import ImagesLoss, VolumesLoss, sinkhorn_divergence
from geomloss_tpu_torch.utils import from_numpy, to_numpy
from torch_jax_parity import assert_solve_parity, close

RTOL = 1e-10


def densities(shape, seed):
    """Sums of three Gaussian bumps on the unit grid, a few pixels set to
    zero (the ``log_dens`` clamp), normalized per batch entry."""
    rng = np.random.RandomState(seed)
    B, grid = shape[0], shape[1:]
    axes = np.meshgrid(*[np.arange(n) / n for n in grid], indexing="ij")
    out = np.zeros(shape)
    for i in range(B):
        for _ in range(3):
            c, s = rng.rand(len(grid)), 0.08 + 0.1 * rng.rand()
            out[i] += rng.rand() * np.exp(-sum((x - ci) ** 2 for x, ci in zip(axes, c)) / (2 * s**2))
    out[(slice(None),) + (0,) * len(grid)] = 0.0
    return out / out.reshape(B, -1).sum(-1).reshape((B,) + (1,) * len(grid))


# --- sinkhorn_divergence ---------------------------------------------------------


@pytest.mark.parametrize("debias", [True, False])
@pytest.mark.parametrize("reach", [None, 0.5])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("blur", [None, 0.1])
def test_sinkhorn_divergence_matches_jax(blur, p, reach, debias):
    """16^2 images, batch of 2; blur one pixel (a jump at each level on the
    way) and 0.1 (the last jump at the last iteration, and an extra
    iteration at the final eps); values and gradients in both densities."""
    kw = dict(p=p, blur=blur, reach=reach, debias=debias)
    a, b = densities((2, 16, 16), p), densities((2, 16, 16), 10 + p)
    assert_solve_parity(
        lambda a, b: jax_divergence(a, b, **kw), lambda a, b: sinkhorn_divergence(a, b, **kw),
        [a, b], rtol=RTOL, argnums=(0, 1),
    )


@pytest.mark.parametrize("debias", [True, False])
def test_sinkhorn_divergence_potentials_match_jax(debias):
    kw = dict(p=2, blur=0.1, reach=0.5, debias=debias, potentials=True)
    a, b = densities((2, 16, 16), 3), densities((2, 16, 16), 4)
    F, G = assert_solve_parity(
        lambda a, b: jax_divergence(a, b, **kw), lambda a, b: sinkhorn_divergence(a, b, **kw), [a, b], rtol=RTOL
    )
    assert F.shape == G.shape == (2, 16, 16)


def test_raw_potentials_match_jax():
    """``_return_raw_potentials``: the four potentials and eps, for ``ot``;
    the densities and potentials cross between the packages as numpy
    (``utils.interop``)."""
    a, b = densities((1, 16, 16), 5), densities((1, 16, 16), 6)
    jpot, jeps = jax.jit(lambda a, b: jax_divergence(a, b, blur=0.1, _return_raw_potentials=True))(a, b)
    ta, tb = from_numpy((a, b), device="cpu")
    tpot, teps = sinkhorn_divergence(ta, tb, blur=0.1, _return_raw_potentials=True)
    assert teps == jeps
    for t, j in zip(to_numpy(tpot), jpot):
        close(t, j, RTOL)


def test_sinkhorn_divergence_refusals_match_jax():
    a = torch.ones(1, 4, 4) / 16
    for kw, exc in ((dict(scaling=0.4), ValueError), (dict(cost=lambda x, y: x), NotImplementedError)):
        with pytest.raises(exc) as je:
            jax_divergence(jnp.asarray(a.numpy()), jnp.asarray(a.numpy()), **kw)
        with pytest.raises(exc) as te:
            sinkhorn_divergence(a, a, **kw)
        assert str(te.value) == str(je.value)


# --- ImagesLoss / VolumesLoss ---------------------------------------------------------


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("cls", ["images", "volumes"])
def test_loss_modules_match_jax(cls, batched):
    """16^2 images (p = 2, blur one pixel) and 8^3 volumes (p = 1, blur 0.2,
    reach 0.3), batched (2) or single; values and gradients."""
    if cls == "images":
        shape, kw, T, J = (2, 16, 16), dict(p=2), ImagesLoss, JaxImagesLoss
    else:
        shape, kw, T, J = (2, 8, 8, 8), dict(p=1, blur=0.2, reach=0.3), VolumesLoss, JaxVolumesLoss
    a, b = densities(shape, 7), densities(shape, 8)
    if not batched:
        a, b = a[0], b[0]
    loss = T(**kw)
    assert isinstance(loss, torch.nn.Module)
    got = assert_solve_parity(lambda a, b: J(**kw)(a, b), loss, [a, b], rtol=RTOL, argnums=(0, 1))
    assert got.shape == ((2,) if batched else ())


def test_loss_modules_refusals_match_jax():
    a = np.ones((2, 3, 4, 4)) / 16
    with pytest.raises(ValueError) as je:
        JaxImagesLoss()(jnp.asarray(a), jnp.asarray(a))
    with pytest.raises(ValueError) as te:
        ImagesLoss()(torch.tensor(a), torch.tensor(a))
    assert str(te.value) == str(je.value)
    with pytest.raises(NotImplementedError, match="loss='sinkhorn'"):
        VolumesLoss("gaussian")
    F, G = ImagesLoss(potentials=True, blur=0.1)(*(torch.tensor(densities((1, 8, 8), s)[0]) for s in (1, 2)))
    assert F.shape == G.shape == (8, 8)
