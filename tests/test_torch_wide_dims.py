"""Point dimensions above the kernels' compiled widths, and where the
kernels are built.

``SamplesLoss`` on the online backend at D = 32 (the auto route sends
D > 3 above 5000^2 pairs there), Sinkhorn and the gaussian MMD, against
the JAX package in float64 with the tolerances of
``test_torch_sinkhorn_samples.py``; the points as the kernels read them
(raw for the LSE kernels, packed float4 vectors for the others, kernel 12
among them: staged up to three vectors a point, read from global memory
above); and the choice of the build directory.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomloss_tpu import SamplesLoss as JaxLoss
from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
from geomloss_tpu_torch.ops import cuda_kernels as ck

VAL_RTOL = 1e-10
GRAD_RTOL = 1e-8
D_WIDE = 32


def _clouds(N, M, D, seed):
    rng = np.random.RandomState(seed)
    return rng.rand(N, D), rng.rand(M, D) + 0.1


def _close(got, expected, rtol):
    got, expected = got.detach().numpy(), np.asarray(expected)
    np.testing.assert_allclose(got, expected, rtol=rtol, atol=rtol * np.abs(expected).max())


def _value_and_grad(loss, jloss, x, y):
    jv, jg = jax.jit(jax.value_and_grad(lambda x: jloss(x, jnp.asarray(y))))(jnp.asarray(x))
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    tv = loss(xt, torch.tensor(y))
    tv.backward()
    return tv, xt.grad, jv, jg


@pytest.mark.parametrize("p", [1, 2])
def test_sinkhorn_online_at_wide_dim_matches_jax(p):
    x, y = _clouds(150, 170, D_WIDE, seed=p)
    kw = dict(p=p, blur=0.5, diameter=3.0, scaling=0.7, backend="online")
    tv, tg, jv, jg = _value_and_grad(SamplesLoss("sinkhorn", **kw), JaxLoss("sinkhorn", **kw), x, y)
    _close(tv, jv, VAL_RTOL)
    _close(tg, jg, GRAD_RTOL)


def test_gaussian_mmd_online_at_wide_dim_matches_jax():
    x, y = _clouds(150, 170, D_WIDE, seed=3)
    kw = dict(blur=1.0, backend="online")
    tv, tg, jv, jg = _value_and_grad(SamplesLoss("gaussian", **kw), JaxLoss("gaussian", **kw), x, y)
    _close(tv, jv, VAL_RTOL)
    _close(tg, jg, GRAD_RTOL)


# D -> (row stride of the LSE kernels' points at p = 2: raw up to three
# float4s, D + 1 floats, else padded to whole float4s; the float4 vectors
# of kernel 12's packed points at p = 2 and at p = 1: staged up to three).
PADDED = {1: (1, 1, 1), 3: (3, 1, 1), 9: (9, 3, 3), 17: (20, 5, 5), 64: (68, 17, 16)}


@pytest.mark.parametrize("D", sorted(PADDED))
def test_points_pad_any_dim(D):
    rng = np.random.RandomState(D)
    x = torch.tensor(rng.rand(5, D), dtype=torch.float64)
    y = torch.tensor(rng.rand(7, D), dtype=torch.float32)
    (xl, yl), ld, kv = ck._lse_points("test", x, y, p=2)
    assert ld == PADDED[D][0] and kv == -(-(D + 1) // 4)
    for got, src in ((xl, x), (yl, y)):
        assert got.dtype == torch.float32 and got.is_contiguous() and got.shape == (src.shape[0], ld)
        assert torch.equal(got[:, :D], src.float()) and not got[:, D:].any()
    # Kernels 2-6, 8 and 12: p = 2 rows [c2 x, 0..., 1], columns [y, 0...,
    # bias]; p = 1 the coordinates; zero-padded to kv float4 vectors, which
    # kernel 12 stages up to kStepStaged (3) and reads wider from global
    # memory (its wide form), as the wrapper's kv selects.
    phi, psi = torch.zeros(5, dtype=torch.float64), torch.ones(7, dtype=torch.float64)
    for p, width in ((2, D + 1), (1, D)):
        xv, yv, rb, cb, kv = cbs._pair_vectors(x, y, phi, psi, 0.5, p)
        assert kv == PADDED[D][3 - p] == -(-width // 4)
        assert xv.dtype == yv.dtype == torch.float32 and xv.is_contiguous() and yv.is_contiguous()
        assert xv.shape == (5, 4 * kv) and yv.shape == (7, 4 * kv)
        end = 4 * kv - (p == 2)
        assert not xv[:, D:end].any() and not yv[:, D:end].any()
        if p == 2:
            assert torch.equal(xv[:, -1], torch.ones(5)) and torch.equal(yv[:, -1], cb)
            torch.testing.assert_close(xv[:, :D], x.float() * (ck.LOG2E / 0.5))
        else:
            assert torch.equal(xv[:, :D], x.float()) and torch.equal(yv[:, :D], y)


def test_build_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(ck.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    assert ck.build_dir() == tmp_path / "kernels"


def test_build_dir_of_a_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv(ck.BUILD_DIR_ENV, raising=False)
    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path / "build" / "kernels")
    assert ck.build_dir() == tmp_path / "build" / "kernels"
    assert (tmp_path / "build" / "kernels").is_dir()


def test_build_dir_falls_back_to_the_user_cache(monkeypatch, tmp_path):
    """Where the checkout's directory cannot be written (here a path under
    a regular file, as an installed package's parent may be read-only),
    the kernels go to the user cache directory."""
    monkeypatch.delenv(ck.BUILD_DIR_ENV, raising=False)
    blocker = tmp_path / "site-packages"
    blocker.write_text("")
    monkeypatch.setattr(ck, "BUILD_DIR", blocker / "build" / "kernels")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert ck.build_dir() == tmp_path / "cache" / "geomloss_tpu_torch" / "kernels"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert ck.build_dir() == tmp_path / "home" / ".cache" / "geomloss_tpu_torch" / "kernels"
