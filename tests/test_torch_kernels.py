"""The port's online kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of ``geomloss_tpu_torch.ops.cuda_kernels`` runs
its plain PyTorch twin; here it is held against the Pallas kernel it
replaces (interpret mode, which the JAX package selects off-TPU) on the
same float32 inputs, made with numpy from a seed, at the shapes and
tolerances of ``tests/test_pallas_kernels.py``. The CUDA kernels
themselves are held against their twins on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomloss_tpu.ops import pallas_kernels as pk
from geomloss_tpu_torch.ops import cuda_kernels as ck
from torch_parity_utils import (
    APPLY_KINDS,
    VAL_TOL,
    apply_exact,
    apply_tolerance,
    assert_apply_close,
    potentials,
    problem,
    tensors,
)

SHAPES = [(64, 96), (200, 300), (513, 1025)]
# Every weight kind at four channels (the ids the kinds alone had), and at
# one channel, which the CUDA apply kernels take unpadded; the distance
# kinds at p = 2 too (they ignore p).
APPLY_CASES = (
    [pytest.param(p, kind, 4, id=f"{p}-{kind}") for p, kind in APPLY_KINDS]
    + [pytest.param(p, kind, 1, id=f"{p}-{kind}-C1") for p, kind in APPLY_KINDS]
    + [pytest.param(2, kind, C, id=f"2-{kind}-C{C}") for kind in ("energy", "inv_dist") for C in (1, 4)]
)
# A column block of the twins small enough for several blocks and a
# ragged last one at every shape:
SMALL_BLOCK = 40


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_lse_twin_matches_pallas(p, shape):
    N, M = shape
    x, y, h = problem(N, M, seed=N + p)
    eps = 0.21
    expected = np.asarray(pk.lse_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(h), eps, p=p))
    xt, yt, ht = tensors(x, y, h)
    np.testing.assert_allclose(ck.lse(xt, yt, ht, eps, p).numpy(), expected, **VAL_TOL)
    np.testing.assert_allclose(
        ck.lse_blocked(xt, yt, ht, eps, p, block_m=SMALL_BLOCK).numpy(), expected, **VAL_TOL
    )


@pytest.mark.parametrize("p", [1, 2])
def test_lse_twin_zero_weight_columns_match_jax(p):
    """Columns of bias -inf (zero-weight points: the padding of the coarse
    and mid clouds) filling the twin's first column block and another one:
    the JAX package's streaming LSE gives the LSE of the other columns, and
    so does the twin (no inf - inf); rows whose every bias is -inf give
    -inf in both."""
    from geomloss_tpu.ops.softmin import lse_points

    N, M = 70, 7 * SMALL_BLOCK + 13
    x, y, h = problem(N, M, seed=5 + p)
    h[:SMALL_BLOCK] = -np.inf
    h[3 * SMALL_BLOCK : 4 * SMALL_BLOCK + 7] = -np.inf
    for hh in (h, np.full_like(h, -np.inf)):
        expected = np.asarray(lse_points(jnp.asarray(x), jnp.asarray(y), jnp.asarray(hh), 0.21, p, "scan"))
        got = ck.lse_blocked(*tensors(x, y, hh), 0.21, p, block_m=SMALL_BLOCK).numpy()
        assert not np.isnan(got).any()
        np.testing.assert_allclose(got, expected, **VAL_TOL)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_sinkhorn_step_twin_matches_pallas(p, shape):
    N, M = shape
    x, y, _ = problem(N, M, seed=3 * N + p)
    f, g, la, lb = potentials(N, M, seed=N)
    eps = 0.21
    S_xy, S_yx = pk.sinkhorn_step_pallas(*[jnp.asarray(a) for a in (x, y, f, g, la, lb)], eps, p=p)
    t = tensors(x, y, f, g, la, lb)
    for got_xy, got_yx in (
        ck.sinkhorn_step(*t, eps, p),
        ck.sinkhorn_step_blocked(*t, eps, p, block_m=SMALL_BLOCK),
    ):
        np.testing.assert_allclose(got_xy.numpy(), np.asarray(S_xy), **VAL_TOL)
        np.testing.assert_allclose(got_yx.numpy(), np.asarray(S_yx), **VAL_TOL)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("N", [n for n, _ in SHAPES])
def test_sinkhorn_step_sym_twin_matches_pallas(p, N):
    x, _, _ = problem(N, 1, seed=5 * N + p)
    f, _, la, _ = potentials(N, 1, seed=N + 1)
    eps = 0.21
    expected = np.asarray(
        pk.sinkhorn_step_sym_pallas(jnp.asarray(x), jnp.asarray(f), jnp.asarray(la), eps, p=p)
    )
    xt, ft, lat = tensors(x, f, la)
    np.testing.assert_allclose(ck.sinkhorn_step_sym(xt, ft, lat, eps, p).numpy(), expected, **VAL_TOL)
    np.testing.assert_allclose(
        ck.sinkhorn_step_sym_blocked(xt, ft, lat, eps, p, block_m=SMALL_BLOCK).numpy(),
        expected,
        **VAL_TOL,
    )


@pytest.mark.parametrize("p,kind,C", APPLY_CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_gibbs_apply_twin_matches_pallas(p, kind, C, shape):
    N, M = shape
    x, y, psi = problem(N, M, seed=7 + N)
    rng = np.random.RandomState(8)
    phi = (-np.abs(rng.randn(N))).astype(np.float32)
    V = rng.randn(M, 4).astype(np.float32)[:, :C]
    eps = 0.5
    expected = np.asarray(
        pk.gibbs_apply_pallas(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(phi), jnp.asarray(psi),
            jnp.asarray(V), eps, p=p, kind=kind,
        )
    )
    tol = apply_tolerance(x, y, phi, psi, V, eps, p, kind)
    exact, exact_tol = apply_exact(x, y, phi, psi, V, eps, p, kind)
    t = tensors(x, y, phi, psi, V)
    for got in (ck.gibbs_apply(*t, eps, p, kind), ck.gibbs_apply_blocked(*t, eps, p, kind, block_m=SMALL_BLOCK)):
        # Against the Pallas kernel, whose expansion-form distances carry
        # float32 noise, and against the float64 ground truth at the
        # tolerance of tests/test_pallas_kernels.py.
        assert_apply_close(got, expected, **tol)
        assert_apply_close(got, exact, **exact_tol)


def test_gibbs_grad_noise_floor_sliver_no_inf():
    """p=1 gibbs_grad weights in the sliver 1e-6 < sq <= 2e-6 (|x|^2+|y|^2)
    must not divide by the zeroed noise-floor distance."""
    rng = np.random.RandomState(0)
    base = rng.randn(256, 3).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    y = base + 1.2e-3 * rng.randn(256, 3).astype(np.float32)
    z = np.zeros(256, np.float32)
    t = tensors(base, y, z, z, np.ones((256, 1), np.float32))
    out = ck.gibbs_apply(*t, 0.3, 1, "gibbs_grad")
    assert bool(torch.isfinite(out).all())


def test_unknown_kind_raises():
    x, y, h = tensors(*problem(4, 5))
    with pytest.raises(ValueError, match="kind"):
        ck.gibbs_apply(x, y, h[:4], h, y, 0.1, 2, "gauss")


def test_wrappers_on_cpu_count_no_launch():
    """On CPU tensors a wrapper runs its twin: no kernel launch is counted."""
    ck.reset_launch_counts()
    x, y, h = tensors(*problem(30, 20))
    f, g, la, lb = tensors(*potentials(30, 20, seed=0))
    ck.lse(x, y, h, 0.3)
    ck.sinkhorn_step(x, y, f, g, la, lb, 0.3)
    ck.sinkhorn_step_sym(x, f, la, 0.3)
    ck.gibbs_apply(x, y, f, g, y, 0.3)
    assert all(n == 0 for n in ck.launch_counts.values())


_SIZES = [1, 2, 255, 256, 257, 4099, 100_000, 100_003, 1_000_000, 10**7, 10**8, 2**31 // 8]


@pytest.mark.parametrize("N", _SIZES)
def test_step_scratch_is_bounded_by_the_plan(N):
    """The chunk plans of the two step kernels, from the shapes alone: every
    launch's scratch stays under STEP_SCRATCH_BYTES plus O(N + M) (the
    column partials of one row block when they exceed the budget, the row
    partials of the launched row blocks) plus a constant (the row partials
    of at most 1024, or 8192, blocks per launch), the slices cover the
    columns, and the grids stay within CUDA's limits."""
    budget = ck.STEP_SCRATCH_BYTES
    rng = np.random.RandomState(N % 1000)
    for M in _SIZES + [int(m) for m in rng.randint(1, 2**28, 5)]:
        R, S, width = ck.step_plan(N, M)
        nb = -(-N // 256)
        assert 1 <= R <= nb and 1 <= S <= 65535
        assert width % 256 == 0 and (S - 1) * width < M <= S * width
        assert ck.step_scratch_bytes(N, M) <= budget + 4 * (N + M) + (1 << 20) + 1024
    R, S = ck.sym_step_plan(N)
    assert 1 <= R <= nb and 1 <= S <= min(nb, 65535)
    assert ck.sym_step_scratch_bytes(N) <= budget + 8 * (N + 256) + (8 << 20) + 1024
    # At N = M = 1e6, room for the wrappers' O(N + M) tensors under the
    # 256 MB that tests/test_torch_cuda.py measures on the card:
    assert ck.step_scratch_bytes(1_000_000, 1_000_000) <= 150e6
    assert ck.sym_step_scratch_bytes(1_000_000) <= 150e6
