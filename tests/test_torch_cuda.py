"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device: the ``cuda_device`` fixture skips it
otherwise. The file imports no JAX, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

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

pytestmark = pytest.mark.cuda

# Square, ragged and multi-tile shapes (the kernels' tiles are 256 wide):
SHAPES = [(64, 96), (513, 1025), (1000, 777), (4099, 2053)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    ck.build()
    return torch.device("cuda")


def _counted(name, fn):
    before = ck.launch_counts[name]
    out = fn()
    torch.cuda.synchronize()
    assert ck.launch_counts[name] > before
    return out


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_lse_kernel_matches_twin(cuda_device, p, shape):
    N, M = shape
    x, y, h = tensors(*problem(N, M, seed=N + p), device=cuda_device)
    got = _counted("lse", lambda: ck.lse(x, y, h, 0.21, p))
    torch.testing.assert_close(got, ck.lse_blocked(x, y, h, 0.21, p), **VAL_TOL)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_sinkhorn_step_kernel_matches_twin(cuda_device, p, shape):
    N, M = shape
    x, y, _ = problem(N, M, seed=3 * N + p)
    t = tensors(x, y, *potentials(N, M, seed=N), device=cuda_device)
    got = _counted("sinkhorn_step", lambda: ck.sinkhorn_step(*t, 0.21, p))
    for a, b in zip(got, ck.sinkhorn_step_blocked(*t, 0.21, p)):
        torch.testing.assert_close(a, b, **VAL_TOL)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("N", [64, 513, 4099])
def test_sinkhorn_step_sym_kernel_matches_twin(cuda_device, p, N):
    x, _, _ = problem(N, 1, seed=5 * N + p)
    f, _, la, _ = potentials(N, 1, seed=N + 1)
    t = tensors(x, f, la, device=cuda_device)
    got = _counted("sinkhorn_step_sym", lambda: ck.sinkhorn_step_sym(*t, 0.21, p))
    torch.testing.assert_close(got, ck.sinkhorn_step_sym_blocked(*t, 0.21, p), **VAL_TOL)


@pytest.mark.parametrize("p,kind", APPLY_KINDS)
@pytest.mark.parametrize("C", [1, 3, 4, 6])
def test_gibbs_apply_kernel_matches_twin(cuda_device, p, kind, C):
    N, M = 1000, 777
    x, y, psi = problem(N, M, seed=7 + C)
    rng = np.random.RandomState(8)
    phi = (-np.abs(rng.randn(N))).astype(np.float32)
    V = rng.randn(M, C).astype(np.float32)
    tol = apply_tolerance(x, y, phi, psi, V, 0.5, p, kind)
    t = tensors(x, y, phi, psi, V, device=cuda_device)
    got = _counted("gibbs_apply", lambda: ck.gibbs_apply(*t, 0.5, p, kind))
    assert_apply_close(got, ck.gibbs_apply_blocked(*t, 0.5, p, kind).cpu(), **tol)
    exact, exact_tol = apply_exact(x, y, phi, psi, V, 0.5, p, kind)
    assert_apply_close(got, exact, **exact_tol)


@pytest.mark.parametrize("D", [1, 2, 5])
def test_kernels_other_dims(cuda_device, D):
    """Point dimensions other than 3 (5 is zero-padded to the D=8 build)."""
    x, y, h = tensors(*problem(700, 300, D=D, seed=D), device=cuda_device)
    torch.testing.assert_close(ck.lse(x, y, h, 0.3, 2), ck.lse_blocked(x, y, h, 0.3, 2), **VAL_TOL)
