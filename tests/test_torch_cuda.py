"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device: the ``cuda_device`` fixture skips it
otherwise. The file imports no JAX, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import json

import numpy as np
import pytest
import torch

from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
from geomloss_tpu_torch.ops import cuda_kernels as ck
from torch_parity_utils import (
    APPLY_KINDS,
    VAL_TOL,
    apply_exact,
    apply_tolerance,
    assert_apply_close,
    kept_table,
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
    cbs.build()
    return torch.device("cuda")


def _counted(name, fn, counts=ck.launch_counts):
    before = counts[name]
    out = fn()
    torch.cuda.synchronize()
    assert counts[name] > before
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


@pytest.mark.parametrize("p", [1, 2])
def test_step_kernels_in_chunks_match_twin(cuda_device, p, monkeypatch):
    """A small scratch budget: several launches of row blocks per call
    (3 for the fused step, 6 for the symmetric one)."""
    monkeypatch.setattr(ck, "STEP_SCRATCH_BYTES", 64 << 10)
    N, M = 4099, 2053
    x, y, _ = problem(N, M, seed=11 + p)
    t = tensors(x, y, *potentials(N, M, seed=12), device=cuda_device)
    for a, b in zip(ck.sinkhorn_step(*t, 0.21, p), ck.sinkhorn_step_blocked(*t, 0.21, p)):
        torch.testing.assert_close(a, b, **VAL_TOL)
    xs, fs, las = t[0], t[2], t[4]
    torch.testing.assert_close(
        ck.sinkhorn_step_sym(xs, fs, las, 0.21, p), ck.sinkhorn_step_sym_blocked(xs, fs, las, 0.21, p), **VAL_TOL
    )


def test_step_kernels_bounded_scratch_and_deterministic(cuda_device):
    """At N = M = 1e6 (p = 2) one call of either step kernel allocates less
    than 256 MB beyond its inputs, and two calls are bitwise equal."""
    N = 1_000_000
    x, y, _ = problem(N, N, seed=1)
    inputs = tensors(x, y, *potentials(N, N, seed=2), device=cuda_device)
    in_bytes = sum(t.numel() * t.element_size() for t in inputs)
    x, y, f, g, la, lb = inputs
    calls = {
        "sinkhorn_step": lambda: ck.sinkhorn_step(x, y, f, g, la, lb, 0.01, 2),
        "sinkhorn_step_sym": lambda: (ck.sinkhorn_step_sym(x, f, la, 0.01, 2),),
    }
    for name, call in calls.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        first = _counted(name, call)
        extra = torch.cuda.max_memory_allocated() - base
        assert extra < 256e6, (name, extra, in_bytes)
        for a, b in zip(first, call()):
            assert torch.equal(a, b), name


TILE_CASES = [
    # (tile, n_tiles, m_tiles, cap): one CTA row slice (128), two (512),
    # four (1024) and eight (2048, the auto route's tile above 2^23
    # points); ragged kept counts in every table.
    (128, 5, 7, 5),
    (512, 4, 6, 4),
    (1024, 3, 3, 2),
    (2048, 2, 3, 2),
]


def _tile_problem(tile, n_tiles, m_tiles, seed, tri, D=3):
    N, M = n_tiles * tile, (n_tiles if tri else m_tiles) * tile
    x, y, _ = problem(N, M, D=D, seed=seed)
    f, g, la, lb = potentials(N, M, seed=seed + 1)
    if tri:
        y, g, lb = x, f, la
    return x, y, f, g, la, lb


@pytest.mark.parametrize("tri", [False, True])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("case", TILE_CASES)
def test_absorbed_sum_tiles_kernel_matches_twin(cuda_device, case, p, tri):
    tile, n_tiles, m_tiles, cap = case
    x, y, f, g, la, lb = _tile_problem(tile, n_tiles, m_tiles, seed=tile + p, tri=tri)
    cols, counts = kept_table(n_tiles, n_tiles if tri else m_tiles, cap, seed=p, sym=tri)
    eps = 0.05
    phi, psi = la + f / eps, lb + g / eps
    t = tensors(x, y, phi, psi, device=cuda_device)
    table = tensors(cols, counts, device=cuda_device)
    args = (*t, eps, *table, p, tile, tri)
    got = _counted("absorbed_sum_tiles", lambda: cbs.absorbed_sum_tiles(*args), cbs.launch_counts)
    ref = cbs.absorbed_sum_tiles_blocked(*args)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **VAL_TOL)
    for a, b in zip(got, cbs.absorbed_sum_tiles(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tri", [False, True])
@pytest.mark.parametrize("p,kind", [(2, "gibbs"), (1, "gibbs"), (1, "gibbs_grad")])
@pytest.mark.parametrize("case", TILE_CASES)
def test_gibbs_apply_tiles_kernel_matches_twin(cuda_device, case, p, kind, tri):
    tile, n_tiles, m_tiles, cap = case
    x, y, f, g, la, lb = _tile_problem(tile, n_tiles, m_tiles, seed=3 * tile + p, tri=tri)
    cols, counts = kept_table(n_tiles, n_tiles if tri else m_tiles, cap, seed=p + 5, sym=tri)
    eps = 0.05
    phi, psi = la + f / eps, lb + g / eps
    # C = 4, as in the extrapolation backward: [1, y] and [1, x].
    Vy = np.concatenate([np.ones((y.shape[0], 1), np.float32), y], 1)
    Vx = np.concatenate([np.ones((x.shape[0], 1), np.float32), x], 1)
    t = tensors(x, y, phi, psi, Vy, Vx, device=cuda_device)
    table = tensors(cols, counts, device=cuda_device)
    args = (*t, eps, *table, p, kind, tile, tri)
    got = _counted("gibbs_apply_tiles", lambda: cbs.gibbs_apply_tiles(*args), cbs.launch_counts)
    ref = cbs.gibbs_apply_tiles_blocked(*args)
    # The online applies' tolerance against their twins, taken over all
    # pairs (an upper bound for the kept ones).
    assert_apply_close(got[0], ref[0].cpu(), **apply_tolerance(x, y, phi, psi, Vy, eps, p, kind))
    assert_apply_close(got[1], ref[1].cpu(), **apply_tolerance(y, x, psi, phi, Vx, eps, p, kind))
    for a, b in zip(got, cbs.gibbs_apply_tiles(*args)):
        assert torch.equal(a, b)


def _offset_shard(tile, n_tiles, shards, shard, seed, p):
    """One shard of a symmetric problem's triangle table: the rows of row
    tiles ``shard * n_l ..`` against the whole cloud, with their offset."""
    x, _, f, _, la, _ = _tile_problem(tile, n_tiles, n_tiles, seed=seed, tri=True)
    cols, counts = kept_table(n_tiles, n_tiles, n_tiles, seed=p, sym=True)
    n_l = n_tiles // shards
    rows, pts = slice(shard * n_l, (shard + 1) * n_l), slice(shard * n_l * tile, (shard + 1) * n_l * tile)
    phi = la + f / 0.05
    return x, phi, rows, pts, cols, counts, shard * n_l


@pytest.mark.parametrize("shard", [1, 3])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("tile", [128, 512])
def test_absorbed_sum_tiles_kernel_with_row_offset(cuda_device, tile, p, shard):
    """Kernel 5 on one shard (offset > 0) of a triangle table, as a rank of
    the row-sharded multiscale solve calls it: against its twin."""
    x, phi, rows, pts, cols, counts, off = _offset_shard(tile, 8, 4, shard, seed=tile + p, p=p)
    t = tensors(x[pts], x, phi[pts], phi, device=cuda_device)
    table = tensors(cols[rows], counts[rows], device=cuda_device)
    args = (*t, 0.05, *table, p, tile, True, off)
    got = _counted("absorbed_sum_tiles", lambda: cbs.absorbed_sum_tiles(*args), cbs.launch_counts)
    for a, b in zip(got, cbs.absorbed_sum_tiles_blocked(*args)):
        torch.testing.assert_close(a, b, **VAL_TOL)


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("shard", [1, 3])
@pytest.mark.parametrize("p,kind", [(2, "gibbs"), (1, "gibbs"), (1, "gibbs_grad")])
def test_gibbs_apply_tiles_kernel_with_row_offset(cuda_device, p, kind, shard, C):
    """Kernel 6 on one shard (offset > 0) of a triangle table, C = 1 and 4
    channels: against its twin."""
    tile = 128
    x, phi, rows, pts, cols, counts, off = _offset_shard(tile, 8, 4, shard, seed=7 * shard + p, p=p)
    V = np.concatenate([np.ones((x.shape[0], 1), np.float32), x], 1)[:, :C]
    t = tensors(x[pts], x, phi[pts], phi, V, V[pts], device=cuda_device)
    table = tensors(cols[rows], counts[rows], device=cuda_device)
    args = (*t, 0.05, *table, p, kind, tile, True, off)
    got = _counted("gibbs_apply_tiles", lambda: cbs.gibbs_apply_tiles(*args), cbs.launch_counts)
    ref = cbs.gibbs_apply_tiles_blocked(*args)
    assert_apply_close(got[0], ref[0].cpu(), **apply_tolerance(x[pts], x, phi[pts], phi, V, 0.05, p, kind))
    assert_apply_close(got[1], ref[1].cpu(), **apply_tolerance(x, x[pts], phi, phi[pts], V[pts], 0.05, p, kind))


@pytest.mark.parametrize("block_n,block_m", [(256, 128), (256, 512), (1024, 128), (1024, 512)])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_lse_tiles_kernel_matches_twin(cuda_device, D, p, block_n, block_m):
    """Kernel 7: 3 row tiles against 7 source tiles, ragged kept counts
    (block_m < 256 stages part of a shared-memory tile)."""
    n_tiles, m_tiles, cap = 3, 7, 5
    x, y, h = problem(n_tiles * block_n, m_tiles * block_m, D=D, seed=D + 10 * p + block_m)
    cols, counts = kept_table(n_tiles, m_tiles, cap, seed=D + p)
    assert counts.min() < counts.max()
    x, y, h, cols, counts = tensors(x, y, h, cols, counts, device=cuda_device)
    args = (x, y, h, 0.05 if p == 2 else 0.2, cols, counts, block_n, block_m, p)
    got = _counted("lse_tiles", lambda: cbs.lse_tiles(*args), cbs.launch_counts)
    torch.testing.assert_close(got, cbs.lse_tiles_blocked(*args), **VAL_TOL)
    assert torch.equal(got, cbs.lse_tiles(*args))


def test_lse_tiles_wrapper_raises_on_what_it_cannot_launch(cuda_device):
    x, y, h = tensors(*problem(512, 256, seed=1), device=cuda_device)
    cols = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    cnt = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        cbs.lse_tiles(x, y, h, 0.1, cols.cpu(), cnt, 256, 128)
    with pytest.raises(ValueError):
        cbs.lse_tiles(x, y, h, 0.1, cols, cnt, 300, 128)
    # D = 9, above the compiled widths, runs the wide instantiation.
    x9, y9, _ = tensors(*problem(512, 256, D=9, seed=2), device=cuda_device)
    args = (x9, y9, h, 0.1, cols, cnt, 256, 128)
    got = _counted("lse_tiles", lambda: cbs.lse_tiles(*args), cbs.launch_counts)
    torch.testing.assert_close(got, cbs.lse_tiles_blocked(*args), **VAL_TOL)


@pytest.mark.parametrize("tri", [False, True])
@pytest.mark.parametrize("case", TILE_CASES)
def test_tile_kernels_in_chunks_match_one_launch(cuda_device, case, tri, monkeypatch):
    """Kernels 5 and 6 with a scratch budget of two slots: many launches
    per call, the same sums as one launch within float32
    tolerance, and bitwise the same from one call to the next."""
    tile, n_tiles, m_tiles, cap = case
    x, y, f, g, la, lb = _tile_problem(tile, n_tiles, m_tiles, seed=5 * tile, tri=tri)
    cols, counts = kept_table(n_tiles, n_tiles if tri else m_tiles, cap, seed=9, sym=tri)
    eps = 0.05
    phi, psi = la + f / eps, lb + g / eps
    Vy = np.concatenate([np.ones((y.shape[0], 1), np.float32), y], 1)
    Vx = np.concatenate([np.ones((x.shape[0], 1), np.float32), x], 1)
    t = tensors(x, y, phi, psi, device=cuda_device)
    V = tensors(Vy, Vx, device=cuda_device)
    table = tensors(cols, counts, device=cuda_device)
    calls = {
        "absorbed_sum_tiles": lambda: cbs.absorbed_sum_tiles(*t, eps, *table, 2, tile, tri),
        "gibbs_apply_tiles": lambda: cbs.gibbs_apply_tiles(*t, *V, eps, *table, 2, "gibbs", tile, tri),
    }
    nsub = -(-tile // 256)
    for name, call in calls.items():
        one = call()
        G = 4 if name == "gibbs_apply_tiles" else 1
        monkeypatch.setattr(cbs, "TILES_SCRATCH_BYTES", 2 * 4 * G * tile * (1 + nsub))
        before = cbs.launch_counts[name]
        chunked = call()
        torch.cuda.synchronize()
        # The table is over the budget: chunks of two live slots.
        n_live = int(cbs.kept_pairs(table[0], table[1], tri).ge(0).sum())
        assert cbs.launch_counts[name] - before == -(-n_live // 2)
        for a, b in zip(chunked, one):
            torch.testing.assert_close(a, b, **VAL_TOL)
        for a, b in zip(chunked, call()):
            assert torch.equal(a, b)
        monkeypatch.undo()


@pytest.mark.parametrize("C", [1, 4, 5])
@pytest.mark.parametrize("block_n,block_m", [(128, 128), (256, 512), (512, 128), (1024, 256)])
@pytest.mark.parametrize("p,kind", APPLY_KINDS)
def test_gibbs_apply_sparse_kernel_matches_twin(cuda_device, p, kind, block_n, block_m, C):
    """Kernel 8: 3 row tiles against 5 source tiles, ragged kept counts,
    every weight kind (modes 0-4), channel groups of four."""
    n_tiles, m_tiles = 3, 5
    N, M = n_tiles * block_n, m_tiles * block_m
    x, y, psi = problem(N, M, seed=block_n + block_m + C)
    rng = np.random.RandomState(C)
    phi = (-np.abs(rng.randn(N))).astype(np.float32)
    V = rng.randn(M, C).astype(np.float32)
    cols, counts = kept_table(n_tiles, m_tiles, 4, seed=p + C)
    assert counts.min() < counts.max()
    eps = 0.5
    tol = apply_tolerance(x, y, phi, psi, V, eps, p, kind)
    args = (*tensors(x, y, phi, psi, V, device=cuda_device), eps, *tensors(cols, counts, device=cuda_device),
            p, kind, block_n, block_m)
    got = _counted("gibbs_apply_sparse", lambda: cbs.gibbs_apply_sparse(*args), cbs.launch_counts)
    assert_apply_close(got, cbs.gibbs_apply_sparse_blocked(*args).cpu(), **tol)
    assert torch.equal(got, cbs.gibbs_apply_sparse(*args))


@pytest.mark.parametrize("p", [1, 2])
def test_lse_sparse_runs_kernel_7(cuda_device, p):
    """``lse_sparse`` is ``lse_tiles``'s function on its CUDA kernel, with
    the JAX package's argument order, counted under its own name."""
    x, y, h = problem(3 * 256, 5 * 512, seed=p)
    cols, counts = kept_table(3, 5, 4, seed=p)
    x, y, h, cols, counts = tensors(x, y, h, cols, counts, device=cuda_device)
    before = dict(cbs.launch_counts)
    got = _counted("lse_sparse", lambda: cbs.lse_sparse(x, y, h, 0.1, cols, counts, p, 256, 512), cbs.launch_counts)
    assert cbs.launch_counts["lse_tiles"] == before["lse_tiles"]
    assert torch.equal(got, cbs.lse_tiles(x, y, h, 0.1, cols, counts, 256, 512, p))
    torch.testing.assert_close(got, cbs.lse_tiles_blocked(x, y, h, 0.1, cols, counts, 256, 512, p), **VAL_TOL)


def test_gibbs_apply_sparse_wrapper_raises_on_what_it_cannot_launch(cuda_device):
    x, y, _ = tensors(*problem(512, 256, seed=1), device=cuda_device)
    z_n, z_m = torch.zeros(512, device=cuda_device), torch.zeros(256, device=cuda_device)
    V = torch.ones(256, 2, device=cuda_device)
    cols = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    cnt = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        cbs.gibbs_apply_sparse(x, y, z_n, z_m, V, 0.1, cols.cpu(), cnt, 2, "gibbs", 256, 128)
    with pytest.raises(ValueError):
        cbs.gibbs_apply_sparse(x, y, z_n, z_m, V, 0.1, cols, cnt, 2, "gibbs", 300, 128)
    # D = 9, above the compiled widths, runs the wide instantiation.
    x9, y9, _ = tensors(*problem(512, 256, D=9, seed=2), device=cuda_device)
    args = (x9, y9, z_n, z_m, V, 0.1, cols, cnt, 2, "gibbs", 256, 128)
    got = _counted("gibbs_apply_sparse", lambda: cbs.gibbs_apply_sparse(*args), cbs.launch_counts)
    tol = apply_tolerance(*(t.cpu().numpy() for t in (x9, y9, z_n, z_m, V)), 0.1, 2, "gibbs")
    assert_apply_close(got, cbs.gibbs_apply_sparse_blocked(*args).cpu(), **tol)


def _sum_problem(D, p, block, seed, n_tiles=3, m_tiles=5, cap=4, eps=None):
    """Kernel 12's inputs: absorbed biases, a ragged table with a row whose
    count lies above the table's width (clamped to it) and one keeping a
    single tile."""
    N, M = n_tiles * block, m_tiles * block
    x, y, _ = problem(N, M, D=D, seed=seed)
    f, g, la, lb = potentials(N, M, seed=seed + 1)
    if eps is None:
        eps = 0.05 if p == 2 else 0.2
    cols, counts = kept_table(n_tiles, m_tiles, cap, seed=seed + 2)
    counts[0], counts[1] = cap + 3, 1
    return x, y, la + f / eps, lb + g / eps, eps, cols, counts


def _check_sums(got, ref, eps):
    """Raw absorbed sums compared as the Sinkhorn step reads them
    (``f + eps (loga - log r)``)."""
    zero = torch.zeros_like(got)
    torch.testing.assert_close(ck._absorbed_update(zero, zero, eps, got), ck._absorbed_update(zero, zero, eps, ref),
                               **VAL_TOL)


def _device_kernels(fn):
    """``{kernel name: launches}`` of the device kernels one call of ``fn``
    runs (torch.profiler), and its result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}, out


def _launches_of(kernels, name):
    return sum(n for key, n in kernels.items() if name in key)


@pytest.mark.parametrize("block", [96, 128, 256, 512, 1024])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("D", [1, 2, 3, 5, 8, 9, 12, 13, 17, 64])
def test_absorbed_sum_sparse_kernel_matches_twin(cuda_device, D, p, block):
    """Kernel 12 (``_absorbed_sum``): raw absorbed row sums, compared as the
    Sinkhorn step reads them (``f + eps (loga - log r)``), at every staged
    width (one to three float4s: D <= 11 at p = 2, D <= 12 at p = 1) and
    the wide form, any block (96: a ragged pass; 1024: four stages a
    tile), over a table with a count above its width (clamped), a row of
    one tile and a row of none, whose first kept tile opens with columns
    of bias -1e5 and -inf; two calls bitwise equal."""
    eps = (0.05 if p == 2 else 0.2) * max(1.0, D / 3)
    x, y, phi, psi, eps, cols, counts = _sum_problem(D, p, block, seed=D + 10 * p + block, eps=eps)
    counts[2] = 0
    first = cols[:, 0].astype(np.int64) * block
    psi = psi.copy()
    for j in first:
        psi[j : j + 8] = -1e5
        psi[j + 8 : j + 16] = -np.inf
    args = (*tensors(x, y, phi, psi, device=cuda_device), eps, *tensors(cols, counts, device=cuda_device), p, block)
    got = _counted("absorbed_sum_sparse", lambda: cbs.absorbed_sum_sparse(*args), cbs.launch_counts)
    _check_sums(got, cbs.absorbed_sum_sparse_blocked(*args), eps)
    assert torch.equal(got[2 * block : 3 * block], torch.zeros(block, device=cuda_device))
    assert torch.equal(got, cbs.absorbed_sum_sparse(*args))


#: A weight below 2^-126 flushes to zero on the card (ex2.approx.ftz).
FLUSH_WEIGHT = 2.0**-126


@pytest.mark.parametrize("block", [128, 512])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("D", [5, 8, 13])
def test_absorbed_sum_sparse_kernel_at_unscaled_eps(cuda_device, D, p, block):
    """Kernel 12 at the eps a D > 3 solve reaches (0.05 at p = 2, 0.2 at
    p = 1, not scaled by D/3), where weights below 2^-126 flush on the
    card and not in the twin: no row whose twin sum is positive comes out
    zero (its log would be -inf); a sum that flushed weights could move by
    more than 1e-6 of itself is compared raw, within its kept pairs x
    2^-126 plus what the potentials' tolerance allows, every other one as
    the Sinkhorn step reads it (``chip_smoke.py::check_sums``). Prints the
    smallest twin sum over its kept pairs x 2^-126 (with ``-s``)."""
    eps = 0.05 if p == 2 else 0.2
    x, y, phi, psi, eps, cols, counts = _sum_problem(D, p, block, seed=D + 10 * p + block, eps=eps)
    args = (*tensors(x, y, phi, psi, device=cuda_device), eps, *tensors(cols, counts, device=cuda_device), p, block)
    got = _counted("absorbed_sum_sparse", lambda: cbs.absorbed_sum_sparse(*args), cbs.launch_counts)
    ref = cbs.absorbed_sum_sparse_blocked(*args)
    assert not ((got == 0) & (ref > 0)).any()
    kept = torch.tensor(np.minimum(counts, cols.shape[1]) * block, device=cuda_device).repeat_interleave(block)
    flush = kept.to(ref) * FLUSH_WEIGHT
    near = (ref > 0) & (flush > 1e-6 * ref)
    zero = torch.zeros_like(ref)
    s_got, s_ref = (ck._absorbed_update(zero, zero, eps, v) for v in (got, ref))
    torch.testing.assert_close(s_got[~near], s_ref[~near], **VAL_TOL)
    tol = VAL_TOL["atol"] + VAL_TOL["rtol"] * s_ref[near].abs()
    assert ((got[near] - ref[near]).abs() <= flush[near] + ref[near] * torch.expm1(tol / eps)).all()
    live = ref > 0
    margin = (ref[live] / flush[live]).min().item()
    print(f"D={D} p={p} block={block} eps={eps}: {int(near.sum())} of {int(live.sum())} sums compared raw; "
          f"smallest twin sum / (kept pairs x 2^-126) {margin:.3e}")


@pytest.mark.parametrize("D", [3, 13])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("block", [128, 512])
def test_absorbed_sum_sparse_splits_long_rows(cuda_device, block, p, D, monkeypatch):
    """Kernel 12 over a table with one long row among short ones: cut into
    ranges (sum_rows_plan) and merged by a second kernel, and in one range
    with no merge (one device launch of the library), each within the
    twin's tolerance, bitwise repeatable and bitwise equal to kernel 10 on
    the unclipped walk of the same table."""
    n_tiles, m_tiles = 4, 9
    eps = (0.05 if p == 2 else 0.2) * max(1.0, D / 3)
    x, y, _ = problem(n_tiles * block, m_tiles * block, D=D, seed=block + p + D)
    f, g, la, lb = potentials(x.shape[0], y.shape[0], seed=block + D)
    cols, counts = _long_row_table(n_tiles, m_tiles, seed=block + D)
    table = tensors(cols, counts, device=cuda_device)
    args = (*tensors(x, y, la + f / eps, lb + g / eps, device=cuda_device), eps, *table, p, block)
    tbl = cbs.walk_plan(*table, m_tiles)
    wargs = (*args[:5], tbl, p, block)
    ref = cbs.absorbed_sum_sparse_blocked(*args)
    for target, split in ((cbs._SUM_BLOCKS, True), (1, False)):
        monkeypatch.setattr(cbs, "_SUM_BLOCKS", target)
        assert (cbs.sum_rows_plan(n_tiles, block, x.shape[0]) > 1) == split
        kernels, got = _device_kernels(lambda: cbs.absorbed_sum_sparse(*args))
        assert _launches_of(kernels, "sparse_sum_kernel") == 1
        assert _launches_of(kernels, "sum_merge_kernel") == (1 if split else 0)
        _check_sums(got, ref, eps)
        assert torch.equal(got, cbs.absorbed_sum_sparse(*args))
        assert torch.equal(got, cbs.absorbed_sum_walk(*wargs))


@pytest.mark.parametrize("t_mean", [4, 2, 1])
@pytest.mark.parametrize("rows_per_chunk", [2, 3, 1024])
def test_walk_decode_is_one_launch_equal_to_plain(cuda_device, rows_per_chunk, t_mean, monkeypatch):
    """The CUDA decode of a walk table (one or several chunks, the last
    padded; rows of no kept tile; clipped or not) is one device launch and
    equals the PyTorch form on the CPU bit for bit."""
    monkeypatch.setattr(cbs, "MAX_WALK_ROWS", rows_per_chunk)
    cols, counts = kept_table(7, 6, 4, seed=rows_per_chunk + t_mean)
    counts[3], counts[6] = 0, 0
    tbl = cbs.walk_plan(*tensors(cols, counts, device=cuda_device), t_mean)
    before = cbs.launch_counts["walk_rows"]
    kernels, got = _device_kernels(lambda: cbs._walk_rows(tbl, 7))
    assert cbs.launch_counts["walk_rows"] == before + 1
    assert _launches_of(kernels, "walk_rows_kernel") == 1 and sum(kernels.values()) == 1
    for a, b in zip(got, cbs._walk_rows_plain(tbl.cpu(), 7)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("p,kind", APPLY_KINDS)
def test_gibbs_apply_sparse_row_start_form(cuda_device, p, kind):
    """Kernel 8 reads its table through row starts: counts above the width
    are clamped to it, and the result equals the twin's."""
    x, y, phi, psi, eps, cols, counts = _sum_problem(3, p, 256, seed=3 + p)
    V = np.concatenate([np.ones((y.shape[0], 1), np.float32), y], 1)
    args = (*tensors(x, y, phi - phi.max(), psi, V, device=cuda_device), eps,
            *tensors(cols, counts, device=cuda_device), p, kind, 256, 256)
    got = _counted("gibbs_apply_sparse", lambda: cbs.gibbs_apply_sparse(*args), cbs.launch_counts)
    tol = apply_tolerance(x, y, phi - phi.max(), psi, V, eps, p, kind)
    assert_apply_close(got, cbs.gibbs_apply_sparse_blocked(*args).cpu(), **tol)
    clamped = (*args[:7], torch.clamp(args[7], max=cols.shape[1]), *args[8:])
    assert torch.equal(got, cbs.gibbs_apply_sparse(*clamped))


@pytest.mark.parametrize("D", [3, 13])
@pytest.mark.parametrize("t_mean", [4, 2])
@pytest.mark.parametrize("p", [1, 2])
def test_walk_kernels_match_twins_on_a_multi_chunk_table(cuda_device, p, t_mean, D, monkeypatch):
    """Kernels 10 and 11 over a walk table of three chunks of two rows (the
    last padded), unclipped (t_mean = 4) and clipped (t_mean = 2), staged
    and wide points (D = 13 at p = 2): the CUDA decode equals the CPU one,
    each kernel its twin, two calls bitwise equal, and kernel 10 on the
    unclipped walk kernel 12 on its table, bit for bit."""
    monkeypatch.setattr(cbs, "MAX_WALK_ROWS", 2)
    block = 256
    eps = (0.05 if p == 2 else 0.2) * max(1.0, D / 3)
    x, y, phi, psi, eps, cols, counts = _sum_problem(D, p, block, seed=7 * p + t_mean, n_tiles=5, m_tiles=6, eps=eps)
    counts[0] = 4
    table = tensors(cols, counts, device=cuda_device)
    tbl = cbs.walk_plan(*table, t_mean)
    assert tbl.shape[0] == 3
    for a, b in zip(cbs._walk_rows(tbl, 5), cbs._walk_rows(tbl.cpu(), 5)):
        assert torch.equal(a.cpu(), b)
    t = tensors(x, y, phi, psi, device=cuda_device)
    args = (*t, eps, tbl, p, block)
    got = _counted("absorbed_sum_walk", lambda: cbs.absorbed_sum_walk(*args), cbs.launch_counts)
    _check_sums(got, cbs.absorbed_sum_walk_blocked(*args), eps)
    assert torch.equal(got, cbs.absorbed_sum_walk(*args))
    if t_mean == 4:
        assert torch.equal(got, cbs.absorbed_sum_sparse(*t, eps, *table, p, block))
    V = np.concatenate([np.ones((y.shape[0], 1), np.float32), y], 1)
    kind = "gibbs" if p == 2 else "gibbs_grad"
    phi0 = phi - phi.max()
    a_args = (*tensors(x, y, phi0, psi, V, device=cuda_device), eps, tbl, p, kind, block, block)
    got = _counted("gibbs_apply_walk", lambda: cbs.gibbs_apply_walk(*a_args), cbs.launch_counts)
    assert_apply_close(got, cbs.gibbs_apply_walk_blocked(*a_args).cpu(),
                       **apply_tolerance(x, y, phi0, psi, V, eps, p, kind))
    assert torch.equal(got, cbs.gibbs_apply_walk(*a_args))


# ------------------------------------------------------------------------------
#  Point dimensions above the compiled widths (the wide instantiations), and
#  kernels 5 and 6 at D other than 3 (packed in chunks of four floats)
# ------------------------------------------------------------------------------


@pytest.mark.parametrize("tri", [False, True])
@pytest.mark.parametrize("p,kind", [(2, "gibbs"), (1, "gibbs"), (1, "gibbs_grad")])
@pytest.mark.parametrize("D", [5, 8, 9, 12, 17])
def test_tile_kernels_other_dims_match_twins(cuda_device, D, p, kind, tri):
    """Kernels 5 (p of the case) and 6 (apply modes 0-2) at D = 5 to 17:
    scores built up over several packed chunks (kernel 5: staged up to
    three float4s, D = 8 at p = 2 and D = 12 at p = 1; wide beyond)."""
    tile, n_tiles, m_tiles, cap = 256, 3, 4, 3
    x, y, f, g, la, lb = _tile_problem(tile, n_tiles, m_tiles, seed=D + p, tri=tri, D=D)
    cols, counts = kept_table(n_tiles, n_tiles if tri else m_tiles, cap, seed=D, sym=tri)
    eps = 0.05 * D
    phi, psi = la + f / eps, lb + g / eps
    t = tensors(x, y, phi, psi, device=cuda_device)
    table = tensors(cols, counts, device=cuda_device)
    args = (*t, eps, *table, p, tile, tri)
    got = _counted("absorbed_sum_tiles", lambda: cbs.absorbed_sum_tiles(*args), cbs.launch_counts)
    for a, b in zip(got, cbs.absorbed_sum_tiles_blocked(*args)):
        torch.testing.assert_close(a, b, **VAL_TOL)
    Vy = np.concatenate([np.ones((y.shape[0], 1), np.float32), y[:, :3]], 1)
    Vx = np.concatenate([np.ones((x.shape[0], 1), np.float32), x[:, :3]], 1)
    tv = tensors(x, y, phi, psi, Vy, Vx, device=cuda_device)
    a_args = (*tv, eps, *table, p, kind, tile, tri)
    got = _counted("gibbs_apply_tiles", lambda: cbs.gibbs_apply_tiles(*a_args), cbs.launch_counts)
    ref = cbs.gibbs_apply_tiles_blocked(*a_args)
    assert_apply_close(got[0], ref[0].cpu(), **apply_tolerance(x, y, phi, psi, Vy, eps, p, kind))
    assert_apply_close(got[1], ref[1].cpu(), **apply_tolerance(y, x, psi, phi, Vx, eps, p, kind))
    for a, b in zip(got, cbs.gibbs_apply_tiles(*a_args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("D", [17, 64])
def test_online_kernels_wide_dims_match_twins(cuda_device, D, p):
    """Kernels 1-3 at D = 17 and 64 (padded to 32 and 64: the wide
    instantiation, in chunks of 16 coordinates)."""
    N, M = 700, 513
    x, y, h = problem(N, M, D=D, seed=D + p)
    eps = 0.1 * D
    xt, yt, ht = tensors(x, y, h, device=cuda_device)
    got = _counted("lse", lambda: ck.lse(xt, yt, ht, eps, p))
    torch.testing.assert_close(got, ck.lse_blocked(xt, yt, ht, eps, p), **VAL_TOL)
    t = tensors(x, y, *potentials(N, M, seed=D), device=cuda_device)
    got = _counted("sinkhorn_step", lambda: ck.sinkhorn_step(*t, eps, p))
    for a, b in zip(got, ck.sinkhorn_step_blocked(*t, eps, p)):
        torch.testing.assert_close(a, b, **VAL_TOL)
    xs, fs, las = t[0], t[2], t[4]
    got = _counted("sinkhorn_step_sym", lambda: ck.sinkhorn_step_sym(xs, fs, las, eps, p))
    torch.testing.assert_close(got, ck.sinkhorn_step_sym_blocked(xs, fs, las, eps, p), **VAL_TOL)


@pytest.mark.parametrize("p,kind", APPLY_KINDS)
@pytest.mark.parametrize("D", [17, 64])
def test_gibbs_apply_wide_dims_matches_twin(cuda_device, D, p, kind):
    """Kernel 4, every weight kind, at D = 17 and 64."""
    N, M = 600, 517
    x, y, psi = problem(N, M, D=D, seed=D)
    rng = np.random.RandomState(D)
    phi = (-np.abs(rng.randn(N))).astype(np.float32)
    V = rng.randn(M, 5).astype(np.float32)
    eps = 0.1 * D
    tol = apply_tolerance(x, y, phi, psi, V, eps, p, kind)
    t = tensors(x, y, phi, psi, V, device=cuda_device)
    got = _counted("gibbs_apply", lambda: ck.gibbs_apply(*t, eps, p, kind))
    assert_apply_close(got, ck.gibbs_apply_blocked(*t, eps, p, kind).cpu(), **tol)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("D", [9, 17])
def test_block_sparse_kernels_wide_dims_match_twins(cuda_device, D, p):
    """Kernels 7, 8 (every weight kind of this p) and 12 at D = 9 and 17:
    three staged float4s (D = 9) and the wide form (D = 17)."""
    block_n, block_m = 256, 128
    x, y, h = problem(3 * block_n, 7 * block_m, D=D, seed=D + p)
    cols, counts = kept_table(3, 7, 5, seed=D + p)
    xt, yt, ht, ct, nt = tensors(x, y, h, cols, counts, device=cuda_device)
    eps = 0.05 * D
    args = (xt, yt, ht, eps, ct, nt, block_n, block_m, p)
    got = _counted("lse_tiles", lambda: cbs.lse_tiles(*args), cbs.launch_counts)
    torch.testing.assert_close(got, cbs.lse_tiles_blocked(*args), **VAL_TOL)
    rng = np.random.RandomState(D)
    phi = (-np.abs(rng.randn(x.shape[0]))).astype(np.float32)
    V = rng.randn(y.shape[0], 4).astype(np.float32)
    for pp, kind in APPLY_KINDS:
        if pp != p:
            continue
        tol = apply_tolerance(x, y, phi, h, V, eps, p, kind)
        a_args = (xt, yt, *tensors(phi, device=cuda_device), ht, *tensors(V, device=cuda_device), eps, ct, nt, p,
                  kind, block_n, block_m)
        got = _counted("gibbs_apply_sparse", lambda: cbs.gibbs_apply_sparse(*a_args), cbs.launch_counts)
        assert_apply_close(got, cbs.gibbs_apply_sparse_blocked(*a_args).cpu(), **tol)
    xs, ys, phi_s, psi_s, eps_s, cols_s, counts_s = _sum_problem(D, p, 256, seed=D + 10 * p)
    s_args = (*tensors(xs, ys, phi_s, psi_s, device=cuda_device), eps_s, *tensors(cols_s, counts_s, device=cuda_device),
              p, 256)
    got = _counted("absorbed_sum_sparse", lambda: cbs.absorbed_sum_sparse(*s_args), cbs.launch_counts)
    zero = torch.zeros_like(got)
    torch.testing.assert_close(ck._absorbed_update(zero, zero, eps_s, got),
                               ck._absorbed_update(zero, zero, eps_s, cbs.absorbed_sum_sparse_blocked(*s_args)),
                               **VAL_TOL)


# ------------------------------------------------------------------------------
#  Kernels 8 and 2 as register-tiled pair blocks: one channel unpadded,
#  ragged passes, empty rows, every staged width and the wide form
# ------------------------------------------------------------------------------


def _sparse_apply_problem(p, kind, C, D=3, block_n=256, block_m=256, seed=0, n_tiles=3, m_tiles=4):
    x, y, psi = problem(n_tiles * block_n, m_tiles * block_m, D=D, seed=seed)
    rng = np.random.RandomState(seed + 1)
    phi = (-np.abs(rng.randn(x.shape[0]))).astype(np.float32)
    V = rng.randn(y.shape[0], C).astype(np.float32)
    cols, counts = kept_table(n_tiles, m_tiles, 3, seed=seed + 2)
    eps = 0.5 * max(1, D // 3)
    return (x, y, phi, psi, V, eps), (cols, counts)


def _check_sparse_apply(pts, table, p, kind, block_n, block_m, launches):
    x, y, phi, psi, V, eps = pts
    args = (*tensors(x, y, phi, psi, V, device="cuda"), eps, *tensors(*table, device="cuda"), p, kind, block_n,
            block_m)
    before = cbs.launch_counts["gibbs_apply_sparse"]
    got = _counted("gibbs_apply_sparse", lambda: cbs.gibbs_apply_sparse(*args), cbs.launch_counts)
    assert cbs.launch_counts["gibbs_apply_sparse"] - before == launches
    assert_apply_close(got, cbs.gibbs_apply_sparse_blocked(*args).cpu(),
                       **apply_tolerance(x, y, phi, psi, V, eps, p, kind))
    assert torch.equal(got, cbs.gibbs_apply_sparse(*args))
    return got


@pytest.mark.parametrize("C", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("p,kind", APPLY_KINDS)
def test_gibbs_apply_sparse_channel_groups(cuda_device, p, kind, C):
    """Kernel 8 at every mode: one channel in one unpadded launch, more in
    groups of four (C = 5 and 8: two launches); two calls bitwise equal."""
    pts, table = _sparse_apply_problem(p, kind, C, seed=C)
    _check_sparse_apply(pts, table, p, kind, 256, 256, cbs._cdiv(C, 4) if C > 1 else 1)


@pytest.mark.parametrize("block_n,block_m", [(100, 48), (300, 100), (256, 200)])
@pytest.mark.parametrize("p,kind", APPLY_KINDS)
def test_gibbs_apply_sparse_ragged_passes_and_empty_rows(cuda_device, p, kind, block_n, block_m):
    """Kernel 8 where block_m is no multiple of a pass (32 or 64 columns)
    and block_n no multiple of 256, with a row tile that keeps no tile: its
    rows are exactly 0."""
    for C in (1, 4):
        pts, (cols, counts) = _sparse_apply_problem(p, kind, C, block_n=block_n, block_m=block_m, seed=block_m + C)
        counts[1] = 0
        got = _check_sparse_apply(pts, (cols, counts), p, kind, block_n, block_m, 1)
        assert not got[block_n : 2 * block_n].any()


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("D", [1, 2, 3, 5, 8, 9, 17])
def test_gibbs_apply_sparse_point_dims(cuda_device, D, p):
    """Kernel 8's packed points at every staged width (one to three float4s)
    and the wide form (D = 17 at either p), C = 1 and 4, the gibbs kinds of
    this p."""
    for kind in ("gibbs", "gibbs_grad"):
        for C in (1, 4):
            pts, table = _sparse_apply_problem(p, kind, C, D=D, seed=D + C)
            _check_sparse_apply(pts, table, p, kind, 256, 256, 1)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("shape", [(1, 1), (1, 1000), (300, 65), (777, 513), (257, 4099)])
def test_sinkhorn_step_kernel_ragged_edges(cuda_device, p, shape):
    """Kernel 2 at N = 1 and at M no multiple of 64 or 256: padded columns
    weigh 0 and write no column sum; two calls bitwise equal."""
    N, M = shape
    x, y, _ = problem(N, M, seed=N + M + p)
    t = tensors(x, y, *potentials(N, M, seed=N), device=cuda_device)
    got = _counted("sinkhorn_step", lambda: ck.sinkhorn_step(*t, 0.21, p))
    for a, b in zip(got, ck.sinkhorn_step_blocked(*t, 0.21, p)):
        torch.testing.assert_close(a, b, **VAL_TOL)
    for a, b in zip(got, ck.sinkhorn_step(*t, 0.21, p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("D", [1, 2, 3, 5, 8, 17, 64])
def test_sinkhorn_step_kernel_point_dims(cuda_device, D, p):
    """Kernel 2's packed points: staged up to three float4s (D <= 11 at
    p = 2, D <= 12 at p = 1), wide above (D = 17, 64)."""
    N, M = 700, 517
    x, y, _ = problem(N, M, D=D, seed=D + p)
    t = tensors(x, y, *potentials(N, M, seed=D), device=cuda_device)
    eps = 0.1 * D
    got = _counted("sinkhorn_step", lambda: ck.sinkhorn_step(*t, eps, p))
    for a, b in zip(got, ck.sinkhorn_step_blocked(*t, eps, p)):
        torch.testing.assert_close(a, b, **VAL_TOL)
    for a, b in zip(got, ck.sinkhorn_step(*t, eps, p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [1, 3, 5, 11, 12, 32])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("N", [1, 255, 256, 257, 4099])
def test_sinkhorn_step_sym_kernel_packed_points(cuda_device, N, p, D, monkeypatch):
    """Kernel 3 on the shared absorbed-sum stage: ragged N (rows past N and
    padded columns weigh 0), staged points up to three float4s (D <= 11 at
    p = 2, D <= 12 at p = 1) and wide ones (D = 12 at p = 2, D = 32), two
    calls bitwise equal, and in chunks of two row tiles."""
    x, _, _ = problem(N, 1, D=D, seed=N + D + p)
    f, _, la, _ = potentials(N, 1, seed=N + 1)
    t = tensors(x, f, la, device=cuda_device)
    eps = 0.1 * D
    ref = ck.sinkhorn_step_sym_blocked(*t, eps, p)
    got = _counted("sinkhorn_step_sym", lambda: ck.sinkhorn_step_sym(*t, eps, p))
    torch.testing.assert_close(got, ref, **VAL_TOL)
    assert torch.equal(got, ck.sinkhorn_step_sym(*t, eps, p))
    nb = -(-N // 256)
    monkeypatch.setattr(ck, "STEP_SCRATCH_BYTES", 2 * 4 * 256 * nb)
    before = ck.launch_counts["sinkhorn_step_sym"]
    chunked = ck.sinkhorn_step_sym(*t, eps, p)
    torch.cuda.synchronize()
    assert ck.launch_counts["sinkhorn_step_sym"] - before == -(-nb // 2)
    torch.testing.assert_close(chunked, ref, **VAL_TOL)


@pytest.mark.parametrize("shape", [(1000, 1283), (257, 4099), (1, 300)])
@pytest.mark.parametrize("C", [1, 3, 4, 5, 33])
@pytest.mark.parametrize("p,kind", APPLY_KINDS + [(2, "energy"), (2, "inv_dist")])
def test_gibbs_apply_kernel_column_slices(cuda_device, p, kind, C, shape, monkeypatch):
    """Kernel 4 in every mode: one launch per call whatever C (its channel
    groups are the grid's third axis), several column slices against one,
    both within the twin's tolerance, two calls bitwise equal."""
    N, M = shape
    x, y, psi = problem(N, M, seed=N + C)
    rng = np.random.RandomState(C)
    phi = (-np.abs(rng.randn(N))).astype(np.float32)
    V = rng.randn(M, C).astype(np.float32)
    tol = apply_tolerance(x, y, phi, psi, V, 0.5, p, kind)
    t = tensors(x, y, phi, psi, V, device=cuda_device)
    ref = ck.gibbs_apply_blocked(*t, 0.5, p, kind).cpu()
    assert ck.apply_plan(N, M, C)[1] > 1
    before = ck.launch_counts["gibbs_apply"]
    got = ck.gibbs_apply(*t, 0.5, p, kind)
    torch.cuda.synchronize()
    assert ck.launch_counts["gibbs_apply"] - before == 1
    assert got.shape == (N, C)
    assert_apply_close(got, ref, **tol)
    assert torch.equal(got, ck.gibbs_apply(*t, 0.5, p, kind))
    monkeypatch.setattr(ck, "_STEP_BLOCKS", 1)
    assert ck.apply_plan(N, M, C)[1] == 1
    assert_apply_close(ck.gibbs_apply(*t, 0.5, p, kind), ref, **tol)


def test_gibbs_apply_kernel_in_chunks(cuda_device, monkeypatch):
    """Column slices under a scratch budget of a few row blocks: several
    launches, the same result within the twin's tolerance."""
    N, M, C = 4099, 2053, 5
    x, y, psi = problem(N, M, seed=3)
    phi = np.zeros(N, np.float32)
    V = np.random.RandomState(3).randn(M, C).astype(np.float32)
    t = tensors(x, y, phi, psi, V, device=cuda_device)
    monkeypatch.setattr(ck, "STEP_SCRATCH_BYTES", 3 * 4 * 8 * 256 * 8)
    R, S, _ = ck.apply_plan(N, M, C)
    assert S > 1 and R < -(-N // 256)
    before = ck.launch_counts["gibbs_apply"]
    got = ck.gibbs_apply(*t, 0.5, 2, "gibbs")
    torch.cuda.synchronize()
    assert ck.launch_counts["gibbs_apply"] - before == -(-(-(-N // 256)) // R)
    assert_apply_close(got, ck.gibbs_apply_blocked(*t, 0.5, 2, "gibbs").cpu(),
                       **apply_tolerance(x, y, phi, psi, V, 0.5, 2, "gibbs"))


def test_energy_mmd_holds_its_tolerance(cuda_device):
    """The energy MMD through kernel 4 (modes 3 and 4: one rsqrt.approx a
    pair) against float64: the loss within 1e-5 of its three terms summed,
    the gradient within 1e-3 of the larger of its two parts' norms."""
    from geomloss_tpu_torch.models import kernel_samples as ks

    n = 5000
    rng = np.random.RandomState(0)
    x, y = (v / np.linalg.norm(v, axis=1, keepdims=True) for v in (rng.randn(n, 3), rng.randn(n, 3)))
    w = np.full(n, 1.0 / n)

    def value_and_grad(dt, impl):
        xt = torch.tensor(x, dtype=dt, device=cuda_device, requires_grad=True)
        yt, wt = torch.tensor(y, dtype=dt, device=cuda_device), torch.tensor(w, dtype=dt, device=cuda_device)
        v = ks.kernel_online(wt[None], xt[None], wt[None], yt[None], name="energy", blur=0.1, impl=impl)[0]
        return v.detach(), torch.autograd.grad(v, xt)[0]

    before = ck.launch_counts["gibbs_apply"]
    v, g = value_and_grad(torch.float32, "auto")
    torch.cuda.synchronize()
    assert ck.launch_counts["gibbs_apply"] > before
    v64, g64 = value_and_grad(torch.float64, "blocked")
    # The three terms and the gradient's two parts, in float64.
    x64 = torch.tensor(x, device=cuda_device, requires_grad=True)
    y64, a = torch.tensor(y, device=cuda_device), torch.tensor(w, device=cuda_device)[:, None]
    z = torch.zeros(n, dtype=torch.float64, device=cuda_device)
    t_xx = 0.5 * (a * ck.gibbs_apply_blocked(x64, x64.detach(), z, z, a, 1.0, 1, "energy")).sum()
    t_yy = 0.5 * (a * ck.gibbs_apply_blocked(y64, y64, z, z, a, 1.0, 1, "energy")).sum()
    t_xy = (a * ck.gibbs_apply_blocked(x64, y64, z, z, a, 1.0, 1, "energy")).sum()
    g_self = 2 * torch.autograd.grad(t_xx, x64)[0]
    g_cross = torch.autograd.grad(t_xy, x64)[0]
    torch.testing.assert_close(v64, t_xx + t_yy - t_xy, rtol=1e-9, atol=1e-12)
    assert abs(v.double() - v64).item() <= 1e-5 * (abs(t_xx) + abs(t_yy) + abs(t_xy)).item()
    assert (g.double() - g64).norm().item() <= 1e-3 * max(g_self.norm().item(), g_cross.norm().item())


@pytest.mark.parametrize("slices", [False, True])
@pytest.mark.parametrize("D", [2, 3, 4, 8, 11, 17])
@pytest.mark.parametrize("shape", [(1000, 1283), (257, 4099)])
def test_energy_grad_apply_matches_twin(cuda_device, shape, D, slices, monkeypatch):
    """Kernel 4's fused energy form (D = 2 and 3: one staged float4, the
    three-coordinate instantiation; 4, 8 and 11: the staged forms with a
    group past the point's last float4 or not; 17: the wide form), N != M
    with ragged tails, one column slice or several:
    one launch; the value within the twin's tolerance of the energy kind,
    R within it of the inv_dist kind of v [1, y], and R equal to the bit to
    kernel 4's own inv_dist apply of that V, the value to its energy apply
    within 1e-6 of the largest entry."""
    N, M = shape
    x, y, psi = problem(N, M, D=D, seed=N + D)
    rng = np.random.RandomState(D)
    v = np.abs(rng.randn(M)).astype(np.float32)
    V = v[:, None] * np.concatenate([np.ones((M, 1), np.float32), y], 1)
    z_x, z_y = np.zeros(N, np.float32), np.zeros(M, np.float32)
    t = tensors(x, y, z_x, z_y, v, V, device=cuda_device)
    if not slices:
        monkeypatch.setattr(ck, "_STEP_BLOCKS", 1)
    assert (ck.apply_plan(N, M, D + 2)[1] > 1) == slices
    before = ck.launch_counts["gibbs_apply"]
    val, R = ck.gibbs_apply(*t[:5], 1.0, 1, "energy_grad")
    torch.cuda.synchronize()
    assert ck.launch_counts["gibbs_apply"] - before == 1
    assert val.shape == (N,) and R.shape == (N, D + 1)
    ref_v, ref_R = ck.gibbs_apply_blocked(*(a.cpu() for a in t[:5]), 1.0, 1, "energy_grad")
    assert_apply_close(val[:, None], ref_v[:, None], **apply_tolerance(x, y, z_x, z_y, v[:, None], 1.0, 1, "energy"))
    assert_apply_close(R, ref_R, **apply_tolerance(x, y, z_x, z_y, V, 1.0, 1, "inv_dist"))
    assert torch.equal(R, ck.gibbs_apply(*t[:4], t[5], 1.0, 1, "inv_dist"))
    energy = ck.gibbs_apply(*t[:4], t[4][:, None], 1.0, 1, "energy")[:, 0]
    assert (val - energy).abs().max().item() <= 1e-6 * energy.abs().max().item()
    again = ck.gibbs_apply(*t[:5], 1.0, 1, "energy_grad")
    assert torch.equal(val, again[0]) and torch.equal(R, again[1])


def test_energy_mmd_folds_dx_into_the_forward(cuda_device, monkeypatch):
    """The energy loss at 2e4 points on the card: its two matvecs whose x
    requires grad (K_xx a and K_xy b) take kernel 4's fused energy form in
    their forward. Against the same loss with the matvec unfolded (mode 3
    forward, mode 4 backward): the gradient in x equal to the bit, the loss
    within 1e-6 relative; three kernel 4 launches a call against five."""
    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.models import kernel_samples as ks
    from geomloss_tpu_torch.ops import softmin as tsm
    from geomloss_tpu_torch.utils import profiling

    n = 20_000
    rng = np.random.RandomState(1)
    x, y = (torch.tensor(v / (2 * np.linalg.norm(v, axis=1, keepdims=True)), dtype=torch.float32,
                         device=cuda_device) for v in (rng.randn(n, 3), rng.randn(n, 3) + 0.3))
    a, b = (torch.tensor(w / w.sum(), dtype=torch.float32, device=cuda_device)
            for w in (np.abs(rng.randn(n)), np.abs(rng.randn(n))))
    loss = SamplesLoss("energy")

    def run():
        xt = x.clone().requires_grad_(True)
        before = (ck.launch_counts["gibbs_apply"], profiling.totals.get("matvec.grad_in_forward", 0))
        value = loss(a, xt, b, y)
        grad = torch.autograd.grad(value, xt)[0]
        torch.cuda.synchronize()
        after = (ck.launch_counts["gibbs_apply"], profiling.totals.get("matvec.grad_in_forward", 0))
        return value.detach(), grad, np.subtract(after, before).tolist()

    v1, g1, n1 = run()
    monkeypatch.setattr(ks, "gibbs_matvec", lambda *args: tsm._GibbsMatvec.apply(*args, False))
    v0, g0, n0 = run()
    assert (n1, n0) == ([3, 2], [5, 0])
    assert abs(v1 - v0).item() <= 1e-6 * abs(v0).item()
    assert torch.equal(g1, g0)


# ------------------------------------------------------------------------------
#  Kernels 1 and 7 (and 9, on 7) on the register-tiled LSE stage: column
#  slices and kept-tile ranges merged by a second kernel, ragged shapes,
#  every staged width and the wide form, columns of bias -inf
# ------------------------------------------------------------------------------


@pytest.mark.parametrize("D", [1, 2, 3, 5, 11, 12, 32])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("M", [1, 63, 65, 4096, 4099])
@pytest.mark.parametrize("N", [1, 255, 256, 257, 4096, 4099])
def test_lse_kernel_slices_and_point_dims(cuda_device, N, M, p, D):
    """Kernel 1 at ragged N and M (one column slice or many: lse_plan),
    staged points up to three float4s (D <= 12) and wide ones (D = 32):
    one launch per call, within the twin's tolerance, two calls bitwise
    equal."""
    x, y, h = tensors(*problem(N, M, D=D, seed=N + M + D + p), device=cuda_device)
    eps = 0.1 * D
    before = ck.launch_counts["lse"]
    got = ck.lse(x, y, h, eps, p)
    torch.cuda.synchronize()
    assert ck.launch_counts["lse"] - before == 1
    torch.testing.assert_close(got, ck.lse_blocked(x, y, h, eps, p), **VAL_TOL)
    assert torch.equal(got, ck.lse(x, y, h, eps, p))


@pytest.mark.parametrize("p", [1, 2])
def test_lse_kernel_column_slice_of_neg_inf_biases(cuda_device, p):
    """Zero-weight columns (bias -inf) filling whole column slices of
    kernel 1 and part of another: their partials are (-inf, 0) and the
    merge gives the LSE of the other columns; rows against nothing but
    such columns give -inf."""
    N, M = 300, 4096
    S, width = ck.lse_plan(N, M)
    assert S > 3
    x, y, h = problem(N, M, seed=p)
    h[: 2 * width] = -np.inf
    h[3 * width + 5 : 3 * width + 40] = -np.inf
    x, y, h = tensors(x, y, h, device=cuda_device)
    got = _counted("lse", lambda: ck.lse(x, y, h, 0.2, p))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ck.lse_blocked(x, y, h, 0.2, p), **VAL_TOL)
    assert torch.isneginf(ck.lse(x, y, torch.full_like(h, -np.inf), 0.2, p)).all()


@pytest.mark.parametrize("p", [1, 2])
def test_lse_kernel_one_slice_against_many(cuda_device, p, monkeypatch):
    """Kernel 1 with its slices merged (the plan at 4,096 points) and in
    one slice (``_LSE_BLOCKS = 1``: the block writes the LSE itself)."""
    N = M = 4096
    x, y, h = tensors(*problem(N, M, seed=7 + p), device=cuda_device)
    assert ck.lse_plan(N, M)[0] * -(-N // 256) >= 264
    many = ck.lse(x, y, h, 0.05, p)
    monkeypatch.setattr(ck, "_LSE_BLOCKS", 1)
    assert ck.lse_plan(N, M)[0] == 1
    torch.testing.assert_close(ck.lse(x, y, h, 0.05, p), many, **VAL_TOL)


def _long_row_table(n_tiles, m_tiles, seed):
    """A kept-tile table whose row 0 keeps every source tile while the
    others keep one to three: the split path's case."""
    cols, counts = kept_table(n_tiles, m_tiles, m_tiles, seed=seed)
    rng = np.random.RandomState(seed)
    cols[0] = rng.permutation(m_tiles)
    counts[0] = m_tiles
    counts[1:] = np.minimum(counts[1:], rng.randint(1, 4, n_tiles - 1))
    return cols, counts


@pytest.mark.parametrize("C", [1, 4, 5])
@pytest.mark.parametrize("block_n", [384, 1024])
@pytest.mark.parametrize("p,kind", [(2, "gibbs"), (1, "gibbs_grad"), (1, "energy")])
def test_gibbs_apply_sparse_splits_long_rows(cuda_device, p, kind, block_n, C, monkeypatch):
    """Kernel 8 over a table with one long row among short ones: cut into
    kernel 12's ranges (sum_rows_plan) and merged by a second kernel, and
    in one range with no merge (the row tiles longest first), each within
    the twin's tolerance, bitwise repeatable, bitwise equal to kernel 11 on
    the unclipped walk of the same table, and, row tiles relabelled in
    reverse, bitwise the same rows (block_n = 384: a slice of 128 rows)."""
    n_tiles, m_tiles, block_m = 5, 9, 256
    N, M = n_tiles * block_n, m_tiles * block_m
    x, y, psi = problem(N, M, seed=block_n + C + p)
    rng = np.random.RandomState(C)
    phi = (-np.abs(rng.randn(N))).astype(np.float32)
    V = rng.randn(M, C).astype(np.float32)
    cols, counts = _long_row_table(n_tiles, m_tiles, seed=block_n + C)
    eps = 0.5
    tol = apply_tolerance(x, y, phi, psi, V, eps, p, kind)
    pts = tensors(x, y, phi, psi, V, device=cuda_device)
    table = tensors(cols, counts, device=cuda_device)
    args = (*pts, eps, *table, p, kind, block_n, block_m)
    wargs = (*pts, eps, cbs.walk_plan(*table, m_tiles), p, kind, block_n, block_m)
    rev = np.arange(N).reshape(n_tiles, block_n)[::-1].reshape(-1)
    rargs = (*tensors(x[rev], y, phi[rev], psi, V, device=cuda_device), eps,
             *tensors(np.ascontiguousarray(cols[::-1]), np.ascontiguousarray(counts[::-1]), device=cuda_device),
             p, kind, block_n, block_m)
    back = torch.from_numpy(np.argsort(rev)).to(cuda_device)
    ref = cbs.gibbs_apply_sparse_blocked(*args).cpu()
    groups = -(-C // 4) if C > 1 else 1
    for target, split in ((cbs._SUM_BLOCKS, True), (1, False)):
        monkeypatch.setattr(cbs, "_SUM_BLOCKS", target)
        assert (cbs.sum_rows_plan(n_tiles, block_n, N, 4 if C > 1 else 1) > 1) == split
        # The profiler now and then misses a launch of the library's kernels
        # (an empty capture, or one without them): take it again.
        for _ in range(3):
            kernels, got = _device_kernels(lambda: cbs.gibbs_apply_sparse(*args))
            if _launches_of(kernels, "sparse_apply_kernel"):
                break
        assert _launches_of(kernels, "sparse_apply_kernel") == groups
        assert _launches_of(kernels, "sum_merge_kernel") == (groups if split else 0)
        assert_apply_close(got, ref, **tol)
        assert torch.equal(got, cbs.gibbs_apply_sparse(*args))
        assert torch.equal(got, cbs.gibbs_apply_walk(*wargs))
        assert torch.equal(cbs.gibbs_apply_sparse(*rargs)[back], got)


@pytest.mark.parametrize("D", [3, 13])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("block_m", [128, 256, 512, 1024])
def test_lse_tiles_kernel_splits_long_rows(cuda_device, block_m, p, D, monkeypatch):
    """Kernel 7 at every block_m of its callers (128 on the mid path's
    extrapolations: two kept tiles a stage; 512 for lse_sparse; 1024), over
    a table with one long row among short ones: its kept tiles split into
    ranges (lse_tiles_plan) merged by a second kernel, the same within the
    twin's tolerance as one range per row, two calls bitwise equal."""
    n_tiles, m_tiles, block_n = 4, 9, 256
    x, y, h = problem(n_tiles * block_n, m_tiles * block_m, D=D, seed=block_m + p + D)
    cols, counts = _long_row_table(n_tiles, m_tiles, seed=block_m + D)
    args = (*tensors(x, y, h, device=cuda_device), 0.05 * D if p == 2 else 0.2,
            *tensors(cols, counts, device=cuda_device), block_n, block_m, p)
    assert cbs.lse_tiles_plan(n_tiles, block_n, m_tiles, x.shape[0])[0] > 1
    got = _counted("lse_tiles", lambda: cbs.lse_tiles(*args), cbs.launch_counts)
    ref = cbs.lse_tiles_blocked(*args)
    torch.testing.assert_close(got, ref, **VAL_TOL)
    assert torch.equal(got, cbs.lse_tiles(*args))
    monkeypatch.setattr(cbs, "_LSE_TILES_BLOCKS", 1)
    assert cbs.lse_tiles_plan(n_tiles, block_n, m_tiles, x.shape[0])[0] == 1
    torch.testing.assert_close(cbs.lse_tiles(*args), ref, **VAL_TOL)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("block_m", [128, 256, 512, 1024])
def test_lse_sparse_splits_long_rows(cuda_device, block_m, p):
    """Kernel 9 (lse_sparse, on kernel 7's CUDA kernel) over the long-row
    table at every block_m: within the twin's tolerance, bitwise repeats,
    counted under its own name."""
    n_tiles, m_tiles = 3, 7
    x, y, h = problem(n_tiles * 256, m_tiles * block_m, seed=block_m + 3 * p)
    cols, counts = _long_row_table(n_tiles, m_tiles, seed=block_m + p)
    x, y, h, cols, counts = tensors(x, y, h, cols, counts, device=cuda_device)
    call = lambda: cbs.lse_sparse(x, y, h, 0.1, cols, counts, p, 256, block_m)  # noqa: E731
    got = _counted("lse_sparse", call, cbs.launch_counts)
    torch.testing.assert_close(got, cbs.lse_tiles_blocked(x, y, h, 0.1, cols, counts, 256, block_m, p), **VAL_TOL)
    assert torch.equal(got, call())


def _sphere(n, seed):
    v = np.random.RandomState(seed).randn(n, 3)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("blocks", [1, None])
@pytest.mark.parametrize("p", [1, 2])
def test_lse_kernels_after_zero_weight_columns(cuda_device, p, blocks, monkeypatch):
    """Columns of log weight -1e5 (the multiscale path's zero-weight
    blocks) met first by a row, at the mid path's eps on unit spheres: the
    running max starts far below the true one, and the rebase must not
    lose the digits of the pass that raises it (kernel 1 in one slice and
    in the plan's slices; kernel 7 whose first kept tiles hold them)."""
    if blocks:
        monkeypatch.setattr(ck, "_LSE_BLOCKS", blocks)
        monkeypatch.setattr(cbs, "_LSE_TILES_BLOCKS", blocks)
    eps = 0.0039 if p == 2 else 0.05
    x, y = _sphere(512, p), _sphere(1024, p + 1)
    h = (0.1 * np.random.RandomState(p).randn(1024) - 7).astype(np.float32)
    h[:64] = -99996.9
    h[300:420] = -99996.9
    xt, yt, ht = tensors(x, y, h, device=cuda_device)
    got = _counted("lse", lambda: ck.lse(xt, yt, ht, eps, p))
    torch.testing.assert_close(got, ck.lse_blocked(xt, yt, ht, eps, p), **VAL_TOL)
    cols = np.tile(np.array([0, 2, 3, 5, 6, 7], np.int32), (2, 1))
    counts = np.array([6, 4], np.int32)
    args = (xt, yt, ht, eps, *tensors(cols, counts, device=cuda_device), 256, 128, p)
    got = _counted("lse_tiles", lambda: cbs.lse_tiles(*args), cbs.launch_counts)
    torch.testing.assert_close(got, cbs.lse_tiles_blocked(*args), **VAL_TOL)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("shape", [(8, 256, 256), (2, 64, 64, 64)])
def test_softmin_grid_float32_with_tf32_enabled_by_the_caller(cuda_device, shape, p):
    """The grid softmin in float32 on the card against its float64 form, at
    eps = 1 and at one pixel^p, with ``allow_tf32`` set by the caller: the
    same floats as without it, and the caller's setting kept."""
    from geomloss_tpu_torch.ops.grid import softmin_grid

    h = torch.tensor(np.random.RandomState(p).randn(*shape), dtype=torch.float32, device=cuda_device)
    saved = torch.backends.cuda.matmul.allow_tf32
    for eps in (1.0, shape[-1] ** -p):
        got = softmin_grid(eps, p, h)
        torch.testing.assert_close(got.double(), softmin_grid(eps, p, h.double()), **VAL_TOL)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            assert torch.equal(softmin_grid(eps, p, h), got)
            assert torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("kw", [dict(p=2), dict(p=1), dict(p=2, reach=0.1)])
def test_images_loss_on_the_card_matches_cpu_float64(cuda_device, kw):
    """``ImagesLoss`` at 64^2 (a batch of 2) in float32 on the card against
    the same call in float64 on the CPU: losses and the gradient within
    1e-3 relative."""
    from geomloss_tpu_torch import ImagesLoss

    rng = np.random.RandomState(0)
    grid = np.meshgrid(*[(np.arange(64) + 0.5) / 64] * 2, indexing="ij")
    dens = []
    for _ in range(4):
        c, s = 0.2 + 0.6 * rng.rand(3, 2), 0.04 + 0.08 * rng.rand(3)
        d = sum(np.exp(-((grid[0] - ci[0]) ** 2 + (grid[1] - ci[1]) ** 2) / (2 * si * si)) for ci, si in zip(c, s))
        dens.append(d / d.sum())
    a, b = np.stack(dens[:2]), np.stack(dens[2:])
    out = []
    for dev, dt in ((cuda_device, torch.float32), ("cpu", torch.float64)):
        at = torch.tensor(a, dtype=dt, device=dev, requires_grad=True)
        v = ImagesLoss(**kw)(at, torch.tensor(b, dtype=dt, device=dev))
        (g,) = torch.autograd.grad(v.sum(), at)
        out.append((v.detach().cpu().double(), g.cpu().double()))
    (v, g), (v_ref, g_ref) = out
    assert ((v - v_ref).abs() <= 1e-3 * v_ref.abs()).all()
    assert (g - g_ref).norm() <= 1e-3 * g_ref.norm()


def test_solve_sample_streaming_on_the_card_matches_cpu_float64(cuda_device):
    """``ot.solve_sample`` between two clouds of 20,000 points (4e8 cost
    entries: the streaming route, kernel 1 for every softmin) in float32 on
    the card against the same call in float64 on the CPU: the value within
    1e-3 relative, its gradient in ``X_a``, the potentials, ``a_to_b`` and
    ``marginal_a`` (kernel 4 on the card) within 1e-3 relative L2."""
    from geomloss_tpu_torch import ot

    rng = np.random.RandomState(0)
    pts = [rng.randn(20_000, 3) for _ in range(2)]
    pts = [p / np.linalg.norm(p, axis=1, keepdims=True) for p in pts]
    out = []
    for dev, dt in ((cuda_device, torch.float32), ("cpu", torch.float64)):
        xa = torch.tensor(pts[0], dtype=dt, device=dev, requires_grad=True)
        res = ot.solve_sample(xa, torch.tensor(pts[1], dtype=dt, device=dev), blur=0.05, max_iter=5, debias=True)
        before = dict(ck.launch_counts)
        (g,) = torch.autograd.grad(res.value, xa)
        extra = (res.potential_a, res.potential_b, res.a_to_b, res.marginal_a)
        if dev == cuda_device:
            assert ck.launch_counts["gibbs_apply"] > before["gibbs_apply"]
        out.append([t.detach().cpu().double() for t in (res.value, g, *extra)])
    (v, *rest), (v_ref, *rest_ref) = out
    assert abs(v - v_ref) <= 1e-3 * abs(v_ref)
    for got, ref in zip(rest, rest_ref):
        assert (got - ref).norm() <= 1e-3 * ref.norm()


def test_a_to_b_through_kernel_4_matches_twin(cuda_device, monkeypatch):
    """The barycentric map of a streaming result applies kernel 4 at
    C = 1 and C = 3: each apply within the apply tolerance of its twin, and
    the map within 1e-4 relative L2 of the one through the twins."""
    from geomloss_tpu_torch import ot

    rng = np.random.RandomState(1)
    x, y = (torch.tensor(rng.rand(n, 3), dtype=torch.float32, device=cuda_device) for n in (6000, 5000))
    res = ot.solve_sample(x, y, blur=0.05, max_iter=10)
    calls = []
    kernel = ck.gibbs_apply

    def recorded(*args):
        out = kernel(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(ck, "gibbs_apply", recorded)
    got = _counted("gibbs_apply", lambda: res.a_to_b)
    assert sorted(args[4].shape[1] for args, _ in calls) == [1, 3]
    for args, out in calls:
        ref = ck.gibbs_apply_blocked(*args)
        scale = ck.gibbs_apply_blocked(*args[:4], args[4].abs(), *args[5:]).abs().max()
        assert ((out - ref).abs() <= 3e-5 * scale + 2e-3 * ref.abs()).all()
    res.cache_clear()
    monkeypatch.setattr(ck, "gibbs_apply", ck.gibbs_apply_blocked)
    ref = res.a_to_b
    assert (got - ref).norm() <= 1e-4 * ref.norm()


def test_bench_torch_headline_at_1e4_on_the_card(cuda_device, capsys):
    """bench_torch.py's call at 1e4 points (the online route: N M = 1e8 is
    not above 1e8): its line's device fields measured, its loss within
    1e-3 of the exact online value and of the float64 twins."""
    import bench_torch

    ck.reset_launch_counts()
    line = bench_torch.headline(10_000, "cuda", reps=2)
    assert json.loads(capsys.readouterr().out.strip()) == line
    assert line["loss_rel_err_vs_exact"] <= 1e-3 and line["loss_rel_err_vs_float64"] <= 1e-3
    assert line["events_ms"] > 0 and line["busy_ms"] > 0 and 0 <= line["idle_share"] < 1
    assert line["launches"] > 0 and line["peak_mem_gb"] > 0 and line["device"] not in ("", "cpu")
    assert ck.launch_counts["sinkhorn_step"] > 0 and ck.launch_counts["sinkhorn_step_sym"] > 0


def test_the_recorder_counts_an_online_call_on_the_card(cuda_device):
    """The program's spans and counters (``utils/profiling.py``) on the card:
    the backward spans, run on autograd's device thread, carry the forward's
    call id; the launches counted in the window are the launch counters'
    rise; the pairs are the launches' rows times columns and the triangles
    of the symmetric steps; and the device's events lie on the spans'
    clock."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.utils import profiling

    n = 10_000
    x = torch.randn(n, 3, device=cuda_device).requires_grad_(True)
    y = torch.randn(n, 3, device=cuda_device)
    loss = SamplesLoss("sinkhorn", p=2, blur=0.05, diameter=8.0, backend="online")
    torch.autograd.grad(loss(x, y), x)
    before = {**ck.launch_counts}
    profiling.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(loss(x, y), x)
        torch.cuda.synchronize()
    spans, counts = profiling.spans(), profiling.counts()
    names = collections.Counter(s.name for s in spans)
    assert names["loss"] == 1 and names["backward.SoftminExtrapolation"] == 1
    assert len({s.call_id for s in spans}) == 1
    main = next(s.thread for s in spans if s.name == "loss")
    assert all(s.thread != main for s in spans if s.name.startswith("backward."))
    rise = {k: ck.launch_counts[k] - before[k] for k in before}
    assert {k[len(ck.LAUNCHES):]: v for k, v in counts.items() if k.startswith(ck.LAUNCHES)} == {
        k: v for k, v in rise.items() if v}
    # Each sweep: one step over N M pairs (kernel 2) and two symmetric steps
    # over their triangles (kernel 3); the gradient: kernel 4 over N M and
    # N N (C = 4, one launch each).
    sweeps = names["solver.eps_step"] + 2
    R, _ = ck.sym_step_plan(n)
    tri = sum(ck.sym_step_pairs(n, t0, min(R, -(-n // 256) - t0)) for t0 in range(0, -(-n // 256), R))
    assert counts["kernels.pairs"] == sweeps * (n * n + 2 * tri) + 2 * n * n
    loss_span = next(s for s in spans if s.name == "loss")
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA and "step_kernel" in e.name()]
    assert kernels and all(e.start_ns() >= loss_span.start_ns for e in kernels)
    profiling.reset()


def test_gaussian_multiscale_folds_dx_into_the_forward(cuda_device, monkeypatch):
    """The gaussian multiscale loss at 1e5 on the card: its two matvecs whose
    x requires grad (K_xx a and K_xy b) make the gradient's four-channel
    kernel 8 apply in their forward. Against the same loss with the matvec
    unfolded (the one-channel forward, the four-channel apply in the
    backward): each matvec's value within 1e-6 of the largest, the loss
    within 1e-6, the gradient in x equal to the bit. On the xy table, the
    folded dx is that of the four-channel apply called directly, to the
    bit."""
    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.models import kernel_samples as ks
    from geomloss_tpu_torch.ops import block_sparse as tbs
    from geomloss_tpu_torch.utils import profiling

    n = 100_000
    rng = np.random.RandomState(0)

    def cloud(shift):
        """Weights and points on a sphere of diameter 1, uneven."""
        v = rng.randn(n, 3)
        v[:, 0] += shift
        v /= 2 * np.linalg.norm(v, axis=1, keepdims=True)
        w = np.abs(rng.randn(n))
        return (torch.tensor(t, dtype=torch.float32, device=cuda_device) for t in (w / w.sum(), v))

    a, x = cloud(0.5)
    b, y = cloud(-0.5)
    loss = SamplesLoss("gaussian", blur=0.1, truncate=3, backend="multiscale")
    real = ks.kernel_matvec_sparse

    def unfolded(xx, yy, vv, eps, mask, p=2, block=512, impl="auto"):
        return tbs._KernelMatvecSparse.apply(xx, yy, vv, eps, mask.cols, mask.counts, mask.colsT, mask.countsT,
                                             p, block, impl, False)

    def run(matvec):
        calls = []

        def recorded(*args, **kw):
            out = matvec(*args, **kw)
            calls.append((args, kw, out.detach()))
            return out

        monkeypatch.setattr(ks, "kernel_matvec_sparse", recorded)
        xt = x.clone().requires_grad_(True)
        before = profiling.totals.get("matvec.grad_in_forward", 0)
        value = loss(a, xt, b, y)
        folds = profiling.totals.get("matvec.grad_in_forward", 0) - before
        grad = torch.autograd.grad(value, xt)[0]
        torch.cuda.synchronize()
        return value.detach(), grad, calls, folds

    v1, g1, calls1, folds1 = run(real)
    v0, g0, calls0, folds0 = run(unfolded)
    assert (folds1, folds0) == (2, 0) and len(calls1) == len(calls0) == 3
    for (_, _, o1), (_, _, o0) in zip(calls1, calls0):
        assert (o1 - o0).abs().max().item() <= 1e-6 * o0.abs().max().item()
    assert abs(v1 - v0).item() <= 1e-6 * abs(v0).item()
    assert torch.equal(g1, g0)

    # The xy matvec (the third) on its own table, against the apply:
    (xs, ys, v, eps, mask), kw, _ = calls1[2]
    xs = xs.detach().requires_grad_(True)
    u = torch.randn(xs.shape[0], device=cuda_device)
    out = real(xs, ys.detach(), v.detach(), eps, mask, **kw)
    (dx,) = torch.autograd.grad(out, xs, u)
    z_x, z_y = torch.zeros_like(xs[:, 0]), torch.zeros_like(ys[:, 0])
    V = v.detach()[:, None] * torch.cat([torch.ones_like(ys[:, :1]), ys.detach()], 1)
    R = cbs.gibbs_apply_sparse(xs.detach(), ys.detach(), z_x, z_y, V, eps, mask.cols, mask.counts, 2, "gibbs",
                               kw["block"], kw["block"])
    assert torch.equal(out.detach(), R[:, 0])
    assert torch.equal(dx, (-(u / eps)[:, None] * (xs.detach() * R[:, :1] - R[:, 1:])))
