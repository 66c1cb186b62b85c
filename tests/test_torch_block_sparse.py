"""The port's multiscale building blocks against the JAX package.

Inputs are made with numpy from a seed and fed to both packages:

* ``hilbert_key`` and ``spatial_sort_blocks``: integer keys and
  permutations, and the sorted, padded arrays, exactly equal;
* ``masks_from_coarse``: the same tables (kept columns and counts) exactly,
  and the same kept counts after each ``retighten_counts`` shift;
* the plain twins of the two block-sparse kernels against the banded walk
  kernels they replace, run in interpret mode (as the JAX package runs them
  off the TPU), at the value tolerances of ``tests/test_pallas_kernels.py``
  (``torch_parity_utils``);
* the differentiable extrapolations against ``torch.autograd`` through
  the dense float64 formula on the same kept pairs;
* the float32 gradient of the extrapolation with the ones channel against
  the ``x - R/r`` form of the JAX package.

The CUDA kernels themselves are held against these twins on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import geomloss_tpu.ops.block_sparse as jbs
from geomloss_tpu.models import multiscale as jms
from geomloss_tpu.ops.spatial import hilbert_key as jax_hilbert_key
from geomloss_tpu.ops.spatial import radix_sort_perm
from geomloss_tpu_torch.models import multiscale as tms
from geomloss_tpu_torch.ops import block_sparse as tbs
from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
from geomloss_tpu_torch.ops import cuda_kernels as ck
from geomloss_tpu_torch.ops.spatial import hilbert_key
from geomloss_tpu_torch.utils import tile_mask_from_numpy
from torch_parity_utils import P1_FLOOR_SHIFT, VAL_TOL, apply_tolerance, assert_apply_close, kept_table

BLOCK = 128


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


@pytest.mark.parametrize("D,bits", [(2, 8), (3, 10), (3, 5)])
def test_hilbert_key_matches_jax(D, bits):
    x = np.random.RandomState(D + bits).randn(3000, D)
    expected = np.asarray(jax_hilbert_key(jnp.asarray(x), bits=bits))
    got = hilbert_key(torch.tensor(x), bits=bits).numpy()
    np.testing.assert_array_equal(got, expected)
    # A stable argsort is the permutation of the JAX package's radix sort:
    perm = np.asarray(radix_sort_perm(jnp.asarray(expected), total_bits=D * bits))
    np.testing.assert_array_equal(torch.argsort(torch.tensor(got), stable=True).numpy(), perm)


def test_labels_sort_matches_jax_below_2_18():
    """Labels in [0, 2^18): the port's sort by (label, Hilbert index) gives
    the JAX package's permutation. Past that bound the JAX package's radix
    sort reads 18 bits of each label (a property of the reference): labels
    2^18 + k sort as k there, while the port sorts whole labels."""
    N = 3000
    rng = np.random.RandomState(18)
    x = rng.rand(N, 3)
    a = rng.rand(N) + 0.1
    kw = dict(cluster_scale=0.1, diameter=2.0, block_size=32, pad_multiple=512)
    lab = rng.choice([0, 1, 977, (1 << 18) - 1], N)
    jp = jms.spatial_sort_blocks(jnp.asarray(a), jnp.asarray(x), labels=jnp.asarray(lab), **kw)[2]
    tp = tms.spatial_sort_blocks(torch.tensor(a), torch.tensor(x), labels=torch.tensor(lab), **kw)[2]
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    wide = np.where(lab == 1, 1 << 18, lab)  # sorts as label 0 in the JAX package
    jp = jms.spatial_sort_blocks(jnp.asarray(a), jnp.asarray(x), labels=jnp.asarray(wide), **kw)[2]
    tp = tms.spatial_sort_blocks(torch.tensor(a), torch.tensor(x), labels=torch.tensor(wide), **kw)[2]
    folded = np.where(lab == 1, 0, lab)
    tf = tms.spatial_sort_blocks(torch.tensor(a), torch.tensor(x), labels=torch.tensor(folded), **kw)[2]
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jp))
    assert not np.array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize(
    "N,labels",
    [(2048, False), (8192, False), (6000, False), (3000, True)],
    ids=["kd-2048", "hilbert-8192", "hilbert-padded-6000", "labels-3000"],
)
def test_spatial_sort_blocks_matches_jax(N, labels):
    rng = np.random.RandomState(N)
    x = rng.rand(N, 3)
    a = rng.rand(N) + 0.1
    lab = rng.randint(0, 7, N) if labels else None
    kw = dict(cluster_scale=0.1, diameter=2.0, block_size=32, pad_multiple=512)
    (jw, ja), (jc, jx), jp = jms.spatial_sort_blocks(
        jnp.asarray(a), jnp.asarray(x), labels=None if lab is None else jnp.asarray(lab), **kw
    )
    (tw, ta), (tc, tx), tp = tms.spatial_sort_blocks(
        torch.tensor(a), torch.tensor(x), labels=None if lab is None else torch.tensor(lab), **kw
    )
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    # Block sums and centroids: the same float64 reductions up to order.
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-13)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-12, atol=1e-14)


def _coarse_state(K, seed, D=3):
    """Block centroids, weights (some zero, as padding blocks) and
    potentials of the scale of a coarse solve."""
    rng = np.random.RandomState(seed)
    cx = rng.rand(K, D)
    cy = rng.rand(K, D) + 0.2
    wx = rng.rand(K) * (rng.rand(K) > 0.1)
    wy = rng.rand(K) * (rng.rand(K) > 0.1)
    f = 0.02 * rng.randn(K)
    g = 0.02 * rng.randn(K)
    return cx, cy, wx, wy, f, g


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("sym", [False, True])
def test_masks_from_coarse_matches_jax(p, sym):
    cx, cy, wx, wy, f, g = _coarse_state(512, seed=p + 2 * sym)
    if sym:
        cy, wy, g = cx, wx, f
    eps, truncate, bpt, cap = 0.01 if p == 2 else 0.1, 5, 8, 20
    args = (cx, cy, f, g, wx, wy)
    jm = jbs.masks_from_coarse(*map(jnp.asarray, args), eps, p, truncate, bpt, cap=cap, sym=sym)
    tm = tbs.masks_from_coarse(*map(torch.tensor, args), eps, p, truncate, bpt, cap=cap, sym=sym)
    for name in ("cols", "counts", "colsT", "countsT"):
        np.testing.assert_array_equal(_np(getattr(tm, name)), np.asarray(getattr(jm, name)), err_msg=name)
    np.testing.assert_allclose(_np(tm.vals), np.asarray(jm.vals), rtol=1e-12, atol=1e-12)
    # The same tables carried over through numpy:
    carried = tile_mask_from_numpy(jm, device="cpu")
    np.testing.assert_array_equal(carried.cols.numpy(), tm.cols.numpy())
    # Later temperatures re-threshold the same tables identically:
    for delta in (0.0, -0.25 * truncate * eps, -0.9 * truncate * eps):
        np.testing.assert_array_equal(
            tbs.retighten_counts(tm.vals, delta).numpy(),
            np.asarray(jbs.retighten_counts(jm.vals, delta)),
        )


def test_tile_stats_matches_jax():
    x = np.random.RandomState(3).rand(1024, 3)
    jc, jr = jbs.tile_stats(jnp.asarray(x), 128)
    tc, tr = tbs.tile_stats(torch.tensor(x), 128)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-14)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-14)


# ------------------------------------------------------------------------------
#  Kernel twins against the banded walk kernels (interpret mode)
# ------------------------------------------------------------------------------


def _step_problem(n_tiles, m_tiles, seed, D=3):
    """float32 clouds, small potentials and uniform log-weights, as in
    tests/test_walk_banded.py."""
    rng = np.random.RandomState(seed)
    N, M = n_tiles * BLOCK, m_tiles * BLOCK
    x = rng.randn(N, D).astype(np.float32)
    y = (rng.randn(M, D) + 0.5).astype(np.float32)
    f = (0.1 * rng.randn(N)).astype(np.float32)
    g = (0.1 * rng.randn(M)).astype(np.float32)
    la = np.full(N, -np.log(N), np.float32)
    lb = np.full(M, -np.log(M), np.float32)
    return x, y, f, g, la, lb


@pytest.mark.parametrize("p", [1, 2])
def test_absorbed_sum_twin_matches_jax_banded(p):
    n_tiles, m_tiles, cap, eps = 5, 7, 5, 0.3
    x, y, f, g, la, lb = _step_problem(n_tiles, m_tiles, seed=p)
    cols, counts = kept_table(n_tiles, m_tiles, cap, seed=10 + p)
    assert counts.min() < counts.max() <= cap  # ragged rows
    tbl = jbs.walk_plan_banded(jnp.asarray(cols), jnp.asarray(counts), cap, m_tiles, band_tiles=4)
    j = jbs.sinkhorn_step_walk_banded(
        eps, *map(jnp.asarray, (x, y, la, lb, f, g)), tbl, p=p, block=BLOCK, band_tiles=4
    )
    t = [torch.tensor(v) for v in (x, y, la, lb, f, g)]
    tc, tn = torch.tensor(cols), torch.tensor(counts)
    for impl in ("blocked", "auto"):  # the twin, and the wrapper on CPU tensors
        got = tbs.sinkhorn_step_walk_banded(eps, *t, tc, tn, p, BLOCK, impl)
        for a, b in zip(got, j):
            np.testing.assert_allclose(_np(a), np.asarray(b), **VAL_TOL)


@pytest.mark.parametrize("p", [1, 2])
def test_absorbed_sum_twin_matches_jax_banded_triangle(p):
    n_tiles, cap, eps = 6, 4, 0.3
    x, _, f, _, la, _ = _step_problem(n_tiles, n_tiles, seed=20 + p)
    cols, counts = kept_table(n_tiles, n_tiles, cap, seed=30 + p, sym=True)
    tbl = jbs.walk_plan_banded(
        jnp.asarray(cols), jnp.asarray(counts), cap, n_tiles, band_tiles=4, tri=True
    )
    j = jbs.sinkhorn_step_walk_banded_sym(
        eps, jnp.asarray(x), jnp.asarray(la), jnp.asarray(f), tbl, p=p, block=BLOCK, band_tiles=4
    )
    got = tbs.sinkhorn_step_walk_banded_sym(
        eps, torch.tensor(x), torch.tensor(la), torch.tensor(f), torch.tensor(cols),
        torch.tensor(counts), p, BLOCK, "blocked",
    )
    # Mirrored column sums reassociate the summation (tests/test_walk_banded.py):
    # rtol = atol = 3e-5. For p=1 the self pair of each row adds the JAX
    # kernel's noise floor (torch_parity_utils.P1_FLOOR_SHIFT).
    atol = 3e-5 + (P1_FLOOR_SHIFT if p == 1 else 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=3e-5, atol=atol)


@pytest.mark.parametrize("tri", [False, True])
@pytest.mark.parametrize("p,kind", [(2, "gibbs"), (1, "gibbs_grad")])
def test_gibbs_apply_twin_matches_jax_banded(p, kind, tri):
    n_tiles, cap, eps = 4, 3, 0.25
    m_tiles = n_tiles if tri else 5
    x, y, f, g, la, lb = _step_problem(n_tiles, m_tiles, seed=40 + p)
    # Small norms: the JAX kernel's expansion-form noise on a self pair
    # (a few ulps of 2|x|^2) then stays under the 1e-6 cut of gibbs_grad.
    x, y = 0.3 * x, 0.3 * y
    if tri:
        y, g, lb = x, f, la
    cols, counts = kept_table(n_tiles, m_tiles, cap, seed=50 + p, sym=tri)
    rng = np.random.RandomState(60)
    Vy = rng.randn(y.shape[0], 4).astype(np.float32)
    Vx = rng.randn(x.shape[0], 4).astype(np.float32)
    phi, psi = la + f / eps, lb + g / eps
    tbl = jbs.walk_plan_banded(
        jnp.asarray(cols), jnp.asarray(counts), cap, m_tiles, band_tiles=2, tri=tri,
        rows_chunk=jbs.MAX_APPLY_ROWS,
    )
    jr, jc = jbs.gibbs_apply_walk_banded(
        *map(jnp.asarray, (x, y, phi, psi, Vy, Vx)), eps, tbl, p=p, kind=kind, block=BLOCK,
        band_tiles=2,
    )
    tr, tc = cbs.gibbs_apply_tiles_blocked(
        *map(torch.tensor, (x, y, phi, psi, Vy, Vx)), eps, torch.tensor(cols),
        torch.tensor(counts), p, kind, BLOCK, tri,
    )
    # The tolerance of the online applies against the Pallas kernels
    # (torch_parity_utils.apply_tolerance), taken over all pairs: an upper
    # bound for the kept ones.
    assert_apply_close(tr, np.asarray(jr), **apply_tolerance(x, y, phi, psi, Vy, eps, p, kind))
    assert_apply_close(tc, np.asarray(jc), **apply_tolerance(y, x, psi, phi, Vx, eps, p, kind))


def test_wrappers_check_their_tables():
    x = torch.zeros(256, 3)
    cols, cnt = torch.zeros((2, 1), dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples of the tile"):
        cbs.absorbed_sum_tiles(x[:200], x, x[:200, 0], x[:, 0], 0.1, cols, cnt, 2, 128)
    with pytest.raises(ValueError, match="cols must be"):
        cbs.absorbed_sum_tiles(x, x, x[:, 0], x[:, 0], 0.1, cols[:1], cnt, 2, 128)
    with pytest.raises(ValueError, match="kind"):
        cbs.gibbs_apply_tiles(x, x, x[:, 0], x[:, 0], x, x, 0.1, cols, cnt, 2, "energy", 128)


def test_kept_pairs_are_the_table_prefix():
    """Row tile I keeps cols[I, :cnt[I]]; a triangle table keeps the ones
    at or above the diagonal, in table order."""
    cols = torch.tensor([[2, 0, 1], [1, 0, 2], [0, 2, 1]], dtype=torch.int32)
    cnt = torch.tensor([2, 3, 1], dtype=torch.int32)
    assert cbs.kept_pairs(cols, cnt).view(3, 3).tolist() == [[2, 0, -1], [1, 0, 2], [0, -1, -1]]
    assert cbs.kept_pairs(cols, cnt, tri=True).view(3, 3).tolist() == [[2, 0, -1], [1, -1, 2], [-1, -1, -1]]


@pytest.mark.parametrize("tri", [False, True])
def test_column_index_groups_live_slots_in_slot_order(tri):
    """The second pass of the kernels sums column tile J over
    order[offsets[J]:offsets[J+1]]: the live slots of column J in slot
    order, the diagonal left out of a triangle table. The slots come
    compacted: the table's kept pairs in row-major order, then the dead
    slots (column -1), which every sum leaves out."""
    cols, counts = kept_table(6, 6, 4, seed=3, sym=tri)
    slot_j = cbs.kept_pairs(torch.tensor(cols), torch.tensor(counts), tri)
    si, sj = cbs._live_slots(torch.tensor(cols), torch.tensor(counts), tri)
    live = [s for s in range(24) if slot_j[s] >= 0]
    n = len(live)
    assert si[:n].tolist() == [s // 4 for s in live] and sj[:n].tolist() == [int(slot_j[s]) for s in live]
    assert sj[n:].eq(-1).all() and si[n:].eq(cbs._DEAD_ROW).all()
    np.testing.assert_array_equal(cbs._offsets(si, 6).numpy(), np.searchsorted([s // 4 for s in live], range(7)))
    order, offsets = cbs._column_index(si, sj, 6, tri)
    for J in range(6):
        got = order[offsets[J] : offsets[J + 1]].tolist()
        want = [q for q, s in enumerate(live) if slot_j[s] == J and not (tri and s // 4 == J)]
        assert got == want
    assert offsets[6] == sum(len(order[offsets[J] : offsets[J + 1]]) for J in range(6))


def test_wrappers_on_cpu_count_no_launch():
    cbs.reset_launch_counts()
    x, y, f, g, la, lb = (torch.tensor(v) for v in _step_problem(2, 2, seed=0))
    cols, cnt = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32), torch.tensor([2, 1], dtype=torch.int32)
    tbs.sinkhorn_step_walk_banded(0.3, x, y, la, lb, f, g, cols, cnt, 2, BLOCK)
    cbs.gibbs_apply_tiles(x, y, f, g, y, x, 0.3, cols, cnt, 2, "gibbs", BLOCK)
    assert all(n == 0 for n in cbs.launch_counts.values())


# ------------------------------------------------------------------------------
#  Differentiable extrapolations
# ------------------------------------------------------------------------------


def _kept_dense(cols, cnt, nI, nJ, tri):
    """(N, M) bool matrix of the kept pairs (both triangles for ``tri``)."""
    K = torch.zeros((nI, nJ), dtype=torch.bool)
    slot_j = cbs.kept_pairs(cols, cnt, tri).view(nI, -1)
    for I in range(nI):
        K[I, slot_j[I][slot_j[I] >= 0].long()] = True
    if tri:
        K = K | K.T
    return K.repeat_interleave(BLOCK, 0).repeat_interleave(BLOCK, 1)


def _dense_softmin(x, y, f, g, la, lb, eps, p, K):
    """S_i = f_i + eps (la_i - log sum_{j kept} exp(la_i + lb_j + (f_i + g_j - C_ij)/eps))."""
    C = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    C = C / 2 if p == 2 else torch.sqrt(torch.clamp(C, min=ck.SQDIST_FLOOR))
    logW = (la + f / eps)[:, None] + (lb + g / eps)[None, :] - C / eps
    logW = torch.where(K, logW, torch.full_like(logW, -torch.inf))
    return f + eps * (la - torch.logsumexp(logW, dim=1))


@pytest.mark.parametrize("p", [1, 2])
def test_extrapolation_grads_match_dense_autograd(p):
    n_tiles, m_tiles, cap, eps = 3, 4, 3, 0.2
    arrays = [v.astype(np.float64) for v in _step_problem(n_tiles, m_tiles, seed=70 + p)]
    cols, counts = kept_table(n_tiles, m_tiles, cap, seed=80 + p)
    cols, counts = torch.tensor(cols), torch.tensor(counts)
    x, y, f, g, la, lb = (torch.tensor(v) for v in arrays)
    rng = np.random.RandomState(90)
    u, v = torch.tensor(rng.rand(x.shape[0])), torch.tensor(rng.rand(y.shape[0]))

    xt, yt = x.clone().requires_grad_(), y.clone().requires_grad_()
    S, T = tbs.softmin_extrapolation_walk_banded(xt, yt, f, g, la, lb, eps, cols, counts, p, BLOCK, "blocked")
    ((u * S).sum() + (v * T).sum()).backward()

    K = _kept_dense(cols, counts, n_tiles, m_tiles, False)
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    S_r = _dense_softmin(xr, yr.detach(), f, g, la, lb, eps, p, K)
    T_r = _dense_softmin(yr, xr.detach(), g, f, lb, la, eps, p, K.T)
    ((u * S_r).sum() + (v * T_r).sum()).backward()
    for got, ref in ((S, S_r), (T, T_r), (xt.grad, xr.grad), (yt.grad, yr.grad)):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("p", [1, 2])
def test_extrapolation_sym_grads_match_dense_autograd(p):
    n_tiles, cap, eps = 4, 3, 0.2
    x, _, f, _, la, _ = (torch.tensor(v.astype(np.float64)) for v in _step_problem(n_tiles, n_tiles, seed=100 + p))
    cols, counts = kept_table(n_tiles, n_tiles, cap, seed=110 + p, sym=True)
    cols, counts = torch.tensor(cols), torch.tensor(counts)
    u = torch.tensor(np.random.RandomState(120).rand(x.shape[0]))

    xt = x.clone().requires_grad_()
    S = tbs.softmin_extrapolation_walk_banded_sym(xt, f, la, eps, cols, counts, p, BLOCK, "blocked")
    (u * S).sum().backward()

    xr = x.clone().requires_grad_()
    S_r = _dense_softmin(xr, xr.detach(), f, f, la, la, eps, p, _kept_dense(cols, counts, n_tiles, n_tiles, True))
    (u * S_r).sum().backward()
    np.testing.assert_allclose(S.detach().numpy(), S_r.detach().numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), rtol=1e-10, atol=1e-12)


def test_extrapolation_backward_ones_channel_beats_x_minus_R_over_r():
    """The float32 gradient of the banded extrapolation (p=2) against
    float64: the ones-channel form u (x R_0 - R_1:) / r that the port uses
    against the u (x - R_1: / r) form of the JAX package, computed here
    from the same float32 sums. The second turns the float32 mismatch
    between the forward's row sums r and the backward's R_0 into an error
    of |y| over the small displacement x - T(x)."""
    n_tiles, cap, eps, p = 4, 4, 0.0025, 2
    rng = np.random.RandomState(5)
    N = n_tiles * BLOCK
    x = rng.rand(N, 3) + 1.0
    y = x + 0.02 * rng.randn(N, 3)
    la = np.full(N, -np.log(N))
    cols, counts = kept_table(n_tiles, n_tiles, cap, seed=6)
    cols, counts = torch.tensor(cols), torch.tensor(counts)
    z = np.zeros(N)

    def grad(dtype):
        xt = torch.tensor(x, dtype=dtype, requires_grad=True)
        yt, zt, lt = (torch.tensor(v, dtype=dtype) for v in (y, z, la))
        S, _ = tbs.softmin_extrapolation_walk_banded(xt, yt, zt, zt, lt, lt, eps, cols, counts, p, BLOCK, "blocked")
        S.sum().backward()
        return S.detach(), xt.grad.double()

    S32, dx32 = grad(torch.float32)
    _, dx64 = grad(torch.float64)
    # The x - R/r form from the same float32 sums:
    x32, y32, z32, l32 = (torch.tensor(v, dtype=torch.float32) for v in (x, y, z, la))
    R, _ = cbs.gibbs_apply_tiles_blocked(
        x32, y32, l32, l32, torch.cat([torch.ones_like(y32[:, :1]), y32], 1),
        torch.cat([torch.ones_like(x32[:, :1]), x32], 1), eps, cols, counts, p, "gibbs", BLOCK,
    )
    r = torch.clamp(torch.exp(l32 + (z32 - S32) / eps), min=ck.SUM_FLOOR)
    dx_alt = (x32 - R[:, 1:] / r[:, None]).double()
    err = ((dx32 - dx64).norm() / dx64.norm()).item()
    err_alt = ((dx_alt - dx64).norm() / dx64.norm()).item()
    assert err < err_alt, (err, err_alt)
