"""The port's public sparse and walk Sinkhorn ops against the JAX package.

Inputs are made with numpy from a seed and fed to both packages:

* ``walk_plan``: the packed step tables bit for bit, in one chunk and in
  several (``MAX_WALK_ROWS`` lowered in both modules), with a budget that
  clips and one that does not, and a padded last chunk; the port's decoder
  (``cuda_block_sparse._walk_rows``) against a direct reading of the
  table;
* ``sinkhorn_step_sparse`` / ``sinkhorn_step_walk`` (kernels 12 and 10)
  and the ``softmin_extrapolation_sparse`` / ``_walk`` families (kernels
  8 and 11 in their backward passes), values and gradients, against the
  JAX functions, whose Pallas kernels run in interpret mode under
  ``jax.jit``;
* ``gibbs_apply_walk`` for every weight kind;
* float64 cross-checks on full tables: the sparse, walk and banded steps
  and extrapolations, and the dense softmin over the same kept pairs.

The CUDA kernels themselves are held against these twins on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import geomloss_tpu.ops.block_sparse as jbs
from geomloss_tpu_torch.ops import block_sparse as tbs
from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
from geomloss_tpu_torch.ops import cuda_kernels as ck
from torch_parity_utils import (
    APPLY_KINDS,
    P1_FLOOR_SHIFT,
    VAL_TOL,
    apply_tolerance,
    assert_apply_close,
    kept_table,
    p1_floor_bound,
    potentials,
    problem,
)

BLOCK = 128
N_TILES, M_TILES, CAP = 4, 5, 4
EPS = {1: 0.2, 2: 0.1}


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


def _inputs(p, seed, sym=False):
    """Clouds, potentials and both directions of a kept-tile table
    (ragged counts, some rows at the width)."""
    N, M = N_TILES * BLOCK, (N_TILES if sym else M_TILES) * BLOCK
    x, y, _ = problem(N, M, seed=seed)
    f, g, la, lb = potentials(N, M, seed=seed + 1)
    if sym:
        y, g, lb = x, f, la
    nJ = M // BLOCK
    cols, counts = kept_table(N_TILES, nJ, CAP, seed=seed + 2, sym=sym)
    colsT, countsT = (cols, counts) if sym else kept_table(nJ, N_TILES, CAP, seed=seed + 3)
    return (x, y, f, g, la, lb), (cols, counts, colsT, countsT)


def _walk_tables(table, t_mean):
    cols, counts, colsT, countsT = table
    return (cbs.walk_plan(torch.tensor(cols), torch.tensor(counts), t_mean),
            cbs.walk_plan(torch.tensor(colsT), torch.tensor(countsT), t_mean))


# ------------------------------------------------------------------------------
#  Walk tables
# ------------------------------------------------------------------------------

WALK_CASES = [
    # (nI, nJ, cap, t_mean, MAX_WALK_ROWS)
    (5, 7, 5, 5, 1024),  # one chunk, no clip
    (5, 7, 5, 2, 1024),  # one chunk, the clip binds
    (10, 7, 5, 2, 4),  # three chunks, the last padded, the clip binds
    (12, 9, 6, 6, 4),  # three full chunks, no clip
]


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_plan_matches_jax_and_decodes(case, monkeypatch):
    nI, nJ, cap, t_mean, rows = case
    monkeypatch.setattr(jbs, "MAX_WALK_ROWS", rows)
    monkeypatch.setattr(cbs, "MAX_WALK_ROWS", rows)
    cols, counts = kept_table(nI, nJ, cap, seed=nI + t_mean)
    ref = np.asarray(jbs.walk_plan(jnp.asarray(cols), jnp.asarray(counts), t_mean))
    tbl = cbs.walk_plan(torch.tensor(cols), torch.tensor(counts), t_mean)
    assert tbl.dtype == torch.int32
    np.testing.assert_array_equal(tbl.numpy(), ref)
    rows_c = min(nI, rows)
    nc = -(-nI // rows_c)
    padded = np.concatenate([counts, np.ones(nc * rows_c - nI, counts.dtype)])  # padded rows keep one tile
    clipped = (padded.reshape(nc, rows_c).sum(1) > rows_c * t_mean).any()
    assert clipped == (t_mean == 2)

    # A direct reading of the table: each step's row and column tile.
    steps = ref.reshape(-1)
    fl, row, jt = steps >> 26, (steps >> 13) & 0x1FFF, steps & 0x1FFF
    row = row + (np.arange(steps.size) // ref.shape[1]) * rows_c
    live = (fl != 2) & (row < nI)
    want = np.bincount(row[live], minlength=nI)
    flat, start, cnt = cbs._walk_rows(tbl, nI)
    np.testing.assert_array_equal(cnt.numpy(), want)
    assert (cnt.numpy() <= counts).all() and (cnt.numpy() >= 1).all()
    if not clipped:
        np.testing.assert_array_equal(cnt.numpy(), np.minimum(counts, cap))
    for I in range(nI):
        # Each row keeps its best-scoring tiles, in table order:
        got = flat[start[I] : start[I] + cnt[I]].tolist()
        assert got == cols[I, : cnt[I]].tolist()
        assert got == jt[live & (row == I)].tolist()


def test_walk_plan_rejects_tiles_past_13_bits():
    cols = torch.tensor([[0, 8192]], dtype=torch.int32)
    with pytest.raises(ValueError, match="13 bits"):
        cbs.walk_plan(cols, torch.tensor([2], dtype=torch.int32), 2)


# ------------------------------------------------------------------------------
#  Steps and extrapolations against the JAX package
# ------------------------------------------------------------------------------


def _val_tol(p):
    return dict(rtol=VAL_TOL["rtol"], atol=VAL_TOL["atol"] + (P1_FLOOR_SHIFT if p == 1 else 0.0))


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("traversal", ["sparse", "walk"])
def test_sinkhorn_steps_match_jax(traversal, p, sym):
    """Two walk budgets: t_mean = CAP keeps every kept tile, t_mean = 2
    clips rows in both packages."""
    arrays, table = _inputs(p, seed=10 * p + sym, sym=sym)
    eps = EPS[p]
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.tensor(a) for a in arrays]
    x, y, f, g, la, lb = tx
    for t_mean in ((CAP,) if traversal == "sparse" else (CAP, 2)):
        if traversal == "sparse":
            jmask = jbs.TileMask(*map(jnp.asarray, table))
            ref = jbs.sinkhorn_step_sparse(eps, jx[0], jx[1], jx[4], jx[5], jx[2], jx[3], jmask, p=p, block=BLOCK,
                                           sym=sym)
            mask = tbs.TileMask(*map(torch.tensor, table))
            run = lambda impl: tbs.sinkhorn_step_sparse(eps, x, y, la, lb, f, g, mask, p, BLOCK, sym, impl)  # noqa: E731
        else:
            tbl, tblT = _walk_tables(table, t_mean)
            ref = jbs.sinkhorn_step_walk(eps, jx[0], jx[1], jx[4], jx[5], jx[2], jx[3], jnp.asarray(tbl.numpy()),
                                         jnp.asarray(tblT.numpy()), p=p, block=BLOCK, sym=sym)
            run = lambda impl: tbs.sinkhorn_step_walk(eps, x, y, la, lb, f, g, tbl, tblT, p, BLOCK, sym, impl)  # noqa: E731
        for impl in ("blocked", "auto"):  # the twin, and the wrapper on CPU tensors
            got = run(impl)
            assert (got[1] is None) == sym
            for a, b in zip(got, ref):
                if b is not None:
                    np.testing.assert_allclose(_np(a), np.asarray(b), **_val_tol(p))


EXTRAPOLATIONS = ["sparse", "sparse_sym", "sparse_dir", "walk", "walk_sym"]


def _port_extrapolation(op, tensors, eps, tables, p, impl):
    x, y, f, g, la, lb = tensors
    cols, counts, colsT, countsT, tbl, tblT = tables
    if op == "sparse":
        return tbs.softmin_extrapolation_sparse(x, y, f, g, la, lb, eps, cols, counts, colsT, countsT, p, BLOCK, impl)
    if op == "sparse_sym":
        return (tbs.softmin_extrapolation_sparse_sym(x, f, la, eps, cols, counts, p, BLOCK, impl),)
    if op == "sparse_dir":
        return (tbs.softmin_extrapolation_sparse_dir(x, y, f, g, la, lb, eps, cols, counts, p, BLOCK, impl),)
    if op == "walk":
        return tbs.softmin_extrapolation_walk(x, y, f, g, la, lb, eps, tbl, tblT, p, BLOCK, impl)
    return (tbs.softmin_extrapolation_walk_sym(x, f, la, eps, tbl, p, BLOCK, impl),)


def _jax_extrapolation(op, arrays, eps, tables, p):
    x, y, f, g, la, lb = arrays
    cols, counts, colsT, countsT, tbl, tblT = tables
    if op == "sparse":
        return jbs.softmin_extrapolation_sparse(x, y, f, g, la, lb, eps, cols, counts, colsT, countsT, p, BLOCK)
    if op == "sparse_sym":
        return (jbs.softmin_extrapolation_sparse_sym(x, f, la, eps, cols, counts, p, BLOCK),)
    if op == "sparse_dir":
        return (jbs.softmin_extrapolation_sparse_dir(x, y, f, g, la, lb, eps, cols, counts, p, BLOCK),)
    if op == "walk":
        return jbs.softmin_extrapolation_walk(x, y, f, g, la, lb, eps, tbl, tblT, p, BLOCK)
    return (jbs.softmin_extrapolation_walk_sym(x, f, la, eps, tbl, p, BLOCK),)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("op", EXTRAPOLATIONS)
def test_extrapolations_match_jax(op, p):
    """Values to VAL_TOL, gradients in x and y (of a linear read-out of the
    outputs) to the JAX suite's gradient tolerance and to 1e-3 (relative
    L2) of the port's float64 twins. The walk tables clip rows."""
    sym = op.endswith("sym")
    arrays, table = _inputs(p, seed=20 + 3 * p + EXTRAPOLATIONS.index(op), sym=sym)
    eps = EPS[p]
    tables = (*map(torch.tensor, table), *_walk_tables(table, 3))
    rng = np.random.RandomState(p)
    w = [rng.randn(len(arrays[0])).astype(np.float32), rng.randn(len(arrays[1])).astype(np.float32)]

    def jfun(x, y):
        outs = _jax_extrapolation(op, (x, y, *map(jnp.asarray, arrays[2:])), eps,
                                  [jnp.asarray(_np(t)) for t in tables], p)
        return sum((o * jnp.asarray(wk)).sum() for o, wk in zip(outs, w)), outs

    (_, ref), ref_g = jax.jit(jax.value_and_grad(jfun, argnums=(0, 1), has_aux=True))(
        jnp.asarray(arrays[0]), jnp.asarray(arrays[1]))

    grads = {}
    for impl, dt in (("auto", torch.float32), ("blocked", torch.float64)):
        x, y = (torch.tensor(a, dtype=dt, requires_grad=True) for a in arrays[:2])
        rest = [torch.tensor(a, dtype=dt) for a in arrays[2:]]
        outs = _port_extrapolation(op, (x, y, *rest), eps, tables, p, impl)
        if impl == "auto":
            for a, b in zip(outs, ref):
                np.testing.assert_allclose(_np(a), np.asarray(b), **_val_tol(p))
        read = sum((o * torch.tensor(wk, dtype=dt)).sum() for o, wk in zip(outs, w))
        grads[dt] = torch.autograd.grad(read, (x, y), allow_unused=True)
    for d in range(2):
        got, ref64 = grads[torch.float32][d], grads[torch.float64][d]
        b = np.asarray(ref_g[d])
        if op.endswith("sym") and d == 1:  # no second cloud
            continue
        if op == "sparse_dir" and d == 1:
            assert got is not None and not got.any() and not b.any()  # zeros for y
            continue
        np.testing.assert_allclose(_np(got), b, rtol=1e-3, atol=1e-3 * np.abs(b).max() + 1e-9)
        assert ((got.double() - ref64).norm() / ref64.norm()).item() <= 1e-3


@pytest.mark.parametrize("p,kind", APPLY_KINDS)
def test_gibbs_apply_walk_matches_jax(p, kind, monkeypatch):
    """Kernel 11's twin over a two-chunk walk table whose budget clips
    rows, V = [1, y] (C = 4), against the Pallas kernel in interpret
    mode."""
    monkeypatch.setattr(jbs, "MAX_WALK_ROWS", 2)
    monkeypatch.setattr(cbs, "MAX_WALK_ROWS", 2)
    (x, y, f, g, la, lb), table = _inputs(p, seed=40 + p)
    rng = np.random.RandomState(7)
    phi = (-np.abs(rng.randn(x.shape[0]))).astype(np.float32)
    psi = (0.1 * rng.randn(y.shape[0])).astype(np.float32)
    V = np.concatenate([np.ones((y.shape[0], 1), np.float32), y], 1)
    eps = 0.5
    tbl, _ = _walk_tables(table, 2)
    ref = jbs.gibbs_apply_walk(*map(jnp.asarray, (x, y, phi, psi, V)), eps, jnp.asarray(tbl.numpy()), p=p,
                               kind=kind, block_n=BLOCK, block_m=BLOCK)
    args = (*map(torch.tensor, (x, y, phi, psi, V)), eps, tbl, p, kind, BLOCK, BLOCK)
    got = cbs.gibbs_apply_walk_blocked(*args)
    tol = apply_tolerance(x, y, phi, psi, V, eps, p, kind)
    if p == 1 and kind in ("gibbs", "gibbs_grad"):
        tol["atol"] = tol["atol"] + p1_floor_bound(x, y, phi, psi, V, eps, kind)
    assert got.shape == (x.shape[0], V.shape[1])
    assert_apply_close(got, np.asarray(ref), **tol)
    # The port's tbs entry point and the wrapper on CPU tensors are the twin:
    cbs.reset_launch_counts()
    assert torch.equal(tbs.gibbs_apply_walk(*args), got)
    assert not any(cbs.launch_counts.values())


def test_walk_wrappers_check_their_tables():
    x, phi = torch.zeros(256, 3), torch.zeros(256)
    tbl = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples"):
        cbs.absorbed_sum_walk(x[:200], x, phi[:200], phi, 0.1, tbl, 2, 128)
    with pytest.raises(ValueError, match="walk_plan table"):
        cbs.absorbed_sum_walk(x, x, phi, phi, 0.1, torch.zeros((2, 4), dtype=torch.int32), 2, 128)
    with pytest.raises(ValueError, match="phi"):
        cbs.absorbed_sum_sparse(x, x, phi[:7], phi, 0.1, tbl[:, :2].expand(2, 2), torch.ones(2), 2, 128)
    with pytest.raises(ValueError, match="kind"):
        cbs.gibbs_apply_walk(x, x, phi, phi, x, 0.1, tbl, 2, "cosine", 128, 128)


def test_public_names():
    """The three names of the JAX package's ``__all__`` that the port
    lacked; the other ops are module attributes, as there."""
    for name in ("sinkhorn_step_sparse", "softmin_extrapolation_sparse", "softmin_extrapolation_sparse_sym"):
        assert name in tbs.__all__ and name in jbs.__all__
    for name in ("walk_plan", "sinkhorn_step_walk", "softmin_extrapolation_walk", "softmin_extrapolation_walk_sym",
                 "softmin_extrapolation_sparse_dir", "gibbs_apply_walk"):
        assert callable(getattr(tbs, name)) and callable(getattr(jbs, name))


# ------------------------------------------------------------------------------
#  float64 cross-checks on full tables
# ------------------------------------------------------------------------------


def _full_tables(nI, nJ, seed, sym=False):
    """Both directions of one kept pair set, each row keeping every tile of
    positive score (no row at a cap), and the (N, M) kept-pair matrix."""
    rng = np.random.RandomState(seed)
    score = rng.rand(nI, nJ) - 0.4
    k = np.arange(max(nI, nJ))
    score[k % nI, k % nJ] += 1  # every row and column keeps a tile of its own
    if sym:
        score = score + score.T
    cols, counts, _ = tbs._cols_from_score(torch.tensor(score), nJ)
    colsT, countsT, _ = tbs._cols_from_score(torch.tensor(score.T), nI)
    K = torch.tensor(score > 0).repeat_interleave(BLOCK, 0).repeat_interleave(BLOCK, 1)
    return (cols, counts, colsT, countsT), K


def _dense_softmin(x, y, f, g, la, lb, eps, p, K):
    C = ck._sqdist(x, y)
    C = C / 2 if p == 2 else torch.sqrt(torch.clamp(C, min=ck.SQDIST_FLOOR))
    logW = (la + f / eps)[:, None] + (lb + g / eps)[None, :] - C / eps
    return f + eps * (la - torch.logsumexp(torch.where(K, logW, -torch.inf), dim=1))


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("p", [1, 2])
def test_full_tables_float64_cross_check(p, sym):
    """sinkhorn_step_sparse = sinkhorn_step_walk = the banded step = the
    dense softmin over the kept pairs, and the same for the
    extrapolations' gradients, to 1e-10 in float64."""
    nI, nJ = 3, (3 if sym else 4)
    (x, y, f, g, la, lb), _ = _inputs(p, seed=60 + p, sym=sym)
    x, y, f, g, la, lb = (torch.tensor(a[: (nI if k in (0, 2, 4) else nJ) * BLOCK], dtype=torch.float64)
                          for k, a in enumerate((x, y, f, g, la, lb)))
    if sym:
        y, g, lb = x, f, la
    (cols, counts, colsT, countsT), K = _full_tables(nI, nJ, seed=p, sym=sym)
    assert 0 < int(counts.sum()) < nI * nJ
    tbl = tbs.walk_plan(cols, counts, nJ)
    tblT = tbs.walk_plan(colsT, countsT, nI)
    mask = tbs.TileMask(cols, counts, colsT, countsT)
    eps = EPS[p]
    close = dict(rtol=1e-10, atol=1e-12)
    dense = _dense_softmin(x, y, f, g, la, lb, eps, p, K)
    sparse = tbs.sinkhorn_step_sparse(eps, x, y, la, lb, f, g, mask, p, BLOCK, sym, "blocked")
    walk = tbs.sinkhorn_step_walk(eps, x, y, la, lb, f, g, tbl, tblT, p, BLOCK, sym, "blocked")
    if sym:
        banded = (tbs.sinkhorn_step_walk_banded_sym(eps, x, la, f, cols, counts, p, BLOCK, "blocked"),)
    else:
        banded = tbs.sinkhorn_step_walk_banded(eps, x, y, la, lb, f, g, cols, counts, p, BLOCK, "blocked")
        dense = (dense, _dense_softmin(y, x, g, f, lb, la, eps, p, K.T))
    for want, got in zip(dense if not sym else (dense,), zip(sparse, walk, banded)):
        for a in got:
            torch.testing.assert_close(a, want, **close)

    # The gradients of the extrapolations in x (and y), all four ways:
    u = torch.tensor(np.random.RandomState(3).rand(x.shape[0]))
    grads = []
    for kind in ("sparse", "walk", "banded", "dense"):
        xt = x.clone().requires_grad_()
        yt = xt if sym else y.clone().requires_grad_()
        if sym:
            S = {
                "sparse": lambda: tbs.softmin_extrapolation_sparse_sym(xt, f, la, eps, cols, counts, p, BLOCK, "blocked"),
                "walk": lambda: tbs.softmin_extrapolation_walk_sym(xt, f, la, eps, tbl, p, BLOCK, "blocked"),
                "banded": lambda: tbs.softmin_extrapolation_walk_banded_sym(xt, f, la, eps, cols, counts, p, BLOCK,
                                                                            "blocked"),
                "dense": lambda: _dense_softmin(xt, xt.detach(), f, f, la, la, eps, p, K),
            }[kind]()
            out = (u * S).sum()
        else:
            S, T = {
                "sparse": lambda: tbs.softmin_extrapolation_sparse(xt, yt, f, g, la, lb, eps, cols, counts, colsT,
                                                                   countsT, p, BLOCK, "blocked"),
                "walk": lambda: tbs.softmin_extrapolation_walk(xt, yt, f, g, la, lb, eps, tbl, tblT, p, BLOCK,
                                                               "blocked"),
                "banded": lambda: tbs.softmin_extrapolation_walk_banded(xt, yt, f, g, la, lb, eps, cols, counts, p,
                                                                        BLOCK, "blocked"),
                "dense": lambda: (_dense_softmin(xt, yt.detach(), f, g, la, lb, eps, p, K),
                                  _dense_softmin(yt, xt.detach(), g, f, lb, la, eps, p, K.T)),
            }[kind]()
            out = (u * S).sum() + T.sum()
        grads.append(torch.autograd.grad(out, (xt,) if sym else (xt, yt)))
    for got in grads[:3]:
        for a, b in zip(got, grads[3]):
            torch.testing.assert_close(a, b, **close)
