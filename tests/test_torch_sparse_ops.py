"""The port's truncated operators over (cols, counts) tables against the
JAX package.

Inputs are made with numpy from a seed and fed to both packages:

* ``masks_from_geometry``: the same tables (kept columns and counts,
  both directions) exactly, on inputs where the JAX package's SMEM clamp
  on the table width does not bind; with no ``cap``, the port's table
  keeps every kept tile where the JAX package's default width keeps each
  row's best 8, so it equals the JAX table built at the port's width;
* the plain twin of kernel 8 (``gibbs_apply_sparse``) against the Pallas
  kernel it replaces, run in interpret mode (as the JAX package runs it off
  the TPU), for every weight kind and several channel counts, at the apply
  tolerances of ``tests/test_pallas_kernels.py`` plus, for p = 1, the
  bound of the Pallas noise floor (``torch_parity_utils``);
* ``softmin_sparse`` and ``kernel_matvec_sparse``: values and gradients;
* the backward passes run only the applies autograd asks for.

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
from geomloss_tpu_torch.ops.spatial import hilbert_key
from geomloss_tpu_torch.utils import profiling as prof
from geomloss_tpu_torch.utils import tile_mask_from_numpy
from torch_parity_utils import (
    APPLY_KINDS,
    _apply_weights64,
    VAL_TOL,
    apply_tolerance,
    assert_apply_close,
    kept_table,
    p1_floor_bound,
    problem,
)

BLOCK = 128


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


def _mask(mask):
    return tile_mask_from_numpy(mask, device="cpu")


def _sorted(pts):
    """Points in Hilbert order, as the multiscale path sorts them: tiles and
    sub-blocks of consecutive points are then compact."""
    return pts[torch.argsort(hilbert_key(torch.tensor(pts), bits=4), stable=True).numpy()]


def _jax_clamp(nI, nJ):
    """The JAX package's SMEM bound on the table width of
    ``masks_from_geometry`` (``block_sparse.py:2593``)."""
    return max(8, 400_000 // (4 * min(max(nI, nJ), jbs.MAX_TABLE_ROWS)))


@pytest.mark.parametrize("cap", [None, 16])
@pytest.mark.parametrize("case", ["xy", "sym", "padded", "ragged"])
def test_masks_from_geometry_match_jax(case, cap):
    """N = 2048 points in the unit cube in Hilbert order, tiles of
    128, a radius of 0.1: part of the tiles kept, and the JAX clamp (6,250
    here) above the width. With ``cap=None`` the port's default width
    grows past the JAX package's (8 here) to the largest kept count: the
    JAX table is built at that width, and its counts are those of an
    uncapped table."""
    rng = np.random.RandomState(len(case))
    N, M = 2048, (1536 if case == "ragged" else 2048)
    x = _sorted(rng.rand(N, 3))
    y = x if case == "sym" else _sorted(rng.rand(M, 3))
    w_x = w_y = None
    if case == "padded":
        w_x = np.where(np.arange(N) < N - 300, 1.0 / N, 0.0)
        w_y = np.where(np.arange(M) < M - 700, 1.0 / M, 0.0)
    kw = dict(cap=cap, sym=case == "sym")
    got = tbs.masks_from_geometry(
        torch.tensor(x), torch.tensor(y), 0.1, BLOCK,
        w_x=None if w_x is None else torch.tensor(w_x), w_y=None if w_y is None else torch.tensor(w_y), **kw,
    )
    nI, nJ = N // BLOCK, M // BLOCK

    def jax_masks(cap):
        return jbs.masks_from_geometry(
            jnp.asarray(x), jnp.asarray(y), 0.1, BLOCK, cap=cap, sym=case == "sym",
            w_x=None if w_x is None else jnp.asarray(w_x), w_y=None if w_y is None else jnp.asarray(w_y),
        )

    ref = jax_masks(cap if cap is not None else max(got.cols.shape[1], got.colsT.shape[1]))
    if cap is None:
        for f in ("counts", "countsT"):
            np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(jax_masks(max(nI, nJ)), f)), err_msg=f)
    assert got.cols.shape[1] <= _jax_clamp(nI, nJ)
    for f in ("cols", "counts", "colsT", "countsT"):
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(_np(got.vals), _np(ref.vals), rtol=1e-12, atol=1e-12)
    counts = _np(got.counts)
    assert 0 < counts.min() and counts.sum() < nI * nJ  # part of the tiles kept
    if case == "padded":
        assert counts[-2:].max() <= 1  # pure-padding row tiles keep nothing but their fallback
    # The transpose of a mask is the (y-rows, x-cols) direction:
    t = got.transpose()
    assert t.cols is got.colsT and t.countsT is got.counts


@pytest.mark.parametrize("C", [1, 4, 5])
@pytest.mark.parametrize("p,kind", APPLY_KINDS)
def test_gibbs_apply_sparse_twin_matches_jax(p, kind, C):
    """4 row tiles of 128 against 3 source tiles of 256, ragged counts."""
    N, M, bn, bm = 512, 768, 128, 256
    x, y, psi = problem(N, M, seed=C + 3 * p)
    rng = np.random.RandomState(C)
    phi = (-np.abs(rng.randn(N))).astype(np.float32)
    V = rng.randn(M, C).astype(np.float32)
    cols, counts = kept_table(N // bn, M // bm, 3, seed=p)
    assert counts.min() < counts.max()
    eps = 0.5
    ref = jbs.gibbs_apply_sparse(
        *map(jnp.asarray, (x, y, phi, psi, V)), eps, jnp.asarray(cols), jnp.asarray(counts),
        p=p, kind=kind, block_n=bn, block_m=bm,
    )
    args = (*map(torch.tensor, (x, y, phi, psi, V)), eps, torch.tensor(cols), torch.tensor(counts), p, kind, bn, bm)
    got = cbs.gibbs_apply_sparse_blocked(*args)
    tol = apply_tolerance(x, y, phi, psi, V, eps, p, kind)
    if p == 1 and kind in ("gibbs", "gibbs_grad"):
        tol["atol"] = tol["atol"] + p1_floor_bound(x, y, phi, psi, V, eps, kind)
    assert got.shape == (N, C) and got.dtype == torch.float32
    assert_apply_close(got, _np(ref), **tol)
    # On CPU tensors the wrapper is the twin, and launches nothing:
    cbs.reset_launch_counts()
    assert torch.equal(cbs.gibbs_apply_sparse(*args), got)
    assert cbs.launch_counts["gibbs_apply_sparse"] == 0


def test_gibbs_apply_sparse_rejects_bad_input():
    x, y = torch.zeros(256, 3), torch.zeros(512, 3)
    cols, cnt = torch.zeros((2, 1), dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    z_n, z_m, V = torch.zeros(256), torch.zeros(512), torch.zeros(512, 2)
    with pytest.raises(ValueError, match="multiples"):
        cbs.gibbs_apply_sparse(x, y, z_n, z_m, V, 0.1, cols, cnt, 2, "gibbs", 100, 256)
    with pytest.raises(ValueError, match="V"):
        cbs.gibbs_apply_sparse(x, y, z_n, z_m, V[:7], 0.1, cols, cnt, 2, "gibbs", 128, 256)
    with pytest.raises(ValueError, match="kind"):
        cbs.gibbs_apply_sparse(x, y, z_n, z_m, V, 0.1, cols, cnt, 2, "cosine", 128, 256)


def _tables(x, y, eps, p):
    """Both directions of a truncation table of the JAX package's
    softmin_sparse tests (build_tile_masks at a margin that keeps part of
    the tiles)."""
    f, g = jnp.zeros(x.shape[0]), jnp.zeros(y.shape[0])
    return jbs.build_tile_masks(jnp.asarray(x), jnp.asarray(y), f, g, eps, p, truncate=3, block=BLOCK)


@pytest.mark.parametrize("p", [1, 2])
def test_softmin_sparse_matches_jax(p):
    x, y, h = problem(512, 768, seed=20 + p)
    x, y, h = _sorted(x), _sorted(y), (0.1 * h).astype(np.float32)
    eps = 0.05 if p == 2 else 0.2
    jmask = _tables(x, y, eps, p)
    assert int(jmask.counts.sum()) < (512 // BLOCK) * (768 // BLOCK)

    def jfun(x, y, h):
        return (jbs.softmin_sparse(eps, (x, y, jmask), h, p=p, block=BLOCK) ** 2).sum()

    ref = jbs.softmin_sparse(eps, (jnp.asarray(x), jnp.asarray(y), jmask), jnp.asarray(h), p=p, block=BLOCK)
    ref_g = jax.jit(jax.grad(jfun, argnums=(0, 1, 2)))(*map(jnp.asarray, (x, y, h)))

    mask = _mask(jmask)
    xt, yt, ht = (torch.tensor(v, requires_grad=True) for v in (x, y, h))
    got = tbs.softmin_sparse(eps, (xt, yt, mask), ht, p=p, block=BLOCK)
    torch.testing.assert_close(got.detach(), torch.tensor(_np(ref)), **VAL_TOL)
    got_g = torch.autograd.grad((got**2).sum(), (xt, yt, ht))
    for a, b in zip(got_g, ref_g):
        b = _np(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-3, atol=1e-3 * np.abs(b).max() + 1e-9)


def _p1_grad_bound(x, y, u, v, eps):
    """Bounds on how far the Pallas p = 1 weights move the gradients of
    ``<u, K v>`` in x ``(N, 1)`` and y ``(M, 1)``. Each pair term is
    ``u_i v_j w'_ij (x_i - y_j) / eps`` with ``w' = w / d``:

    * a pair within twice the noise floor (``p1_floor_bound``) enters the
      Pallas weight with distance 0 in the exponent and its noisy
      expansion-form distance (at least the 1e-3 cut) as divisor, so its
      whole term, at most ``|u_i| v_j max(1, d / 1e-3) / eps``, may differ;
    * any other pair carries twice the float32 error of the expansion form
      through ``w'`` (``torch_parity_utils.apply_tolerance``), times ``d``.
    """
    xn, yn = x.astype(np.float64), y.astype(np.float64)
    sq = ((xn[:, None, :] - yn[None, :, :]) ** 2).sum(-1)
    d = np.sqrt(sq)
    near = sq <= 4e-6 * ((xn**2).sum(-1)[:, None] + (yn**2).sum(-1)[None, :])
    _, dW = _apply_weights64(x, y, np.zeros(len(x)), np.zeros(len(y)), eps, 1, "gibbs_grad")
    uv = np.abs(u)[:, None] * np.abs(v)[None, :] / eps
    T = np.where(near, 2 * uv * np.maximum(1, d / 1e-3), 2 * uv * dW * d)
    return T.sum(1)[:, None], T.sum(0)[:, None]


def _matvec_case(p, sym):
    """A centred elongated box, 4 x 0.5 x 0.5, sorted along its length, so
    that tiles of 128 out of 512 points keep part of the others (and the
    p = 1 floor, ``d <= sqrt(2e-6 (|x|^2 + |y|^2))``, stays below 3e-3
    away from the self pairs): its geometry table at 3 blur (blur 0.1),
    weights ``v`` and a linear read-out ``w``, as ``(x, y, v, eps,
    jax_mask, w)``."""
    box = np.array([4.0, 0.5, 0.5], np.float32)
    x, y, _ = problem(512, 512 if sym else 768, seed=30 + p)
    x, y = (v[np.argsort(v[:, 0], kind="stable")] for v in (box * (x - 0.5), box * (y - 0.5)))
    if sym:
        y = x
    v = np.random.RandomState(p).rand(y.shape[0]).astype(np.float32)
    blur = 0.1
    eps = blur**p
    jmask = jbs.masks_from_geometry(jnp.asarray(x), jnp.asarray(y), 3 * blur, BLOCK, sym=sym)
    assert int(jmask.counts.sum()) < (x.shape[0] // BLOCK) * (y.shape[0] // BLOCK)
    # A linear read-out: both backward passes get the same cotangent.
    w = np.random.RandomState(p + 7).randn(x.shape[0]).astype(np.float32)
    return x, y, v, eps, jmask, w


def _matvec_jax_grads(x, y, v, eps, jmask, w, p):
    """The JAX package's gradients of ``sum(w * K v)`` in x, y and v."""

    def jfun(x, y, v):
        return (jbs.kernel_matvec_sparse(x, y, v, eps, jmask, p=p, block=BLOCK) * w).sum()

    return jax.jit(jax.grad(jfun, argnums=(0, 1, 2)))(*map(jnp.asarray, (x, y, v)))


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("p", [1, 2])
def test_kernel_matvec_sparse_matches_jax(p, sym):
    """The MMD matvec over a geometry table (:func:`_matvec_case`), values
    and gradients in x, y and v; ``sym`` is a self term (y is x), where
    p = 1 meets the Pallas noise floor on the self pairs."""
    x, y, v, eps, jmask, w = _matvec_case(p, sym)
    ref = jbs.kernel_matvec_sparse(*map(jnp.asarray, (x, y, v)), eps, jmask, p=p, block=BLOCK)
    ref_g = _matvec_jax_grads(x, y, v, eps, jmask, w, p)

    mask = _mask(jmask)
    xt, yt, vt = (torch.tensor(a, requires_grad=True) for a in (x, y, v))
    got = tbs.kernel_matvec_sparse(xt, yt, vt, eps, mask, p=p, block=BLOCK)
    # The apply tolerance: the Pallas kernel's expansion-form distances
    # carry a float32 error of a few ulps of |x|^2 + |y|^2 (up to 64 here).
    zx, zy = np.zeros(x.shape[0], np.float32), np.zeros(y.shape[0], np.float32)
    tol = apply_tolerance(x, y, zx, zy, v[:, None], eps, p, "gibbs")
    if p == 1:
        tol["atol"] = tol["atol"] + p1_floor_bound(x, y, zx, zy, v[:, None], eps, "gibbs")
    assert_apply_close(got[:, None], _np(ref)[:, None], **tol)
    got_g = torch.autograd.grad((got * torch.tensor(w)).sum(), (xt, yt, vt))
    floor = _p1_grad_bound(x, y, w, v, eps) + (0,) if p == 1 else (0, 0, 0)
    for a, b, f in zip(got_g, ref_g, floor):
        b = _np(b)
        assert_apply_close(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max() + f)


def _fold_counts():
    return tuple(prof.totals.get(k, 0) for k in ("matvec.forwards", "matvec.grad_in_forward"))


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("wrt", ["x", "xyv"])
def test_kernel_matvec_sparse_folded_forward(wrt, sym):
    """p = 2 with x requiring grad: the forward's one four-channel apply
    gives the value of the one-channel apply in its channel 0, and the
    channels it keeps give the gradients in x (alone, or with y and v) of
    the JAX package, on the plain twin."""
    x, y, v, eps, jmask, w = _matvec_case(2, sym)
    ref_g = _matvec_jax_grads(x, y, v, eps, jmask, w, 2)
    mask = _mask(jmask)
    xt, yt, vt = (torch.tensor(a, requires_grad=k in wrt) for k, a in zip("xyv", (x, y, v)))
    before = _fold_counts()
    got = tbs.kernel_matvec_sparse(xt, yt, vt, eps, mask, p=2, block=BLOCK)
    assert np.subtract(_fold_counts(), before).tolist() == [1, 1]
    zx, zy = torch.zeros(x.shape[0]), torch.zeros(y.shape[0])
    plain = cbs.gibbs_apply_sparse_blocked(torch.tensor(x), torch.tensor(y), zx, zy, torch.tensor(v)[:, None], eps,
                                           mask.cols, mask.counts, 2, "gibbs", BLOCK, BLOCK)[:, 0]
    torch.testing.assert_close(got.detach(), plain, rtol=1e-6, atol=1e-6 * plain.abs().max().item())
    inputs = [t for k, t in zip("xyv", (xt, yt, vt)) if k in wrt]
    got_g = torch.autograd.grad((got * torch.tensor(w)).sum(), inputs)
    for a, b in zip(got_g, [g for k, g in zip("xyv", ref_g) if k in wrt]):
        b = _np(b)
        assert_apply_close(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max())


@pytest.mark.parametrize("case", ["grad", "no_grad", "p1", "x_constant"])
def test_kernel_matvec_sparse_fold_counters(case):
    """``matvec.forwards`` counts every forward and
    ``matvec.grad_in_forward`` the folded ones: p = 2, grad enabled and x
    requiring grad."""
    p = 1 if case == "p1" else 2
    x, y, v, eps, jmask, _ = _matvec_case(p, False)
    xt = torch.tensor(x, requires_grad=case != "x_constant")
    before = _fold_counts()
    with torch.set_grad_enabled(case != "no_grad"):
        tbs.kernel_matvec_sparse(xt, torch.tensor(y), torch.tensor(v), eps, _mask(jmask), p=p, block=BLOCK)
    assert np.subtract(_fold_counts(), before).tolist() == [1, int(case == "grad")]


_BACKWARD_CASES = [
    ("softmin", 2, "x", 1, True), ("softmin", 2, "h", 1, True), ("softmin", 1, "xh", 2, True),
    ("softmin", 2, "xyh", 2, True),
    ("matvec", 2, "x", 0, True), ("matvec", 2, "v", 1, True), ("matvec", 1, "xv", 2, True),
    ("matvec", 1, "xyv", 3, True), ("matvec", 1, "x", 1, True), ("matvec", 2, "x", 0, False),
]


@pytest.mark.parametrize(
    "op,p,wrt,applies,grad", _BACKWARD_CASES,
    ids=[f"{op}-{p}-{wrt}-{n}" + ("" if grad else "-no_grad") for op, p, wrt, n, grad in _BACKWARD_CASES],
)
def test_sparse_backward_runs_only_the_needed_applies(monkeypatch, op, p, wrt, applies, grad):
    """The MMD self terms detach y and v: their backward takes the one
    apply that gives dx, not all three. The gaussian matvec (p = 2) with
    grad enabled and x requiring grad makes that apply in its forward, one
    of four channels whose first is the output, and none in its backward;
    under ``no_grad``, and for p = 1, its forward is the one-channel
    apply."""
    calls = []  # (kind, channels) of each apply
    real = tbs._sparse_apply

    def counting(impl):
        fn = real(impl)

        def apply(*args):
            calls.append((args[-3], args[4].shape[1]))
            return fn(*args)

        return apply

    monkeypatch.setattr(tbs, "_sparse_apply", counting)
    x, y, h = problem(256, 384, seed=p)
    cols, cnt = kept_table(2, 3, 2, seed=p)
    colsT, cntT = kept_table(3, 2, 2, seed=p + 1)
    mask = tbs.TileMask(*map(torch.tensor, (cols, cnt, colsT, cntT)))
    t = {k: torch.tensor(v, requires_grad=k in wrt) for k, v in zip("xyh", (x, y, h))}
    if op == "softmin":
        out = tbs.softmin_sparse(0.3, (t["x"], t["y"], mask), t["h"], p=p, block=BLOCK)
    else:
        t["v"] = torch.tensor(np.abs(h), requires_grad="v" in wrt)
        with torch.set_grad_enabled(grad):
            out = tbs.kernel_matvec_sparse(t["x"], t["y"], t["v"], 0.3, mask, p=p, block=BLOCK)
        fold = grad and p == 2 and "x" in wrt
        assert calls == [("gibbs", 4 if fold else 1)]
        calls.clear()  # the forward pass's apply
        if not grad:
            assert out.grad_fn is None
            return
    inputs = [t[k] for k in wrt]
    grads = torch.autograd.grad(out.sum(), inputs)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert len(calls) == applies
