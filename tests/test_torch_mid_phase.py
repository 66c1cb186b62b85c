"""The port's multiscale mid path (above ``N_FINE_OK`` points) against the
JAX package.

Inputs are made with numpy from a seed and fed to both packages; JAX runs
as its own tests run it on the CPU (Pallas in interpret mode):

* the mid path's sizing rules (``mid_cap``, ``mid_delay``, the keep-score
  sub-blocks) equal the JAX package's;
* ``extrap_cols`` in the JAX form of its rule (``radii=False``) gives the
  same tables (kept columns and counts) bit for bit, and its default keeps
  every tile they keep; ``build_tile_masks`` gives the same tables bit for
  bit where no sub-block passes its slack, p in {1, 2}, symmetric or not,
  with zero-mass padding; the keep
  scores agree to 1e-12 (the float64 centroid products round in another
  order); where sub-blocks pass it, the port's tables keep every tile the
  JAX package's keep;
* the plain twin of kernel 7 (``lse_tiles_blocked``), through
  ``softmin_extrap_truncated``, against the JAX function of the same name,
  which runs ``lse_walk`` in interpret mode, at the value tolerance of
  ``tests/test_pallas_kernels.py`` (rtol = atol = 2e-5 on the softmin
  values). The inputs keep JAX's walk budget from clipping any kept tile,
  and the test asserts it; the port visits every kept tile. A full table
  through the twin in float64 equals the dense LSE to 1e-12;
* one whole mid-path solve of both packages at N = M = 2048 with
  ``N_FINE_OK`` lowered to 512 in both modules, value and gradient, on the
  JAX rule's tables; the port's default against its solve on tables of
  every tile;
* a port-only solve at N = 8192 whose mid cloud holds every point
  (``_B_MID_OVERRIDE = 1``), so that the truncated extrapolations run,
  against ``truncate=None``.

The CUDA kernel itself is held against its twin on the card by
``tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import geomloss_tpu.ops.block_sparse as jbs
from geomloss_tpu.models import multiscale as jms
from geomloss_tpu_torch.models import multiscale as tms
from geomloss_tpu_torch.ops import block_sparse as tbs
from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
from geomloss_tpu_torch.ops.spatial import hilbert_key
from torch_parity_utils import VAL_TOL


def _np(t):
    return t.detach().cpu().numpy()


def _sorted_cube(n, seed, shift=0.0):
    """Points in a unit cube, in Hilbert order (coherent tiles)."""
    x = np.random.RandomState(seed).rand(n, 3) + shift
    order = torch.argsort(hilbert_key(torch.tensor(x), bits=6), stable=True).numpy()
    return x[order]


@pytest.mark.parametrize("n_pad,tile", [(1 << 21, 1024), (1 << 22, 1024), (1 << 23, 1024), (4096, 256)])
def test_mid_sizing_matches_jax(n_pad, tile):
    assert tms.mid_cap(n_pad, tile) == jms.mid_cap(n_pad, tile)
    assert tbs._stat_block(n_pad, tile) == jbs._stat_block(n_pad, tile)
    eps_list = [2.0**-k for k in range(12)]
    for n in (n_pad, n_pad // 2 + 1):
        assert tms.mid_delay(n, eps_list, 5, 0.5, 2) == jms.mid_delay(n, eps_list, 5, 0.5, 2)


def _sorted_strip(n, seed, shift=0.0):
    """Points of a thin strip along the first axis, sorted along it: its
    sub-blocks of 64 points are short, none past the keep rule's slack."""
    r = np.random.RandomState(seed)
    x = np.c_[r.rand(n) + shift, r.rand(n, 2) / 100]
    return x[np.argsort(x[:, 0], kind="stable")]


def _kept_sets(cols, counts):
    return [set(row[:n].tolist()) for row, n in zip(np.asarray(cols), np.asarray(counts))]


def _tile_mask_inputs(p, sym, cloud):
    """N = 4096 in tiles of 256 (sub-blocks of 64), the last 300 points of
    zero mass (one pure-padding tile)."""
    N = 4096
    rng = np.random.RandomState(p + 2 * sym)
    x, y = cloud(N, 1), cloud(N, 2, shift=0.1)
    wx, wy = rng.rand(N) + 0.1, rng.rand(N) + 0.1
    wx[-300:] = 0.0
    wy[-300:] = 0.0
    f = 0.05 * np.sin(3 * x[:, 0]) + 0.01 * rng.randn(N)
    g = 0.05 * np.cos(2 * y[:, 1]) + 0.01 * rng.randn(N)
    if sym:
        y, wy, g = x, wx, f
    eps = 0.01 if p == 2 else 0.05
    return (x, y, f, g), wx, wy, eps


def _both_tile_masks(args, wx, wy, eps, p, sym, **kw):
    jm = jbs.build_tile_masks(
        *map(jnp.asarray, args), eps, p, 5, 256, w_x=jnp.asarray(wx), w_y=jnp.asarray(wy), sym=sym, **kw
    )
    tm = tbs.build_tile_masks(
        *map(torch.tensor, args), eps, p, 5, 256, w_x=torch.tensor(wx), w_y=torch.tensor(wy), sym=sym, **kw
    )
    return jm, tm


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("sym", [False, True])
def test_build_tile_masks_matches_jax(p, sym):
    """On a Hilbert-sorted cube, whose sub-blocks of 64 points pass the
    port's slack (radii up to 0.39 of a unit cube), every tile JAX keeps
    the port keeps, in each row both ways (default widths: neither clips).
    On a thin strip, whose sub-blocks stay inside the slack, the tables
    are the JAX package's bit for bit at a cap below the tile count (8),
    and the keep scores agree to 1e-12 (the float64 centroid products round
    in another order)."""
    N, tile, cap = 4096, 256, 8
    args, wx, wy, eps = _tile_mask_inputs(p, sym, _sorted_cube)
    jm, tm = _both_tile_masks(args, wx, wy, eps, p, sym)
    seams = 0
    for cols, counts in (("cols", "counts"), ("colsT", "countsT")):
        kept_j = _kept_sets(getattr(jm, cols), getattr(jm, counts))
        kept_t = _kept_sets(_np(getattr(tm, cols)), _np(getattr(tm, counts)))
        assert all(j <= t for j, t in zip(kept_j, kept_t)), cols
        seams += sum(len(t - j) for j, t in zip(kept_j, kept_t))
    assert seams > 0  # the cube's sub-blocks pass the slack: the port keeps more

    args, wx, wy, eps = _tile_mask_inputs(p, sym, _sorted_strip)
    slack = tbs.keep_slack(eps, p, 5)
    for pts, w in ((args[0], wx), (args[1], wy)):
        blocks, wb = pts.reshape(-1, 64, 3), w.reshape(-1, 64)
        cent = (blocks * wb[..., None]).sum(1) / np.maximum(wb.sum(1), 1e-30)[:, None]
        assert (np.linalg.norm(blocks - cent[:, None], axis=-1)[wb > 0].max()) < slack
    jm, tm = _both_tile_masks(args, wx, wy, eps, p, sym, cap=cap)
    for name in ("cols", "counts", "colsT", "countsT"):
        np.testing.assert_array_equal(_np(getattr(tm, name)), np.asarray(getattr(jm, name)), err_msg=name)
    for name in ("vals", "valsT"):
        np.testing.assert_allclose(_np(getattr(tm, name)), np.asarray(getattr(jm, name)), rtol=1e-12, atol=1e-12)
    counts = _np(tm.counts)
    # Ragged tables that prune, and the padding tile is never kept:
    assert counts.min() < counts.max() <= cap and (counts < N // tile).all()
    assert not (_np(tm.cols)[counts > 1] == N // tile - 1).any()


@pytest.mark.parametrize("p", [1, 2])
def test_extrap_cols_matches_jax(p):
    """4096 rows in tiles of 256 against 8192 sources in tiles of 128. The
    JAX form of the keep rule (``radii=False``: the upper bound at the
    centroid distance) gives the JAX package's table bit for bit at its cap
    of 32; the port's default (the upper bound at the centroid distance less
    both radii, a true bound) keeps every tile the JAX table keeps, and
    more."""
    x, y = _sorted_cube(4096, 3), _sorted_cube(8192, 4, shift=0.05)
    h = 0.1 * np.random.RandomState(p).randn(8192)
    eps = 0.01 if p == 2 else 0.05
    jc, jn = jbs.extrap_cols(jnp.asarray(x), jnp.asarray(y), jnp.asarray(h), eps, 5, 256, 128, 32, p=p)
    args = (torch.tensor(x), torch.tensor(y), torch.tensor(h), eps, 5, 256, 128)
    tc, tn = tbs.extrap_cols(*args, 32, p=p, radii=False)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    assert tc.shape == (16, 32) and _np(tn).min() >= 1
    dc, dn = tbs.extrap_cols(*args, p=p)
    kept_j, kept_d = _kept_sets(jc, jn), _kept_sets(_np(dc), _np(dn))
    assert all(j <= d for j, d in zip(kept_j, kept_d))
    assert sum(len(d - j) for j, d in zip(kept_j, kept_d)) > 0


def _strip(n, seed, z=0.0):
    """A thin strip along the first axis, sorted along it: row tiles and
    source tiles stay short, so the kept sets are small. The sources sit
    2 widths above the rows, beyond the Pallas p = 1 noise floor."""
    r = np.random.RandomState(seed)
    x = np.c_[r.rand(n) - 0.5, (r.rand(n, 2) + [0.0, z]) / 160]
    return x[np.argsort(x[:, 0], kind="stable")].astype(np.float32)


def _walk_budget_binds(counts, cap, rows_per_chunk=1024):
    """Whether JAX's ``walk_plan`` would clip kept tiles: a chunk of row
    tiles keeping more than ``rows x max(12, cap // 2)`` steps."""
    budget = max(12, cap // 2)
    c = np.asarray(counts)
    return any(c[i : i + rows_per_chunk].sum() > budget * len(c[i : i + rows_per_chunk])
               for i in range(0, len(c), rows_per_chunk))


@pytest.mark.parametrize("p,eps", [(2, 0.01 / 64), (1, 0.03 / 8)])
def test_truncated_extrapolation_twin_matches_jax_lse_walk(p, eps):
    """2048 rows (tiles of 256) against 8192 sources (tiles of 128), cap 32:
    the port's twin against ``lse_walk`` in interpret mode. For p = 1 the
    Pallas kernel sets distances below sqrt(2e-6 (|x|^2 + |y|^2)) to 0;
    here every pair lies beyond that floor, so the values compare at the
    plain value tolerance."""
    x, y = _strip(2048, 1), _strip(8192, 2, z=2.0)
    h = (0.1 * np.random.RandomState(3).randn(8192)).astype(np.float32)
    cols, counts = tbs.extrap_cols(*map(torch.tensor, (x, y, h)), eps, 5, 256, 128, 32, p=p)
    assert not _walk_budget_binds(_np(counts), 32)
    assert _np(counts).max() < 8192 // 128  # the table truncates
    ref = jbs.softmin_extrap_truncated(*map(jnp.asarray, (x, y, h)), eps, 5, 256, p=p, block_m=128, cap=32)
    got = tbs.softmin_extrap_truncated(
        *map(torch.tensor, (x, y, h)), eps, 5, 256, p=p, block_m=128, cap=32, impl="blocked"
    )
    np.testing.assert_allclose(_np(got), np.asarray(ref), **VAL_TOL)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("block_n,block_m", [(128, 64), (64, 96)])
def test_lse_tiles_twin_full_table_equals_dense(p, block_n, block_m):
    """With every source tile kept, the float64 twin is the dense LSE."""
    rng = np.random.RandomState(block_n + p)
    N, M = 4 * block_n, 5 * block_m
    x, y, h = rng.rand(N, 3), rng.rand(M, 3), rng.randn(M)
    nJ = M // block_m
    cols = torch.tensor(np.tile(np.arange(nJ, dtype=np.int32)[::-1].copy(), (N // block_n, 1)))
    cnt = torch.full((N // block_n,), nJ, dtype=torch.int32)
    got = cbs.lse_tiles(*map(torch.tensor, (x, y, h)), 0.3, cols, cnt, block_n, block_m, p)
    d2 = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    C = d2 / 2 if p == 2 else np.sqrt(np.maximum(d2, 1e-8))
    expected = torch.logsumexp(torch.tensor(h[None, :] - C / 0.3), dim=1)
    np.testing.assert_allclose(_np(got), _np(expected), rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------------------
#  Whole solves
# ------------------------------------------------------------------------------

KW = dict(blur=0.05, diameter=2.0, scaling=0.5, tile=128, target_clusters=128)


def _clouds(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3)
    y = rng.rand(n, 3) + 0.1
    a = rng.rand(n) + 0.5
    b = rng.rand(n) + 0.5
    return a / a.sum(), x, b / b.sum(), y


def _port(a, x, b, y, **kw):
    """Value and gradient in x of the port's solve, float64, plain twins."""
    xt = torch.tensor(x, requires_grad=True)
    v = tms.sinkhorn_multiscale(torch.tensor(a), xt, torch.tensor(b), torch.tensor(y), impl="blocked", **kw)
    v.backward()
    return v.item(), xt.grad.numpy()


def _rel(got, ref):
    return np.linalg.norm(np.asarray(got) - ref) / np.linalg.norm(ref)


def test_mid_path_matches_jax(monkeypatch, capsys):
    """N = M = 2048, p = 2, N_FINE_OK = 512 in both modules: one mid
    iteration on 512 pooled blocks of 4, then the fine phase on tables from
    build_tile_masks. Where the tables coincide (the port's rule at an
    infinite slack, the JAX rule): the JAX fine phase runs in float32 (its
    kernels cast), value within 1e-5 relative, gradient within 1e-4
    relative L2, the tolerances of tests/test_torch_multiscale.py. The
    port's default rule keeps more tiles: its solve is held to the same
    float64 solve whose fine tables keep every tile (value 1e-9 relative,
    gradient 1e-8 relative L2; 1.8e-12 and 3.4e-10 measured), which the
    JAX rule misses by 1 % in value and 4.4 % in gradient."""
    monkeypatch.setattr(jms, "N_FINE_OK", 512)
    monkeypatch.setattr(tms, "N_FINE_OK", 512)
    a, x, b, y = _clouds(seed=2, n=2048)
    aj, bj, yj = map(jnp.asarray, (a, b, y))
    jax.clear_caches()
    jv, jg = jax.value_and_grad(lambda x: jms.sinkhorn_multiscale(aj, x, bj, yj, p=2, **KW))(jnp.asarray(x))
    jax.clear_caches()
    v, g = _port(a, x, b, y, p=2, verbose=True, **KW)
    assert "Intermediate scale: 512x512 pooled blocks of 4" in capsys.readouterr().out
    build = tms.build_tile_masks
    monkeypatch.setattr(tms, "build_tile_masks", lambda *a_, **k: build(*a_, **dict(k, eps_min=math.inf)))
    v_jax_rule, g_jax_rule = _port(a, x, b, y, p=2, **KW)
    assert abs(v_jax_rule - float(jv)) <= 1e-5 * abs(float(jv))
    assert _rel(g_jax_rule, np.asarray(jg)) <= 1e-4
    monkeypatch.setattr(tms, "build_tile_masks", lambda *a_, **k: build(*a_[:6], 1e6, *a_[7:], **k))
    v_all, g_all = _port(a, x, b, y, p=2, **KW)
    assert abs(v - v_all) <= 1e-9 * abs(v_all)
    assert _rel(g, g_all) <= 1e-8
    assert _rel(g_jax_rule, g_all) > 1e-2


def test_mid_path_truncated_extrapolation(monkeypatch):
    """N = M = 8192 with N_FINE_OK = 4096 (one mid iteration) and the mid
    cloud holding every point (_B_MID_OVERRIDE = 1: 64 source tiles of 128,
    the gate of the truncated extrapolations). The four extrapolations run
    the twin of kernel 7 and visit every kept tile, on tables as wide as
    their largest kept count; the solve stays within
    1e-2 of truncate=None, the bound of tests/test_multiscale_structure.py."""
    monkeypatch.setattr(tms, "N_FINE_OK", 4096)
    monkeypatch.setattr(tms, "_B_MID_OVERRIDE", 1)
    calls = []
    twin = cbs.lse_tiles_blocked

    def spy(x, y, h, eps, cols, cnt, block_n, block_m, p=2):
        calls.append((x.shape[0], y.shape[0], block_n, block_m, cols.shape[0]))
        widths.append((cols.shape[1], int(cnt.max())))
        return twin(x, y, h, eps, cols, cnt, block_n, block_m, p)

    widths = []
    monkeypatch.setattr(cbs, "lse_tiles_blocked", spy)
    a, x, b, y = _clouds(seed=5, n=8192)
    KW8 = dict(blur=0.05, diameter=2.0, scaling=0.5, tile=512, target_clusters=128)
    v, g = _port(a, x, b, y, p=2, **KW8)
    assert calls == [(8192, 8192, 512, 128, 16)] * 4
    # The width's floor, extrap_cap(64) = max(8, min(64, ceil(64 / 4 / 8) * 8)) = 16,
    # grows to the largest kept count rounded up to 8 (here 49-64 of the 64 source tiles):
    assert all(w == max(16, -(-most // 8) * 8) for w, most in widths)
    assert min(most for _, most in widths) > 16
    v_x, g_x = _port(a, x, b, y, p=2, truncate=None, **KW8)
    assert np.isfinite(v) and np.isfinite(g).all()
    assert abs(v - v_x) <= 1e-2 * abs(v_x)
