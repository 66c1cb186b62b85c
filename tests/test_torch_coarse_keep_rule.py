"""The classic path's coarse keep rule (``masks_from_coarse``) and the mid
path's extrapolation keep rule (``extrap_cols``) on data along curves.

The JAX package scores a pair of coarse cluster blocks by their centroids
alone, and bounds a source sub-block's scores from above by its centroid
distance to a row sub-block. A block that straddles a jump of the sort
order (a seam) has its centroid far from all its points, so both rules
dropped the nearest tiles of such blocks at any table width. The port's
rules subtract the radii: ``masks_from_coarse`` each cluster block's beyond
a slack of half the keep radius (``block_sparse.keep_slack``, as
``build_tile_masks``), ``extrap_cols`` both sub-blocks' in full.

* the classic path on the gallery's fiber bundles (8,160 points, tiles 32
  and 64), float64, plain twins: its potentials within 1e-2 eps of the
  same solve whose ``masks_from_coarse`` keeps every tile (the centroid
  rule missed it by 1.78 eps at tile 32);
* the mid path on the same fibers (``N_FINE_OK`` and ``EXTRAP_BM`` lowered
  as in ``tests/test_torch_mid_keep_rule.py``): within 1e-2 eps of the solve
  whose fine and extrapolation tables keep every tile (0.745 eps before,
  all of it the extrapolation rule's);
* on a Hilbert-sorted cube and on the fibers, p in {1, 2}: every tile pair
  ``masks_from_coarse`` drops obeys its docstring's bound, ``f_c[k] +
  g_c[l] - C(|x_i - y_j| + 2 s) <= -truncate * e`` for each of its point
  pairs of positive weight, at the build temperature and at the finest one
  the table serves; every source tile ``extrap_cols`` drops obeys ``h_j -
  C_ij / eps <= max_j' (h_j' - C_ij' / eps) - truncate``; on the fibers the
  JAX forms break both;
* the default tables keep every tile the JAX rules keep.
"""

import math

import pytest
import torch

from gallery_parity import one_thread  # noqa: F401 (an autouse fixture)
from geomloss_tpu_torch.models import multiscale as ms
from geomloss_tpu_torch.ops import block_sparse as bs
from test_torch_mid_keep_rule import _best_lengthened_scores, _cube, _dropped, _fiber_case, _fibers

TRUNCATE = 5


def _solve(tile, **kw):
    """The fibers' potentials ``(F, G)`` through the float64 twins."""
    X, Y, blur = _fibers()
    w = torch.full((X.shape[0],), 1.0 / X.shape[0], dtype=torch.float64)
    return ms.sinkhorn_multiscale(w, X, w, Y, p=2, blur=blur, scaling=0.8, diameter=2.0, debias=False,
                                  potentials=True, tile=tile, target_clusters=400, impl="blocked", **kw), blur**2


def _every_tile(monkeypatch, module, name, pos, calls):
    """``module.<name>`` builds its tables at a keep margin of 1e6 (its
    argument ``pos``), recording the margins it was called with."""
    build = getattr(module, name)

    def wide(*args, **kwargs):
        calls.append((name, args[pos]))
        return build(*args[:pos], 1e6, *args[pos + 1:], **kwargs)

    monkeypatch.setattr(module, name, wide)


def _gap(a, b):
    return max((u - v).abs().max().item() for u, v in zip(a, b))


@pytest.mark.parametrize("tile", [32, 64])
def test_classic_path_on_fiber_bundles_matches_the_every_tile_coarse_tables(monkeypatch, tile):
    (F, G), eps = _solve(tile, truncate=TRUNCATE)
    calls = []
    _every_tile(monkeypatch, ms, "masks_from_coarse", 8, calls)
    every, _ = _solve(tile, truncate=TRUNCATE)
    assert calls == [("masks_from_coarse", TRUNCATE)]  # one coarse table, on the classic path
    assert _gap((F, G), every) <= 1e-2 * eps


def test_mid_path_on_fiber_bundles_matches_the_every_tile_fine_and_extrapolation_tables(monkeypatch):
    monkeypatch.setattr(ms, "N_FINE_OK", 4096)
    monkeypatch.setattr(ms, "EXTRAP_BM", 32)
    (F, G), eps = _solve(32, truncate=TRUNCATE)
    calls = []
    _every_tile(monkeypatch, ms, "build_tile_masks", 6, calls)
    _every_tile(monkeypatch, bs, "extrap_cols", 4, calls)
    every, _ = _solve(32, truncate=TRUNCATE)
    # One fine table and the two truncated extrapolations onto the fine clouds:
    assert sorted(calls) == [("build_tile_masks", TRUNCATE)] + [("extrap_cols", TRUNCATE)] * 2
    assert _gap((F, G), every) <= 1e-2 * eps


def _coarse_case(case):
    """Sorted points, weights, block size and tile; the cluster blocks'
    centroids, weights and radii; smooth coarse potentials on the
    centroids; the temperatures of p = 1, 2."""
    x, y, f, g, w, tile, eps_of = _cube() if case == "cube" else _fiber_case()
    block = tile // 4
    wx = torch.ones(x.shape[0], dtype=x.dtype) if w is None else w
    wy = torch.ones(y.shape[0], dtype=y.dtype) if w is None else w

    def blocks(pts, wt):
        wb = wt.reshape(-1, block)
        cent = (pts.reshape(-1, block, pts.shape[1]) * wb[..., None]).sum(1) / wb.sum(1).clamp(min=1e-30)[:, None]
        return cent, wb.sum(1), ms.block_radii(wt, pts, cent, block)

    (cx, aw, rx), (cy, bw, ry) = blocks(x, wx), blocks(y, wy)
    f_c = 0.05 * torch.sin(3 * cx[:, 0]) * torch.cos(2 * cx[:, 1])
    g_c = 0.05 * torch.cos(2 * cy[:, 1]) + 0.02 * cy[:, 2]
    return x, y, w, tile, block, (cx, cy, f_c, g_c, aw, bw), (rx, ry), eps_of


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("case", ["cube", "fibers"])
def test_coarse_dropped_tile_pairs_obey_the_bound(case, p):
    """A coarse table built at ``eps`` serving down to ``eps_min = eps /
    4``: at both temperatures, every dropped tile pair's point pairs of
    positive weight have ``f_c[k] + g_c[l] - C(|x_i - y_j| + 2 s) <=
    -truncate * e``, ``s = keep_slack(eps_min)``, the coarse potentials
    read on the blocks' points."""
    x, y, w, tile, block, state, (rx, ry), eps_of = _coarse_case(case)
    eps = eps_of[p]
    eps_min = eps / 4
    s = bs.keep_slack(eps_min, p, TRUNCATE)
    mask = bs.masks_from_coarse(*state, eps, p, TRUNCATE, tile // block, r_x=rx, r_y=ry, eps_min=eps_min)
    f, g = state[2].repeat_interleave(block), state[3].repeat_interleave(block)
    best = _best_lengthened_scores(x, y, f, g, w, tile, p, s)
    n_dropped = 0
    for e in (eps, eps_min):
        dropped = _dropped(mask, TRUNCATE * (e - eps))
        n_dropped += int(dropped.sum())
        excess = (best + TRUNCATE * e)[dropped]
        assert excess.max().item() <= 1e-12, f"a dropped tile pair at eps {e} exceeds the bound by {excess.max()}"
    assert n_dropped > 0  # the tables prune
    old = bs.masks_from_coarse(*state, eps, p, TRUNCATE, tile // block)
    if case == "fibers":
        # The JAX rule (the centroids alone) drops tile pairs that break it:
        assert (best + TRUNCATE * eps)[_dropped(old, 0.0)].max().item() > 0.0
    # Every tile the JAX rule keeps, the port's keeps; at an infinite slack
    # the port's tables are the JAX rule's:
    assert not (_dropped(mask, 0.0) & ~_dropped(old, 0.0)).any()
    inf = bs.masks_from_coarse(*state, eps, p, TRUNCATE, tile // block, r_x=rx, r_y=ry, eps_min=math.inf)
    for name in ("cols", "counts", "colsT", "countsT", "vals"):
        assert torch.equal(getattr(inf, name), getattr(old, name)), name


def _extrap_case(case, p):
    """Rows and sources in sort order, a log-weight plus a smooth potential
    on the sources, the row and source tile sides, the temperature."""
    x, y, f, g, w, tile, eps_of = _cube() if case == "cube" else _fiber_case()
    eps = eps_of[p]
    h = -math.log(y.shape[0]) + g / eps
    if w is not None:
        h = torch.where(w > 0, h, -1e5)  # the solve's clamp of a zero log-weight
    return x, y, h, eps, tile, (128 if case == "cube" else 32)


def _worst_terms(x, y, h, eps, p, block_n, block_m, rows=1024):
    """Per row tile and source tile, ``max_{i, j} (h_j - C_ij / eps) -
    max_j' (h_j' - C_ij' / eps)`` over the row tile's points ``i`` and the
    source tile's ``j``."""
    out = []
    for i in range(0, x.shape[0], rows):
        d = torch.cdist(x[i:i + rows], y)
        S = h[None, :] - (d * d / 2 if p == 2 else d) / eps
        S = S - S.amax(dim=1, keepdim=True)
        out.append(S.reshape(S.shape[0] // block_n, block_n, -1, block_m).amax(dim=(1, 3)))
    return torch.cat(out)


def _dropped_tiles(cols, counts, n_src_tiles):
    kept = torch.zeros(cols.shape[0], n_src_tiles, dtype=torch.bool)
    for I in range(kept.shape[0]):
        kept[I, cols[I, :int(counts[I])].long()] = True
    return ~kept


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("case", ["cube", "fibers"])
def test_extrapolation_dropped_tiles_obey_the_bound(case, p):
    """Every source tile ``extrap_cols`` drops for a row tile holds only
    terms at least ``truncate`` nats below each row's largest; the JAX form
    (``radii=False``) keeps a subset and, on the fibers, breaks it."""
    x, y, h, eps, block_n, block_m = _extrap_case(case, p)
    worst = _worst_terms(x, y, h, eps, p, block_n, block_m)
    dropped = _dropped_tiles(*bs.extrap_cols(x, y, h, eps, TRUNCATE, block_n, block_m, p=p), worst.shape[1])
    assert dropped.any()  # the table prunes
    excess = worst[dropped] + TRUNCATE
    assert excess.max().item() <= 1e-12, f"a dropped source tile exceeds the bound by {excess.max()}"
    old = bs.extrap_cols(x, y, h, eps, TRUNCATE, block_n, block_m, p=p, radii=False)
    dropped_j = _dropped_tiles(*old, worst.shape[1])
    assert not (dropped & ~dropped_j).any()  # every tile the JAX form keeps
    if case == "fibers":
        assert (worst[dropped_j] + TRUNCATE).max().item() > 0.0
