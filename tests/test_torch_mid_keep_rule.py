"""The mid path's fine keep rule (``build_tile_masks``) on data along curves.

The JAX package's rule scores a pair of sub-blocks by ``max f + max g -
C(centroids) + truncate * eps``. A sub-block that straddles a jump of the
sort order has its centroid far from all its points, so its nearest tiles
scored below zero and were dropped at any table width. The port's rule
subtracts each sub-block's radius beyond a slack of half the keep radius
(``block_sparse.keep_slack``):

* the mid path on the gallery's fiber bundles (8,160 points, tile 32,
  ``N_FINE_OK`` and ``EXTRAP_BM`` lowered as in
  ``tests/test_torch_table_widths.py``), float64, plain twins: its
  potentials within 1e-2 eps of the same solve whose fine tables keep every
  tile (the JAX rule missed it by 445.6 eps);
* on a Hilbert-sorted cube and on the fibers, p in {1, 2}: every tile pair
  the rule drops obeys the docstring's bound, ``f_i + g_j - C(|x_i - y_j| +
  2 s) <= -truncate * eps`` for each of its point pairs, at the build
  temperature and at the finest one the table serves; on the fibers the
  JAX rule breaks it.
"""

import math

import numpy as np
import pytest
import torch

from gallery_parity import gallery, one_thread  # noqa: F401 (one_thread: an autouse fixture)
from geomloss_tpu_torch.models import multiscale as ms
from geomloss_tpu_torch.ops import block_sparse as bs
from geomloss_tpu_torch.ops.spatial import hilbert_key

TRUNCATE = 5


def _fibers():
    mod = gallery.load("transfer_labels_tractograms")
    y, _, _ = mod.tractogram(0, 136)
    x, _, _ = mod.tractogram(1, 136)
    return torch.tensor(x, dtype=torch.float64), torch.tensor(y, dtype=torch.float64), mod.BLUR


def test_mid_path_on_fiber_bundles_matches_the_every_tile_fine_tables(monkeypatch):
    """The default solve against the same solve in which only the fine
    tables keep every tile (``build_tile_masks`` at ``truncate`` 1e6; the
    truncated extrapolations at their default margin): within 1e-2 eps."""
    monkeypatch.setattr(ms, "N_FINE_OK", 4096)
    monkeypatch.setattr(ms, "EXTRAP_BM", 32)
    X, Y, blur = _fibers()
    w = torch.full((X.shape[0],), 1.0 / X.shape[0], dtype=torch.float64)
    kw = dict(p=2, blur=blur, scaling=0.8, diameter=2.0, debias=False, potentials=True, tile=32,
              target_clusters=400, impl="blocked")
    calls = []
    build = ms.build_tile_masks

    def every_tile(*args, **kwargs):
        calls.append(args[6])
        return build(*args[:6], 1e6, *args[7:], **kwargs)

    F, G = ms.sinkhorn_multiscale(w, X, w, Y, **kw)
    monkeypatch.setattr(ms, "build_tile_masks", every_tile)
    F_all, G_all = ms.sinkhorn_multiscale(w, X, w, Y, **kw)
    assert calls == [TRUNCATE]  # one fine table, on the mid path
    eps = blur**2
    np.testing.assert_allclose(F.numpy(), F_all.numpy(), rtol=0, atol=1e-2 * eps)
    np.testing.assert_allclose(G.numpy(), G_all.numpy(), rtol=0, atol=1e-2 * eps)


def _hilbert(pts):
    return pts[torch.argsort(hilbert_key(pts, bits=6), stable=True)]


def _cube():
    """4,096 points of a unit cube against 4,096 shifted by 0.1, in Hilbert
    order, the last 300 of each of zero mass; tiles of 256 (sub-blocks of
    64)."""
    rng = np.random.RandomState(0)
    x = _hilbert(torch.tensor(rng.rand(4096, 3)))
    y = _hilbert(torch.tensor(rng.rand(4096, 3) + 0.1))
    w = torch.tensor(rng.rand(4096) + 0.1)
    w[-300:] = 0.0
    f = 0.05 * torch.sin(3 * x[:, 0]) + 0.01 * torch.tensor(rng.randn(4096))
    g = 0.05 * torch.cos(2 * y[:, 1]) + 0.01 * torch.tensor(rng.randn(4096))
    return x, y, f, g, w, 256, {1: 0.05, 2: 0.01}


def _fiber_case():
    """The fiber bundles (8,160 points a side) in Hilbert order, tiles of
    32 (sub-blocks of 32), smooth potentials, at the gallery's blur."""
    x, y, blur = _fibers()
    x, y = _hilbert(x), _hilbert(y)
    f = 0.02 * torch.sin(4 * x[:, 0]) * torch.cos(3 * x[:, 1])
    g = 0.02 * torch.cos(5 * y[:, 2])
    return x, y, f, g, None, 32, {1: blur, 2: blur**2}


def _best_lengthened_scores(x, y, f, g, w, tile, p, s, rows=1024):
    """``max_{i in I, j in J} f_i + g_j - C(|x_i - y_j| + 2 s)`` over the
    mass points of each tile pair ``(I, J)``, -inf where a tile has none."""
    mass_x = torch.ones(x.shape[0], dtype=torch.bool) if w is None else w > 0
    mass_y = torch.ones(y.shape[0], dtype=torch.bool) if w is None else w > 0
    out = []
    for i in range(0, x.shape[0], rows):
        d = torch.cdist(x[i : i + rows], y) + 2 * s
        q = f[i : i + rows, None] + g[None, :] - (d * d / 2 if p == 2 else d)
        q = q.masked_fill(~(mass_x[i : i + rows, None] & mass_y[None, :]), -math.inf)
        out.append(q.reshape(q.shape[0] // tile, tile, -1, tile).amax(dim=(1, 3)))
    return torch.cat(out)


def _dropped(mask, delta):
    """The tile pairs a table drops when its scores shift by ``delta``."""
    cnt = bs.retighten_counts(mask.vals, delta)
    kept = torch.zeros(mask.cols.shape[0], mask.colsT.shape[0], dtype=torch.bool)
    for I in range(kept.shape[0]):
        kept[I, mask.cols[I, : int(cnt[I])].long()] = True
    return ~kept


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("case", ["cube", "fibers"])
def test_dropped_tile_pairs_obey_the_bound(case, p):
    """A table built at ``eps`` serving down to ``eps_min = eps / 4``: at
    both temperatures, every dropped tile pair's points have ``f_i + g_j -
    C(|x_i - y_j| + 2 s) <= -truncate * e``, ``s = keep_slack(eps_min)``."""
    x, y, f, g, w, tile, eps_of = _cube() if case == "cube" else _fiber_case()
    eps = eps_of[p]
    eps_min = eps / 4
    s = bs.keep_slack(eps_min, p, TRUNCATE)
    mask = bs.build_tile_masks(x, y, f, g, eps, p, TRUNCATE, tile, w_x=w, w_y=w, eps_min=eps_min)
    best = _best_lengthened_scores(x, y, f, g, w, tile, p, s)
    n_dropped = 0
    for e in (eps, eps_min):
        dropped = _dropped(mask, TRUNCATE * (e - eps))
        n_dropped += int(dropped.sum())
        excess = (best + TRUNCATE * e)[dropped]
        assert excess.max().item() <= 1e-12, f"a dropped tile pair at eps {e} exceeds the bound by {excess.max()}"
    assert n_dropped > 0  # the tables prune
    if case == "fibers":
        # The JAX rule (an infinite slack) drops tile pairs that break it:
        old = bs.build_tile_masks(x, y, f, g, eps, p, TRUNCATE, tile, eps_min=math.inf)
        assert (best + TRUNCATE * eps)[_dropped(old, 0.0)].max().item() > 0.0
