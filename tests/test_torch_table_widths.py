"""Default truncation tables keep every kept tile: the MMD multiscale
route and the mid path.

The JAX package's default table widths bound the kept tiles of a row
(``masks_from_geometry``: an eighth of the column tiles, between 8 and
128; the mid path's fine tables: ``mid_cap``; its truncated
extrapolations: a quarter of the source tiles, between 8 and 64), and a
row that keeps more keeps its best-scored tiles. The port's default widths
grow to the largest kept count instead (``block_sparse.kept_width``);
an explicit ``cap`` stays a hard bound. On the cases below the old widths
clip:

* the gaussian MMD's multiscale route (blur 0.1, truncate 3) on two unit
  spheres of 8,192 points, float64: 16 column tiles of 512, a width of
  8, rows that keep up to 16. The clipped tables put the loss 148 % off
  the exact value;
* the mid path on the gallery's fiber bundles (8,160 points, tile 32,
  ``N_FINE_OK`` lowered to 4,096 and the extrapolations' source tiles to
  32, so that a mid cloud of 2,048 points takes the truncated
  extrapolations): ``mid_cap`` 96 of 256 column tiles, where 64 row tiles
  keep up to 140, and 16 of 64 source tiles, where most row tiles keep
  all 64.

Each table is held against the same table rebuilt with every column tile
allowed (an explicit ``cap`` of all of them), and each result against the
same computation on such tables.
"""

import numpy as np
import torch

from gallery_parity import gallery, one_thread  # noqa: F401 (one_thread: an autouse fixture)
from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.models import kernel_samples as ks
from geomloss_tpu_torch.models import multiscale as ms
from geomloss_tpu_torch.ops import block_sparse as bs


def _sphere(n, seed):
    v = np.random.RandomState(seed).randn(n, 3)
    return torch.tensor(v / np.linalg.norm(v, axis=1, keepdims=True))


def _gaussian_mmd(x, y, blur, rows=2048):
    """The exact gaussian MMD of two uniform clouds, in row chunks:
    ``1/2 <a, Kxx a> + 1/2 <b, Kyy b> - <a, Kxy b>``."""

    def mean_k(u, v):
        total = 0.0
        for i in range(0, u.shape[0], rows):
            ui = u[i : i + rows]
            sq = (ui**2).sum(1)[:, None] + (v**2).sum(1)[None, :] - 2 * ui @ v.T
            total = total + torch.exp(sq * (-0.5 / blur**2)).sum()
        return total / (u.shape[0] * v.shape[0])

    return 0.5 * mean_k(x, x) + 0.5 * mean_k(y, y) - mean_k(x, y)


def _recording(monkeypatch, module, name):
    """Records ``module.name``'s calls as ``(args, kwargs, result)``."""
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs, fn(*args, **kwargs)))
        return calls[-1][2]

    monkeypatch.setattr(module, name, spy)
    return calls, fn


def test_mmd_multiscale_default_tables_keep_every_tile(monkeypatch):
    """Each of the route's three tables keeps, both ways, the counts of a
    table of every column tile, and some row keeps more than the old width
    of 8."""
    calls, build = _recording(monkeypatch, ks, "masks_from_geometry")
    with torch.no_grad():
        SamplesLoss("gaussian", blur=0.1, truncate=3, backend="multiscale")(_sphere(8192, 0), _sphere(8192, 1))
    assert len(calls) == 3
    for args, kwargs, mask in calls:
        xs, ys, radius, tile = args
        full = build(xs, ys, radius, tile, **dict(kwargs, cap=ys.shape[0] // tile))
        for name in ("counts", "countsT"):
            np.testing.assert_array_equal(getattr(mask, name).numpy(), getattr(full, name).numpy(), err_msg=name)
    assert max(int(mask.counts.max()) for _, _, mask in calls) > 8


def test_mmd_multiscale_value_matches_the_exact_one():
    """The loss within 1e-6 relative of the exact MMD (148 % off with the
    old width) and its gradient within 1e-5 relative L2."""
    x, y = _sphere(8192, 0).requires_grad_(True), _sphere(8192, 1)
    loss = SamplesLoss("gaussian", blur=0.1, truncate=3, backend="multiscale")(x, y)
    (grad,) = torch.autograd.grad(loss, x)
    xr = x.detach().clone().requires_grad_(True)
    ref = _gaussian_mmd(xr, y, 0.1)
    (grad_ref,) = torch.autograd.grad(ref, xr)
    assert abs(loss.item() - ref.item()) <= 1e-6 * abs(ref.item())
    assert ((grad - grad_ref).norm() / grad_ref.norm()).item() <= 1e-5


def test_mid_path_default_tables_on_fiber_bundles_keep_every_tile(monkeypatch):
    """The label transfer's potentials on the mid path: its fine tables
    and its two truncated extrapolations keep the counts of tables of
    every column tile (the old widths, 96 and 16, clip rows that keep up to
    140 and 64), and the potentials lie within 1e-2 eps of the same solve
    on such tables."""
    monkeypatch.setattr(ms, "N_FINE_OK", 4096)
    monkeypatch.setattr(ms, "EXTRAP_BM", 32)
    mod = gallery.load("transfer_labels_tractograms")
    y, _, _ = mod.tractogram(0, 136)
    x, _, _ = mod.tractogram(1, 136)
    X, Y = torch.tensor(x, dtype=torch.float64), torch.tensor(y, dtype=torch.float64)
    w = torch.full((len(x),), 1.0 / len(x), dtype=torch.float64)
    kw = dict(p=2, blur=mod.BLUR, scaling=0.8, diameter=2.0, debias=False, potentials=True, tile=32,
              target_clusters=400, impl="blocked")

    tables, build = _recording(monkeypatch, ms, "build_tile_masks")
    extraps, extrap_cols = _recording(monkeypatch, bs, "extrap_cols")
    F, G = ms.sinkhorn_multiscale(w, X, w, Y, **kw)
    (args, kwargs, mask), = tables
    nJ = args[1].shape[0] // args[7]
    full = build(*args, **dict(kwargs, cap=nJ))
    for name in ("counts", "countsT"):
        np.testing.assert_array_equal(getattr(mask, name).numpy(), getattr(full, name).numpy(), err_msg=name)
    assert int(mask.counts.max()) > ms.mid_cap(args[0].shape[0], args[7])
    assert len(extraps) == 2
    for (x_rows, y_src, h, eps, truncate, bn, bm, *_), kwargs, (cols, counts) in extraps:
        everything = extrap_cols(x_rows, y_src, h, eps, truncate, bn, bm, y_src.shape[0] // bm, **kwargs)
        np.testing.assert_array_equal(counts.numpy(), everything[1].numpy())
        assert int(counts.max()) > max(8, min(64, -(-(y_src.shape[0] // bm // 4) // 8) * 8))

    # The same solve with every table as wide as its column tiles:
    def wide_tables(*a, **k):
        return build(*a, **dict(k, cap=a[1].shape[0] // a[7]))

    def wide_extrap(x_rows, y_src, h, eps, truncate, bn, bm, cap=None, **k):
        return extrap_cols(x_rows, y_src, h, eps, truncate, bn, bm, y_src.shape[0] // bm, **k)

    monkeypatch.setattr(ms, "build_tile_masks", wide_tables)
    monkeypatch.setattr(bs, "extrap_cols", wide_extrap)
    F_w, G_w = ms.sinkhorn_multiscale(w, X, w, Y, **kw)
    eps = mod.BLUR**2
    np.testing.assert_allclose(F.numpy(), F_w.numpy(), rtol=0, atol=1e-2 * eps)
    np.testing.assert_allclose(G.numpy(), G_w.numpy(), rtol=0, atol=1e-2 * eps)
