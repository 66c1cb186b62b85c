"""The widths of the multiscale backend's truncation tables.

The classic path builds its tables at the jump temperature and slices
them for each fine temperature. Two widths bounded the kept column tiles
of a row: the build cap (an eighth of the column tiles, 32 to 128) and
the per-temperature slice (``fine_cap_schedule``: the width times
``eps / eps_jump``, at least 24). Both assume that the kept tiles shrink
with the temperature as on surfaces; on data along curves (the gallery's
fiber bundles) rows keep many more, and both clipped real mass: at 1e6
fiber points the label transfer's votes came out NaN on the card. The
default widths now grow to the largest count a row keeps; a row that
fits is sliced as before.
"""

import numpy as np
import torch

from gallery_parity import gallery, one_thread  # noqa: F401 (one_thread: an autouse fixture)
from geomloss_tpu_torch.models import multiscale as ms
from geomloss_tpu_torch.ops.block_sparse import TileMask, masks_from_coarse


def _mask(vals):
    nI, width = vals.shape
    cols = torch.arange(width, dtype=torch.int32).repeat(nI, 1)
    counts = (vals > 0).sum(1).to(torch.int32)
    return TileMask(cols=cols, counts=counts, colsT=cols, countsT=counts, vals=vals, valsT=vals)


def test_fine_table_slices_keep_every_row():
    """A row that keeps 61 of 64 tiles at the fine temperature gets all 61
    (the schedule alone gave 24); rows within the schedule are sliced to
    its width as before."""
    width, eps_m, e, truncate = 64, 1.0, 0.1, 5.0
    vals = torch.full((3, width), -1.0, dtype=torch.float64)
    vals[0, :61] = 10.0 - 0.01 * torch.arange(61)  # 61 kept after the shift of -4.5
    vals[1, :5] = 10.0
    vals[2, :1] = 10.0
    mask = _mask(vals)
    (ck_sched, _), = ms.fine_cap_schedule([e], eps_m, width)
    assert ck_sched == 24
    cols, cnt = ms.fine_tables(mask, eps_m, [e], truncate)(mask, e)
    assert cnt.tolist() == [61, 5, 1]
    assert cols.shape == (3, 64)
    narrow = _mask(vals[1:])
    cols, cnt = ms.fine_tables(narrow, eps_m, [e], truncate)(narrow, e)
    assert cnt.tolist() == [5, 1] and cols.shape == (2, ck_sched)


def test_masks_from_coarse_default_cap_keeps_every_row():
    """40 blocks on a line, every pair kept: the default cap grows from 32
    to 40 column tiles, where the old default kept the best 32."""
    n = 40
    c = torch.linspace(0, 0.1, n, dtype=torch.float64)[:, None]
    w = torch.full((n,), 1.0 / n, dtype=torch.float64)
    f = torch.zeros(n, dtype=torch.float64)
    mask = masks_from_coarse(c, c, f, f, w, w, 1.0, 2, 5.0, 1)
    assert mask.counts.tolist() == [n] * n and mask.cols.shape == (n, n)
    assert mask.countsT.tolist() == [n] * n
    assert masks_from_coarse(c, c, f, f, w, w, 1.0, 2, 5.0, 1, cap=32).counts.tolist() == [32] * n


def test_truncated_potentials_on_fiber_bundles_match_the_exact_fine_phase():
    """The gallery's tractograms (60 fibers a bundle, 3,600 points, tile
    64, 400 target clusters: 49 of 64 row tiles filled the old build cap
    of 32, and 26-51 kept more than the 24 the schedule allowed at each
    fine temperature): the label transfer's potentials, truncated, within
    1e-2 eps of the exact fine phase's (``truncate=None``). The clipped
    tables missed by 6.1e-4 = 1.5 eps, 14 % of the potentials' scale."""
    mod = gallery.load("transfer_labels_tractograms")
    y, _, _ = mod.tractogram(0, 60)
    x, _, _ = mod.tractogram(1, 60)
    X, Y = torch.tensor(x, dtype=torch.float64), torch.tensor(y, dtype=torch.float64)
    w = torch.full((len(x),), 1.0 / len(x), dtype=torch.float64)
    kw = dict(p=2, blur=mod.BLUR, scaling=0.8, diameter=2.0, debias=False, potentials=True, tile=64,
              target_clusters=400)
    F, G = ms.sinkhorn_multiscale(w, X, w, Y, **kw)
    F_ex, G_ex = ms.sinkhorn_multiscale(w, X, w, Y, truncate=None, **kw)
    eps = mod.BLUR**2
    np.testing.assert_allclose(F.numpy(), F_ex.numpy(), rtol=0, atol=1e-2 * eps)
    np.testing.assert_allclose(G.numpy(), G_ex.numpy(), rtol=0, atol=1e-2 * eps)
