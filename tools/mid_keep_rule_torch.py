"""The mid path's fine keep rule on data along curves, on the CPU.

The gallery's fiber bundles (``examples_torch/transfer_labels_tractograms``)
go through ``models/multiscale.py::sinkhorn_multiscale`` in float64 on the
plain twins, on the mid path (``N_FINE_OK`` lowered to half the points,
the truncated extrapolations' source tiles to 32 so that they run):
once with the default truncation (``truncate=5``) and once with a margin
that keeps every tile (``truncate=1e6``). The two differ only in what the
keep rules drop, since the default tables keep every tile that their
rules keep. Prints one JSON line per tile: the largest gap of the
potentials in units of eps, the same with only the fine tables' rule
at 1e6 (the truncated extrapolations at the default margin), and the
largest extent of a row tile of the sorted cloud (a tile that spans a
jump of the sort order, whose centroid lies far from its points).

    python tools/mid_keep_rule_torch.py [--fibers 136] [--tiles 32 64]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples_torch"))

import torch  # noqa: E402

from geomloss_tpu_torch.models import multiscale as ms  # noqa: E402
from geomloss_tpu_torch.ops import block_sparse as bs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fibers", type=int, default=136, help="fibers a bundle (60 points each over 3 bundles)")
    ap.add_argument("--tiles", type=int, nargs="+", default=[32, 64])
    args = ap.parse_args()
    torch.set_num_threads(1)
    import transfer_labels_tractograms as mod

    y, _, _ = mod.tractogram(0, args.fibers)
    x, _, _ = mod.tractogram(1, args.fibers)
    X, Y = torch.tensor(x, dtype=torch.float64), torch.tensor(y, dtype=torch.float64)
    w = torch.full((len(x),), 1.0 / len(x), dtype=torch.float64)
    eps = mod.BLUR**2
    ms.N_FINE_OK = len(x) // 2
    ms.EXTRAP_BM = 32
    build = ms.build_tile_masks
    for tile in args.tiles:
        kw = dict(p=2, blur=mod.BLUR, scaling=0.8, diameter=2.0, debias=False, potentials=True, tile=tile,
                  target_clusters=400, impl="blocked")
        F, G = ms.sinkhorn_multiscale(w, X, w, Y, truncate=5, **kw)
        F_all, G_all = ms.sinkhorn_multiscale(w, X, w, Y, truncate=1e6, **kw)
        # Only the fine tables' rule at the wide margin:
        ms.build_tile_masks = lambda *a, **k: build(*a[:6], 1e6, *a[7:], **k)
        try:
            F_fine, G_fine = ms.sinkhorn_multiscale(w, X, w, Y, truncate=5, **kw)
        finally:
            ms.build_tile_masks = build
        xs = bs.tile_stats(_sorted(X, w, tile), tile)[1]
        print(json.dumps(dict(
            points=len(x), tile=tile, eps=eps,
            gap_every_tile_kept=max((F - F_all).abs().max().item(), (G - G_all).abs().max().item()) / eps,
            gap_fine_tables_every_tile=max((F_fine - F_all).abs().max().item(),
                                           (G_fine - G_all).abs().max().item()) / eps,
            largest_row_tile_extent=xs.max().item(),
        )), flush=True)


def _sorted(X, w, tile):
    """The x cloud as the solve sorts and pads it."""
    pro = ms.multiscale_prologue(w, X, w, X, 2, 0.02, None, 2.0, 0.8, None, None, None, False, None, None,
                                 False, "blocked", "auto", None, 400, tile)
    return pro.x_s.detach()


if __name__ == "__main__":
    main()
