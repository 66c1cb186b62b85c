"""The multiscale keep rules on data along curves, on the CPU.

The gallery's fiber bundles (``examples_torch/transfer_labels_tractograms``)
go through ``models/multiscale.py::sinkhorn_multiscale`` in float64 on the
plain twins, once with the default truncation (``truncate=5``) and once
with a margin that keeps every tile (``truncate=1e6``). The two differ only
in what the keep rules drop, since the default tables keep every tile that
their rules keep. Prints one JSON line per path and tile, the largest gaps
of the potentials in units of eps:

* ``"path": "mid"`` (``N_FINE_OK`` lowered to half the points, the
  truncated extrapolations' source tiles to 32 so that they run):
  ``gap_every_tile_kept``; ``gap_fine_tables_every_tile``, the same with
  only the fine tables' rule (``build_tile_masks``) at 1e6;
  ``gap_fine_and_extrap_every_tile``, with the fine tables' and the
  truncated extrapolations' rules (``extrap_cols``) at 1e6; the default
  solve against those two (``gap_default_to_fine_every_tile``: what the
  fine rule drops; ``gap_default_to_fine_and_extrap_every_tile``: what both
  drop); ``gap_jax_rule_to_fine_every_tile``, the JAX package's fine rule
  (``eps_min=inf``: no radius subtracted) against the fine every-tile
  solve; ``gap_jax_extrap_rule_to_fine_and_extrap_every_tile``, the JAX
  package's extrapolation rule (``radii=False``: its upper bound at the
  centroid distance) against the solve whose fine and extrapolation
  tables keep every tile; and the largest extent of a row tile of the
  sorted cloud (a tile that spans a jump of the sort order, whose
  centroid lies far from its points);
* ``"path": "classic"`` (``N_FINE_OK`` as it is: the coarse tables,
  ``masks_from_coarse``): ``gap_every_tile_kept``,
  ``gap_coarse_tables_every_tile``, the same with only
  ``masks_from_coarse`` at 1e6, and ``gap_jax_rule_to_coarse_every_tile``,
  the JAX package's coarse rule (``eps_min=inf``: the centroids alone)
  against that solve.

    python tools/mid_keep_rule_torch.py [--fibers 136] [--tiles 32 64]
"""

import argparse
import contextlib
import json
import math
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
    solve = lambda **kw: ms.sinkhorn_multiscale(w, X, w, Y, **kw)  # noqa: E731
    # The rules at a margin of 1e6 (every tile kept), and the JAX package's:
    fine_wide = dict(build_tile_masks=lambda *a, **k: bs.build_tile_masks(*a[:6], 1e6, *a[7:], **k))
    extrap_wide = lambda *a, **k: _extrap_cols(*a[:4], 1e6, *a[5:], **k)  # noqa: E731
    extrap_jax = lambda *a, **k: _extrap_cols(*a, **dict(k, radii=False))  # noqa: E731
    for tile in args.tiles:
        kw = dict(p=2, blur=mod.BLUR, scaling=0.8, diameter=2.0, debias=False, potentials=True, tile=tile,
                  target_clusters=400, impl="blocked")
        with patched(ms, N_FINE_OK=len(x) // 2, EXTRAP_BM=32):
            default, every = solve(truncate=5, **kw), solve(truncate=1e6, **kw)
            with patched(ms, **fine_wide):
                fine = solve(truncate=5, **kw)
                with patched(bs, extrap_cols=extrap_wide):
                    fine_extrap = solve(truncate=5, **kw)
            with patched(ms, build_tile_masks=lambda *a, **k: bs.build_tile_masks(*a, **dict(k, eps_min=math.inf))):
                jax_rule = solve(truncate=5, **kw)
            with patched(ms, **fine_wide), patched(bs, extrap_cols=extrap_jax):
                jax_extrap = solve(truncate=5, **kw)
            xs = bs.tile_stats(_sorted(X, w, tile), tile)[1]
        print(json.dumps(dict(
            path="mid", points=len(x), tile=tile, eps=eps,
            gap_every_tile_kept=_gap(default, every) / eps,
            gap_fine_tables_every_tile=_gap(fine, every) / eps,
            gap_fine_and_extrap_every_tile=_gap(fine_extrap, every) / eps,
            gap_default_to_fine_every_tile=_gap(default, fine) / eps,
            gap_default_to_fine_and_extrap_every_tile=_gap(default, fine_extrap) / eps,
            gap_jax_rule_to_fine_every_tile=_gap(jax_rule, fine) / eps,
            gap_jax_extrap_rule_to_fine_and_extrap_every_tile=_gap(jax_extrap, fine_extrap) / eps,
            largest_row_tile_extent=xs.max().item(),
        )), flush=True)
        default, every = solve(truncate=5, **kw), solve(truncate=1e6, **kw)
        with patched(ms, masks_from_coarse=lambda *a, **k: bs.masks_from_coarse(*a[:8], 1e6, *a[9:], **k)):
            coarse = solve(truncate=5, **kw)
        with patched(ms, masks_from_coarse=lambda *a, **k: bs.masks_from_coarse(*a, **dict(k, eps_min=math.inf))):
            jax_rule = solve(truncate=5, **kw)
        print(json.dumps(dict(
            path="classic", points=len(x), tile=tile, eps=eps,
            gap_every_tile_kept=_gap(default, every) / eps,
            gap_coarse_tables_every_tile=_gap(coarse, every) / eps,
            gap_jax_rule_to_coarse_every_tile=_gap(jax_rule, coarse) / eps,
        )), flush=True)


#: ``extrap_cols`` as the solve finds it (before any patch).
_extrap_cols = bs.extrap_cols


def _gap(a, b):
    """Largest gap of two ``(F, G)`` pairs."""
    return max((u - v).abs().max().item() for u, v in zip(a, b))


@contextlib.contextmanager
def patched(module, **values):
    saved = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def _sorted(X, w, tile):
    """The x cloud as the solve sorts and pads it."""
    pro = ms.multiscale_prologue(w, X, w, X, 2, 0.02, None, 2.0, 0.8, None, None, None, False, None, None,
                                 False, "blocked", "auto", None, 400, tile)
    return pro.x_s.detach()


if __name__ == "__main__":
    main()
