"""What the multiscale keep rules drop, on the card: the largest gap of a
solve's potentials to the same solve whose tables keep every tile (their
keep margin at 1e6), in units of the last eps, with both calls' seconds
and the default tables' kept tiles a row. One JSON line per case:

* ``spheres``: bench.py's call (``sinkhorn_multiscale``, p = 2, blur 0.05,
  scaling 0.5, debiased, ``potentials=True``) between two unit-sphere
  clouds of 2e6 points (seeds 0 and 1): the mid path, its fine tables
  (``build_tile_masks``) and its truncated extrapolations' tables
  (``extrap_cols``) keeping every tile; ``spheres_1e7``: the same at
  1e7 points and blur 0.02 (tile 2048; the every-tile solve takes
  minutes), with the loss of both calls (``<a, F> + <b, G>``);
  ``spheres_1e5``: the same at 1e5 points, bench.py's own size: the
  classic path, its coarse tables (``masks_from_coarse``) keeping every
  tile;
* ``fibers``: the gallery's label transfer
  (``examples_torch/transfer_labels_tractograms.py::transfer``) at
  2,100,000 points (35,000 fibers a bundle): the mid path, the same;
* ``classic``: the label transfer at 1,000,020 points (16,667 fibers a
  bundle): the classic path, its coarse tables (``masks_from_coarse``)
  keeping every tile.

    PYTHONPATH=. python3 tools/keep_rule_gaps_torch.py [--root DIR] [--cases spheres fibers classic spheres_1e7 spheres_1e5]

``--root`` imports the package and the gallery from another checkout (for
example the parent commit unpacked with ``git archive``), so that two
versions can be compared on one card in one run. Needs a CUDA device.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The sphere cases: points a cloud and blur.
SPHERES = {"spheres": (2_000_000, 0.05), "spheres_1e7": (10_000_000, 0.02), "spheres_1e5": (100_000, 0.05)}
#: The table functions and the position of their keep margin (``truncate``).
MARGIN_AT = {"build_tile_masks": 6, "masks_from_coarse": 8, "extrap_cols": 4}


@contextlib.contextmanager
def recorded_every_tile(targets, every_tile):
    """Records the tables that each ``module.<name>`` of ``targets`` (pairs
    ``(module, name)``) returns, as ``{name: [tables]}``; with
    ``every_tile``, builds them at a keep margin of 1e6 (every tile kept)."""
    saved = {name: getattr(module, name) for module, name in targets}
    tables = {name: [] for name in saved}

    def wide(name):
        build, pos = saved[name], MARGIN_AT[name]

        def call(*a, **k):
            if every_tile:
                a = (*a[:pos], 1e6, *a[pos + 1:])
            tables[name].append(build(*a, **k))
            return tables[name][-1]

        return call

    for module, name in targets:
        setattr(module, name, wide(name))
    try:
        yield tables
    finally:
        for module, name in targets:
            setattr(module, name, saved[name])


def every_tile_gap(solve, targets, eps):
    """The largest gap, in units of ``eps``, of the potentials ``solve()``
    returns (a tuple of tensors, on the card) to those of the same call
    whose tables of ``targets`` (pairs ``(module, name)``) keep every tile.
    Returns ``(gap, (default seconds, every-tile seconds), the default
    call's tables by name, whether every potential is finite)``."""
    import torch

    out, secs, tables = [], [], []
    for every_tile in (False, True):
        with recorded_every_tile(targets, every_tile) as built, torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append([t.double() for t in solve()])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        tables.append(built)
    gap = max((a - b).abs().max().item() for a, b in zip(*out)) / eps
    finite = all(bool(torch.isfinite(t).all()) for t in (*out[0], *out[1]))
    return gap, tuple(secs), tables[0], finite


def kept_tiles(table):
    """Kept tiles a row (mean, max) and width of a ``TileMask`` or an
    ``extrap_cols`` table ``(cols, counts)``."""
    cols, counts = (table.cols, table.counts) if hasattr(table, "counts") else table
    return dict(mean=counts.double().mean().item(), max=int(counts.max()), width=cols.shape[1])


def gap_line(case, n, eps, solve, targets, card, root, losses=None):
    gap, secs, tables, finite = every_tile_gap(solve, targets, eps)
    kept = {name: [kept_tiles(t) for t in built] for name, built in tables.items()}
    print(json.dumps(dict(case=case, n=n, eps=eps, table_fns=list(tables), gap_eps=gap, default_s=secs[0],
                          every_tile_s=secs[1], finite=finite, tables=kept, losses=losses, root=root, card=card)),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--cases", nargs="+", default=["spheres", "fibers", "classic"])
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "examples_torch")]

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("keep_rule_gaps_torch.py needs a CUDA device")
    import transfer_labels_tractograms as tlt
    from geomloss_tpu_torch.models import multiscale as ms
    from geomloss_tpu_torch.ops import block_sparse as bs

    mid_tables = [(ms, "build_tile_masks"), (bs, "extrap_cols")]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    for case in args.cases:
        if case.startswith("spheres"):
            n, blur = SPHERES[case]
            x, y = (torch.from_numpy(_sphere(n, seed)).to(dev) for seed in (0, 1))
            w = torch.full((n,), 1.0 / n, device=dev)
            kw = dict(p=2, blur=blur, diameter=2.0, scaling=0.5)
            losses = []

            def solve():
                F, G = ms.sinkhorn_multiscale(w, x, w, y, potentials=True, **kw)
                losses.append(((w * F).sum() + (w * G).sum()).item())  # the debiased loss, <a, F> + <b, G>
                return F, G

            gap_line(case, n, blur**2, solve, mid_tables if n > ms.N_FINE_OK else [(ms, "masks_from_coarse")],
                     card, root, losses=losses)
        else:
            n_fibers = 35_000 if case == "fibers" else 16_667
            yv, _, lab = tlt.tractogram(0, n_fibers)
            xv, _, _ = tlt.tractogram(1, n_fibers)
            x, y = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (xv, yv))
            lab = torch.as_tensor(lab, device=dev)
            gap_line(case, len(xv), tlt.BLUR**2, lambda: tlt.transfer(x, y, lab)[:2],
                     mid_tables if case == "fibers" else [(ms, "masks_from_coarse")], card, root)
        del x, y
        torch.cuda.empty_cache()


def _sphere(n, seed):
    v = np.random.RandomState(seed).randn(n, 3)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


if __name__ == "__main__":
    main()
