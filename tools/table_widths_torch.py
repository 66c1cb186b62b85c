"""The multiscale backend's truncation tables on bench.py's clouds, on an
NVIDIA GPU: what their widths keep and what the kept tiles cost.

For each size, ``SamplesLoss("sinkhorn", p=2, blur=0.05, diameter=2.0,
scaling=0.5)``'s multiscale solve between two unit-sphere clouds (seeds 0
and 1) is run through ``models/multiscale.py::sinkhorn_multiscale``:
its loss, the loss of the same solve with the exact fine phase
(``truncate=None``) and their relative gap (the truncation's error), the
median CUDA-event time of loss + gradient (3 reps after a warm-up), the xy
table's width and largest kept count at its build, and the kept tiles
summed over its rows at each fine temperature.

    python3 tools/table_widths_torch.py --sizes 100000 1000000 2000000 [--root DIR]

``--root`` imports the package from another checkout (the parent commit
unpacked with ``git archive``), so that two versions of the tables can be
compared on one card in one session: run parent, change, change, parent.
Prints one JSON line per size with the card's name and power limit. Needs
a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def sphere_cloud(n, seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[100_000])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("table_widths_torch.py needs a CUDA device")
    from geomloss_tpu_torch.models import multiscale as ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kw = dict(p=2, blur=0.05, diameter=2.0, scaling=0.5)

    for n in args.sizes:
        x = torch.from_numpy(sphere_cloud(n, 0)).to(dev)
        y = torch.from_numpy(sphere_cloud(n, 1)).to(dev)
        w = torch.full((n,), 1.0 / n, device=dev)
        calls = []
        fine_phase = ms._truncated_fine_phase

        def recorded(masks, eps_m, *rest):
            calls.append((masks[0], eps_m, rest[4], rest[6]))
            return fine_phase(masks, eps_m, *rest)

        def loss_grad():
            xg = x.clone().requires_grad_(True)
            v = ms.sinkhorn_multiscale(w, xg, w, y, **kw)
            torch.autograd.grad(v, xg)
            return v.detach()

        ms._truncated_fine_phase = recorded
        try:
            loss = loss_grad().item()
        finally:
            ms._truncated_fine_phase = fine_phase
        times = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss_grad()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        exact = ms.sinkhorn_multiscale(w, x, w, y, truncate=None, **kw).item()
        mask, eps_m, eps_fine, truncate = calls[0]
        table = ms.fine_tables(mask, eps_m, eps_fine, truncate)
        print(json.dumps(dict(
            n=n, root=os.path.abspath(args.root), loss=loss, loss_exact_fine=exact,
            rel_gap=abs(loss - exact) / abs(exact), events_ms=float(np.median(times)),
            width=mask.cols.shape[1], build_max=int(mask.counts.max()),
            kept_tiles=[int(table(mask, e)[1].sum()) for e in eps_fine], device=card,
        )), flush=True)


if __name__ == "__main__":
    main()
