"""Times bench.py's call through geomloss_tpu_torch on one GPU: the value and
gradient in x of ``SamplesLoss("sinkhorn", p=2, blur=0.05, diameter=2.0,
scaling=0.5)`` (``--blur`` sets another blur; ``backend="auto"``, or
``--backend``: ``online`` for the
streaming route of kernels 1-4) between two unit-sphere clouds (seeds 0
and 1), at each size given; with ``--loss gaussian``, the gaussian MMD's
truncated route instead (``SamplesLoss("gaussian", blur=0.1, truncate=3,
backend="multiscale")``, kernel 8).

    python3 time_paths.py --sizes 100000 2000000 [--reps 5] [--root DIR] [--loss gaussian]
                          [--backend online] [--blur 0.02] [--scratch-mib 1024]

``--root`` imports the package from another checkout (for example the
parent commit unpacked with ``git archive``), so that two versions can be
compared on one card in one session: run parent, change, change, parent.
Prints one JSON line per size: the host-clock time of each rep after a
warm-up (around ``torch.cuda.synchronize()``), the peak device memory of
one call, the loss, and the card's name and power limit (the program's
phases, kernel launches and kept tiles come from its own spans and
counters under ``torch.profiler``: ``geomloss_tpu_torch.utils.profiling``).
``--scratch-mib`` sets the scratch budget of kernels 5 and 6
(``TILES_SCRATCH_BYTES``): a table whose slots pass it reads its live
count on the host and launches in chunks. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def sphere_cloud(n, seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[100_000])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--loss", choices=("sinkhorn", "gaussian"), default="sinkhorn")
    ap.add_argument("--backend", default="auto", help="the Sinkhorn call's backend")
    ap.add_argument("--blur", type=float, default=0.05, help="the Sinkhorn call's blur")
    ap.add_argument("--scratch-mib", type=int, help="kernels 5 and 6's scratch budget (TILES_SCRATCH_BYTES) in MiB")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_paths.py needs a CUDA device")
    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.ops import cuda_block_sparse

    if args.scratch_mib is not None:
        cuda_block_sparse.TILES_SCRATCH_BYTES = args.scratch_mib << 20

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.loss == "sinkhorn":
        loss = SamplesLoss("sinkhorn", p=2, blur=args.blur, diameter=2.0, scaling=0.5, backend=args.backend)
    else:
        loss = SamplesLoss("gaussian", blur=0.1, truncate=3, backend="multiscale")
    dev = torch.device("cuda")

    for n in args.sizes:
        x0 = torch.from_numpy(sphere_cloud(n, 0)).to(dev)
        y0 = torch.from_numpy(sphere_cloud(n, 1)).to(dev)

        def call():
            x = x0.clone().requires_grad_(True)
            v = loss(x, y0)
            (g,) = torch.autograd.grad(v, x)
            return v.detach(), g

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        v, _ = call()  # warm-up
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        backend = args.backend if args.loss == "sinkhorn" else "multiscale"
        line = {"root": args.root, "loss_fn": args.loss, "backend": backend, "blur": args.blur, "n": n, "ms": ms,
                "peak_gb": peak / 1e9, "loss": v.item(), "scratch_bytes": cuda_block_sparse.TILES_SCRATCH_BYTES,
                "card": card}
        print(json.dumps(line), flush=True)
        del x0, y0
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
