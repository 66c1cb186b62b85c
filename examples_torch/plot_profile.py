"""Profile the geomloss_tpu_torch routines
=========================================

How to **profile** the geometric losses to pick the backend and
scaling/truncation values best suited to your data: wrap the calls in a
``torch.profiler`` trace and open the result in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.

PyTorch counterpart of ``examples/plot_profile.py`` (the reference's
``examples/performances/plot_profile.py``). Run:

    python examples_torch/plot_profile.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.utils.profiling import Timer, trace
from _example_utils_torch import OUT, device_of, tensor


def sphere(n, seed, dev):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3).astype(np.float32)
    v /= 2 * np.linalg.norm(v, axis=1, keepdims=True)
    return tensor(v, dev)


def main(N=20_000, device="cuda"):
    # On the card, bump this to 100_000 like the reference:
    dev = device_of(device)
    x, y = sphere(N, 0, dev), sphere(N, 1, dev)

    timings = {}
    for loss_name in ["gaussian", "sinkhorn"]:
        for backend in ["online", "multiscale"]:
            loss = SamplesLoss(
                loss_name, blur=0.05, backend=backend, truncate=3,
                diameter=1.0, scaling=0.5,
            )

            def step():
                xg = x.detach().requires_grad_(True)
                v = loss(xg, y)
                (g,) = torch.autograd.grad(v, xg)
                return v.detach(), g

            # Warm-up outside the trace (the kernels' build and first
            # launches would dwarf the timeline otherwise):
            Timer().start().stop(step())

            trace_dir = os.path.join(OUT, f"profile_{loss_name}_{backend}")
            t = Timer().start()
            with trace(trace_dir):
                v, g = step()
                t.stop((v, g))  # torch.cuda.synchronize() before the clock
            timings[f"{loss_name}_{backend}"] = t.elapsed
            print(
                f"{loss_name:>9s} / {backend:<10s}: {t.elapsed * 1e3:8.2f} ms, "
                f"cost = {v.item():.6f}"
            )

    print(
        f"\nTraces written under {OUT}/profile_*/: load each trace.json "
        "at https://ui.perfetto.dev (or chrome://tracing)."
    )
    return timings


if __name__ == "__main__":
    main()
