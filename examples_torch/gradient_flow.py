"""Gradient flow demo: move a source point cloud onto a target by
following the Wasserstein gradient of the debiased Sinkhorn divergence.

PyTorch counterpart of ``examples/gradient_flow.py`` (the reference's
``examples/optimal_transport/plot_optimal_transport_2D.py`` gradient-flow
tutorial). Run:

    python examples_torch/gradient_flow.py [N]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from geomloss_tpu_torch import SamplesLoss
from _example_utils_torch import device_of, flow_step, tensor


def make_clouds(n, dev, seed=0):
    rng = np.random.RandomState(seed)
    # Source: a ring; target: two blobs.
    t = rng.rand(n) * 2 * np.pi
    x = 0.5 + 0.2 * np.stack([np.cos(t), np.sin(t)], -1) + 0.01 * rng.randn(n, 2)
    y = np.concatenate(
        [
            0.25 + 0.08 * rng.randn(n // 2, 2),
            0.75 + 0.08 * rng.randn(n - n // 2, 2),
        ]
    )
    return tensor(x, dev), tensor(y, dev)


def main(n=5000, steps=50, lr=1.0, device="cuda"):
    dev = device_of(device)
    x, y = make_clouds(n, dev)
    loss = SamplesLoss("sinkhorn", p=2, blur=0.05, diameter=2.0, scaling=0.9)

    t0 = time.perf_counter()
    for i in range(steps):
        # Wasserstein-2 gradient flow: dx/dt = -N * grad (a_i = 1/N):
        val, x = flow_step(lambda x: loss(x, y), x, lr * n)
        if i % 10 == 0:
            print(f"step {i:3d}: S_eps = {val.item():.6f}")
    print(f"final: S_eps = {val.item():.6f}  ({time.perf_counter() - t0:.1f}s)")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5000)
