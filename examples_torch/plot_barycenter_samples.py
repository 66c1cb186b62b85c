"""Free-support Wasserstein barycenters of point clouds
=====================================================

Interpolate between 2D shapes with ``ot.barycenter_sample``: the
barycenter's *support points* are optimized directly via the debiased
barycentric fixed point, so the result is a crisp point cloud rather
than a blurred density.

This solver is a working implementation of an API the reference only
documents as a stub (``ot/_implementations/sample.py:644-652``); the
reference's gallery reaches the same goal by hand-written gradient
descent in ``examples/brain_tractograms/track_barycenter.py``.

PyTorch counterpart of ``examples/plot_barycenter_samples.py``. Run:

    python examples_torch/plot_barycenter_samples.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from geomloss_tpu_torch import ot
from _example_utils_torch import device_of, get_pyplot, savefig, tensor


def ring(n, r=1.0, center=(0.0, 0.0), seed=0):
    rng = np.random.RandomState(seed)
    t = 2 * np.pi * rng.rand(n)
    rad = r * (1 + 0.05 * rng.randn(n))
    pts = np.stack([rad * np.cos(t), rad * np.sin(t)], axis=1)
    return (pts + np.asarray(center)).astype(np.float32)


def square(n, side=2.0, center=(0.0, 0.0), seed=1):
    rng = np.random.RandomState(seed)
    t = rng.rand(n)
    edge = rng.randint(0, 4, n)
    u = side * (t - 0.5)
    h = side / 2
    pts = np.stack(
        [
            np.where(edge < 2, u, np.where(edge == 2, -h, h)),
            np.where(edge >= 2, u, np.where(edge == 0, -h, h)),
        ],
        axis=1,
    )
    return (pts + np.asarray(center)).astype(np.float32)


def main(n=2000, n_iter=6, device="cuda", plot=True):
    dev = device_of(device)
    x_ring = tensor(ring(n, r=1.0, center=(-1.5, 0.0)), dev)
    x_square = tensor(square(n, side=2.0, center=(1.5, 0.0)), dev)
    clouds = torch.stack([x_ring, x_square])

    # A family of interpolating barycenters, from the ring to the square:
    ts = [0.0, 0.25, 0.5, 0.75, 1.0]
    bars = []
    for t in ts:
        res = ot.barycenter_sample(
            clouds,
            weights=tensor([1.0 - t, t], dev),
            blur=0.05,
            n_iter=n_iter,
            diameter=6.0,
        )
        bars.append(res.samples)
        print(
            f"t = {t:.2f}: barycenter of {res.samples.shape[0]:,} points, "
            f"mean = ({res.samples[:, 0].mean().item():+.3f}, "
            f"{res.samples[:, 1].mean().item():+.3f})"
        )

    plt = get_pyplot() if plot else None
    if plt is not None:
        fig, axes = plt.subplots(1, len(ts), figsize=(3 * len(ts), 3))
        for ax, t, z in zip(axes, ts, bars):
            ax.scatter(*x_ring.cpu().numpy().T, s=1, alpha=0.1, c="tab:blue")
            ax.scatter(*x_square.cpu().numpy().T, s=1, alpha=0.1, c="tab:red")
            ax.scatter(*z.cpu().numpy().T, s=2, c="black")
            ax.set_title(f"t = {t:.2f}")
            ax.set_aspect("equal")
            ax.set_axis_off()
        savefig(plt, "barycenter_samples.png")

    # The endpoints recover the inputs (up to the entropic blur):
    return {
        "endpoint_err_ring": (bars[0] - x_ring).abs().max().item(),
        "midpoint_mean_x": bars[2][:, 0].mean().item(),
    }


if __name__ == "__main__":
    main()
