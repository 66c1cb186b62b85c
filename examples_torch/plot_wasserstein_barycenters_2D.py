"""Wasserstein barycenters of 2D images
======================================

Blend four corner images (disk, ring, bar, cross) with bilinear
barycentric weights: the classic 2D barycenter demo.

PyTorch counterpart of ``examples/plot_wasserstein_barycenters_2D.py``
(the reference's
``examples/optimal_transport/plot_wasserstein_barycenters_2D.py``). Run:

    python examples_torch/plot_wasserstein_barycenters_2D.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from geomloss_tpu_torch import ImagesBarycenter
from _example_utils_torch import device_of, get_pyplot, savefig, tensor


def shapes(n):
    """Four normalized densities on an n x n grid."""
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    disk = ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.15**2).astype(np.float32)
    ring = (
        (np.abs(np.sqrt((xx - 0.5) ** 2 + (yy - 0.5) ** 2) - 0.25) < 0.04)
    ).astype(np.float32)
    bar = ((np.abs(xx - 0.5) < 0.3) & (np.abs(yy - 0.5) < 0.06)).astype(np.float32)
    cross = (
        ((np.abs(xx - 0.5) < 0.06) & (np.abs(yy - 0.5) < 0.3))
        | ((np.abs(yy - 0.5) < 0.06) & (np.abs(xx - 0.5) < 0.3))
    ).astype(np.float32)
    out = np.stack([disk, ring, bar, cross])
    return out / out.sum(axis=(1, 2), keepdims=True)


def main(n=64, grid=3, device="cuda", plot=True):
    """``n``: grid side (a power of two); ``grid``: the interpolation grid
    (corners + midpoints)."""
    dev = device_of(device)
    measures = tensor(shapes(n)[None], dev)  # (1, 4, n, n)

    tiles = np.zeros((grid, grid, n, n), np.float32)
    for i, s in enumerate(np.linspace(0, 1, grid)):
        for j, t in enumerate(np.linspace(0, 1, grid)):
            w = np.array(
                [(1 - s) * (1 - t), (1 - s) * t, s * (1 - t), s * t],
                np.float32,
            )
            bar = ImagesBarycenter(
                measures, tensor(w[None], dev), blur=0, scaling_N=60
            )
            tiles[i, j] = bar[0, 0].cpu().numpy()
            print(f"w={w.round(2)}: mass={tiles[i, j].sum():.4f}")

    plt = get_pyplot() if plot else None
    if plt is not None:
        fig, axes = plt.subplots(grid, grid, figsize=(8, 8))
        for i in range(grid):
            for j in range(grid):
                axes[i, j].imshow(tiles[i, j], cmap="magma")
                axes[i, j].axis("off")
        fig.suptitle("Bilinear Wasserstein barycenters of four shapes")
        savefig(plt, "wasserstein_barycenters_2D.png")

    return float(tiles[1, 1].sum())


if __name__ == "__main__":
    main()
