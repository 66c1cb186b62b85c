"""Kernel truncation in the multiscale Sinkhorn solver
====================================================

At fine temperatures, the Gibbs kernel ``exp(-C/eps)`` is numerically
sparse: the multiscale backend prunes kernel tiles whose coarse-scale
score ``f + g - C + truncate * eps`` is negative. This script shows the
kept-tile pattern and the accuracy/speed trade-off of the ``truncate``
margin.

PyTorch counterpart of ``examples/plot_kernel_truncation.py`` (the
reference's ``examples/sinkhorn_multiscale/plot_kernel_truncation.py``).
Run:

    python examples_torch/plot_kernel_truncation.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from geomloss_tpu_torch.models.multiscale import sinkhorn_multiscale, spatial_sort_blocks
from geomloss_tpu_torch.ops.block_sparse import masks_from_coarse
from _example_utils_torch import annulus, crescent, device_of, get_pyplot, savefig, tensor


def main(N=4000, device="cuda", plot=True):
    dev = device_of(device)
    x = tensor(annulus(N, seed=1), dev)
    y = tensor(crescent(N, seed=2), dev)
    a = torch.full((N,), 1.0 / N, dtype=torch.float32, device=dev)
    b = torch.full((N,), 1.0 / N, dtype=torch.float32, device=dev)

    kw = dict(p=2, blur=0.02, diameter=1.5, scaling=0.7)
    exact = sinkhorn_multiscale(a, x, b, y, truncate=None, **kw).item()
    print(f"exact (dense fine phase): {exact:.8f}")
    for trunc in [1, 2, 3, 5, 8]:
        v = sinkhorn_multiscale(a, x, b, y, truncate=trunc, **kw).item()
        print(f"truncate={trunc}: value={v:.8f}  |error|={abs(v - exact):.2e}")

    # Visualize the kept tiles for a moderate margin:
    block, tile = 64, 512
    (aw_c, _), (x_c, _), _ = spatial_sort_blocks(a, x, 0.1, 1.5, block, tile)
    (bw_c, _), (y_c, _), _ = spatial_sort_blocks(b, y, 0.1, 1.5, block, tile)
    f0 = torch.zeros((x_c.shape[0],), dtype=torch.float32, device=dev)
    g0 = torch.zeros((y_c.shape[0],), dtype=torch.float32, device=dev)
    mask = masks_from_coarse(
        x_c, y_c, f0, g0, aw_c, bw_c, 0.02**2, 2, 5, tile // block
    )
    cols, counts = mask.cols.cpu().numpy(), mask.counts.cpu().numpy()
    nI = cols.shape[0]
    nJ = int(cols.max()) + 1
    kept = np.zeros((nI, nJ), bool)
    for i in range(nI):
        kept[i, cols[i, : counts[i]]] = True
    frac = counts.sum() / (nI * nJ)
    print(f"kept tile fraction at truncate=5: {frac:.3f}")

    plt = get_pyplot() if plot else None
    if plt is not None:
        fig, axes = plt.subplots(1, 2, figsize=(10, 5))
        axes[0].scatter(*x.cpu().numpy().T, s=4, c="tab:blue")
        axes[0].scatter(*y.cpu().numpy().T, s=4, c="tab:red")
        axes[0].set_title("Point clouds")
        axes[1].imshow(kept, cmap="gray_r", aspect="auto")
        axes[1].set_title(f"Kept kernel tiles ({100 * frac:.1f}%)")
        axes[1].set_xlabel("target tile")
        axes[1].set_ylabel("source tile")
        savefig(plt, "kernel_truncation.png")

    return frac


if __name__ == "__main__":
    main()
