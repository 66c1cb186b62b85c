"""Multiscale OT with user-supplied clusters (the 6-argument form)
=================================================================

The multiscale backend normally clusterizes with a spatial sort; passing
explicit integer labels instead makes the coarse phase operate on
*semantic* clusters: ``loss(l_x, a, x, l_y, b, y)``.

PyTorch counterpart of ``examples/plot_optimal_transport_cluster.py`` (the
reference's ``examples/sinkhorn_multiscale/plot_optimal_transport_cluster.py``).
Run:

    python examples_torch/plot_optimal_transport_cluster.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from geomloss_tpu_torch import SamplesLoss
from _example_utils_torch import device_of, gaussian_mixture, get_pyplot, savefig, tensor


def main(N=4000, device="cuda", plot=True):
    dev = device_of(device)
    x, l_x = gaussian_mixture(
        N, [(0.2, 0.2), (0.7, 0.25), (0.45, 0.8)], 0.06, seed=3
    )
    y, l_y = gaussian_mixture(
        N, [(0.3, 0.3), (0.8, 0.4), (0.5, 0.7)], 0.06, seed=4
    )
    a = torch.full((N,), 1.0 / N, dtype=torch.float32, device=dev)
    b = torch.full((N,), 1.0 / N, dtype=torch.float32, device=dev)
    xt, yt = tensor(x, dev), tensor(y, dev)
    lxt, lyt = tensor(l_x, dev, torch.int32), tensor(l_y, dev, torch.int32)

    loss = SamplesLoss(
        "sinkhorn", p=2, blur=0.05, scaling=0.8, diameter=2.0,
        backend="multiscale", verbose=True,
    )
    v_labeled = loss(lxt, a, xt, lyt, b, yt).item()  # 6-arg labeled form
    v_plain = loss(a, xt, b, yt).item()  # spatial clusterization
    print(f"labeled-cluster value : {v_labeled:.8f}")
    print(f"spatial-cluster value : {v_plain:.8f}")
    print(f"relative difference   : {abs(v_labeled - v_plain) / abs(v_plain):.2e}")

    plt = get_pyplot() if plot else None
    if plt is not None:
        colors = np.array([[0.85, 0.3, 0.3], [0.3, 0.6, 0.85], [0.4, 0.75, 0.4]])
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(*x.T, s=5, c=colors[l_x], marker="o", alpha=0.7)
        ax.scatter(*y.T, s=5, c=colors[l_y], marker="x", alpha=0.7)
        ax.set_title("Cluster-labeled source (o) and target (x)")
        savefig(plt, "optimal_transport_cluster.png")

    return abs(v_labeled - v_plain) / abs(v_plain)


if __name__ == "__main__":
    main()
