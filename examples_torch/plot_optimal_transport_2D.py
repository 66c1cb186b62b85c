"""Regularized Optimal Transport in 2D
=====================================

Compute the entropic OT plan between two 2D point clouds with
``ot.solve_sample``, display the plan's largest entries as segments, and
follow the Brenier/barycentric map.

PyTorch counterpart of ``examples/plot_optimal_transport_2D.py`` (the
reference's ``examples/optimal_transport/plot_optimal_transport_2D.py``).
Run:

    python examples_torch/plot_optimal_transport_2D.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from geomloss_tpu_torch import ot
from _example_utils_torch import annulus, crescent, device_of, get_pyplot, savefig, tensor


def main(N=800, device="cuda", plot=True):
    dev = device_of(device)
    x = annulus(N, seed=1)
    y = crescent(N, seed=2)

    # Entropic OT with a moderate blur: the plan is a fuzzy matching.
    res = ot.solve_sample(X_a=tensor(x, dev), X_b=tensor(y, dev), reg=2 * 0.05**2, max_iter=200)
    print(f"OT value           = {res.value.item():.6f}")
    print(f"linear cost <pi,C> = {res.value_linear.item():.6f}")

    plan = res.plan.cpu().numpy()
    print(f"plan mass = {plan.sum():.4f} (should be ~1)")

    # Barycentric ("Monge") map: where does each source point go?
    targets = res.a_to_b.cpu().numpy()

    plt = get_pyplot() if plot else None
    if plt is not None:
        fig, axes = plt.subplots(1, 2, figsize=(11, 5))
        ax = axes[0]
        # Largest plan entries as faint segments:
        ii, jj = np.unravel_index(
            np.argsort(plan.ravel())[-600:], plan.shape
        )
        for i, j in zip(ii, jj):
            ax.plot(
                [x[i, 0], y[j, 0]], [x[i, 1], y[j, 1]],
                c="purple", lw=30 * N * plan[i, j], alpha=0.3,
            )
        ax.scatter(*x.T, s=6, c="tab:blue", label="source")
        ax.scatter(*y.T, s=6, c="tab:red", label="target")
        ax.set_title("Entropic OT plan (largest entries)")
        ax.legend()

        ax = axes[1]
        ax.quiver(
            x[:, 0], x[:, 1],
            targets[:, 0] - x[:, 0], targets[:, 1] - x[:, 1],
            angles="xy", scale_units="xy", scale=1.0, width=0.002,
            color="gray", alpha=0.6,
        )
        ax.scatter(*x.T, s=6, c="tab:blue")
        ax.scatter(*y.T, s=6, c="tab:red")
        ax.set_title("Barycentric map a_to_b")
        savefig(plt, "optimal_transport_2D.png")

    return res.value.item()


if __name__ == "__main__":
    main()
