"""Comparing loss landscapes: gradient flows in 2D
================================================

Drive the same source cloud toward a target with four different
geometric losses (energy distance, Gaussian MMD, Laplacian MMD and the
debiased Sinkhorn divergence) and compare the trajectories.

PyTorch counterpart of ``examples/plot_gradient_flows_2D.py`` (the
reference's ``examples/comparisons/plot_gradient_flows_2D.py``). Run:

    python examples_torch/plot_gradient_flows_2D.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from geomloss_tpu_torch import SamplesLoss
from _example_utils_torch import annulus, crescent, device_of, flow_step, get_pyplot, savefig, tensor


LOSSES = {
    "energy": dict(loss="energy"),
    "gaussian (blur=.1)": dict(loss="gaussian", blur=0.1),
    "laplacian (blur=.1)": dict(loss="laplacian", blur=0.1),
    "sinkhorn (blur=.01)": dict(
        loss="sinkhorn", p=2, blur=0.01, diameter=2.0, scaling=0.9
    ),
}


def main(N=1500, n_steps=60, device="cuda", plot=True):
    dev = device_of(device)
    x0 = tensor(annulus(N, seed=5), dev)
    y = tensor(crescent(N, seed=6), dev)

    trajectories = {}
    finals = {}
    for name, kw in LOSSES.items():
        loss = SamplesLoss(**kw)
        x = x0
        snaps = [x.cpu().numpy()]
        for i in range(n_steps):
            val, x = flow_step(lambda x: loss(x, y), x, 0.05 * N)
            if (i + 1) % max(1, n_steps // 3) == 0:
                snaps.append(x.cpu().numpy())
        trajectories[name] = snaps
        finals[name] = val.item()
        print(f"{name:22s}: final loss = {finals[name]:+.3e}")

    plt = get_pyplot() if plot else None
    if plt is not None:
        y_np = y.cpu().numpy()
        n_snap = min(len(s) for s in trajectories.values())
        fig, axes = plt.subplots(
            len(LOSSES), n_snap, figsize=(2.6 * n_snap, 2.6 * len(LOSSES))
        )
        for r, (name, snaps) in enumerate(trajectories.items()):
            for c in range(n_snap):
                ax = axes[r, c]
                ax.scatter(*y_np.T, s=2, c="tab:red", alpha=0.3)
                ax.scatter(*snaps[c].T, s=2, c="tab:blue")
                ax.set_xticks([]), ax.set_yticks([])
                if c == 0:
                    ax.set_ylabel(name, fontsize=8)
        savefig(plt, "gradient_flows_2D.png")

    return finals


if __name__ == "__main__":
    main()
