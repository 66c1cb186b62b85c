"""Wasserstein interpolation between 3D shapes
============================================

Deform a sphere into a torus by following the Wasserstein-2 gradient flow
of the debiased Sinkhorn divergence, and snapshot the displacement
interpolation along the way.

PyTorch counterpart of ``examples/plot_interpolation_3D.py`` (the
reference's ``examples/optimal_transport/plot_interpolation_3D.py`` loads
triangle meshes; we sample the surfaces procedurally). Run:

    python examples_torch/plot_interpolation_3D.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from geomloss_tpu_torch import SamplesLoss
from _example_utils_torch import device_of, flow_step, get_pyplot, savefig, sphere_3d, tensor, torus_3d


def main(N=20_000, device="cuda", plot=True):
    dev = device_of(device)
    x0 = tensor(sphere_3d(N, seed=0), dev)
    y = tensor(torus_3d(N, seed=1), dev)

    loss = SamplesLoss("sinkhorn", p=2, blur=0.01, diameter=2.0, scaling=0.7)

    snapshots = [x0.cpu().numpy()]
    x = x0
    n_steps = 6
    for i in range(n_steps):
        # a_i = 1/N: W2 gradient flow, unit step
        val, x = flow_step(lambda x: loss(x, y), x, N)
        print(f"step {i}: S_eps = {val.item():.3e}")
        snapshots.append(x.cpu().numpy())

    plt = get_pyplot() if plot else None
    if plt is not None:
        fig = plt.figure(figsize=(16, 3))
        for k, snap in enumerate(snapshots[:: max(1, len(snapshots) // 5)][:5]):
            ax = fig.add_subplot(1, 5, k + 1, projection="3d")
            ax.scatter(*snap.T, s=1, c=snap[:, 2], cmap="viridis")
            ax.set_title(f"t = {k}/4")
            ax.set_axis_off()
        savefig(plt, "interpolation_3D.png")

    return val.item()


if __name__ == "__main__":
    main()
