"""Barycenter of fiber tracks
===========================

Compute a Wasserstein barycenter of several subjects' fiber bundles by
gradient descent: start from one subject's cloud and minimize the sum of
debiased Sinkhorn divergences to all subjects.

PyTorch counterpart of ``examples/track_barycenter.py`` (the reference's
``examples/brain_tractograms/track_barycenter.py``). Run:

    python examples_torch/track_barycenter.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from geomloss_tpu_torch import SamplesLoss
from _example_utils_torch import device_of, fibers_3d, flow_step, get_pyplot, savefig, tensor


def main(n_fibers=400, n_steps=12, device="cuda", plot=True):
    dev = device_of(device)
    subjects = [
        tensor(fibers_3d(n_fibers, 20, seed=s, bundle=0)[0], dev)
        for s in range(4)
    ]
    print(f"4 subjects, {subjects[0].shape[0]:,} points each")

    loss = SamplesLoss("sinkhorn", p=2, blur=0.02, diameter=2.0, scaling=0.7)

    def total(x):
        return sum(loss(x, y) for y in subjects) / len(subjects)

    x = subjects[0]
    for i in range(n_steps):
        val, x = flow_step(total, x, x.shape[0])
        print(f"step {i}: mean divergence = {val.item():.3e}")

    bar = x.cpu().numpy()
    plt = get_pyplot() if plot else None
    if plt is not None:
        fig = plt.figure(figsize=(10, 5))
        ax = fig.add_subplot(1, 2, 1, projection="3d")
        for s in subjects:
            ax.scatter(*s.cpu().numpy()[::7].T, s=1, alpha=0.3)
        ax.set_title("4 subjects")
        ax.set_axis_off()
        ax = fig.add_subplot(1, 2, 2, projection="3d")
        ax.scatter(*bar[::7].T, s=1, c="tab:purple")
        ax.set_title("Wasserstein barycenter")
        ax.set_axis_off()
        savefig(plt, "track_barycenter.png")

    return val.item()


if __name__ == "__main__":
    main()
