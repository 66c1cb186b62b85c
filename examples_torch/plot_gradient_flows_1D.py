"""Gradient flows in 1D
=====================

The 1D setting makes loss landscapes easy to read: watch sample bins
glide along the line under different geometric losses.

PyTorch counterpart of ``examples/plot_gradient_flows_1D.py`` (the
reference's ``examples/comparisons/plot_gradient_flows_1D.py``). Run:

    python examples_torch/plot_gradient_flows_1D.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from geomloss_tpu_torch import SamplesLoss
from _example_utils_torch import device_of, flow_step, get_pyplot, savefig, tensor


def main(N=500, n_steps=80, device="cuda", plot=True):
    dev = device_of(device)
    rng = np.random.RandomState(0)
    x0 = tensor(np.sort(0.2 * rng.rand(N, 1) + 0.1), dev)
    y = tensor(
        np.sort(np.concatenate([0.15 * rng.rand(N // 2, 1) + 0.5,
                                0.1 * rng.rand(N - N // 2, 1) + 0.85])),
        dev,
    )

    configs = {
        "energy": dict(loss="energy"),
        "gaussian": dict(loss="gaussian", blur=0.1),
        "sinkhorn": dict(loss="sinkhorn", p=2, blur=0.01, diameter=1.5,
                         scaling=0.9),
    }
    histories = {}
    for name, kw in configs.items():
        loss = SamplesLoss(**kw)
        x = x0
        hist = [x.cpu().numpy()[:, 0]]
        for _ in range(n_steps):
            val, x = flow_step(lambda x: loss(x, y), x, 0.1 * N)
            hist.append(x.cpu().numpy()[:, 0])
        histories[name] = np.stack(hist)
        print(f"{name:10s}: final loss = {val.item():+.3e}")

    plt = get_pyplot() if plot else None
    if plt is not None:
        fig, axes = plt.subplots(1, len(configs), figsize=(12, 4), sharey=True)
        for ax, (name, hist) in zip(axes, histories.items()):
            for i in range(0, hist.shape[1], max(1, hist.shape[1] // 60)):
                ax.plot(hist[:, i], np.arange(hist.shape[0]), c="b", lw=0.4,
                        alpha=0.5)
            ax.axvline(float(y.mean()), c="r", ls=":")
            ax.set_title(name)
            ax.set_xlabel("position")
        axes[0].set_ylabel("flow time")
        savefig(plt, "gradient_flows_1D.png")

    return histories["sinkhorn"][-1].mean()


if __name__ == "__main__":
    main()
