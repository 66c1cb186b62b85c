"""Wasserstein barycenters of 1D densities
=========================================

Interpolate between two 1D histograms with ``ImagesBarycenter`` (the
grid-Sinkhorn barycenter solver): sweeping the weight from 0 to 1 traces
the displacement interpolation, while a plain mixture just fades.

PyTorch counterpart of ``examples/plot_wasserstein_barycenters_1D.py``
(the reference's
``examples/optimal_transport/plot_wasserstein_barycenters_1D.py``). Run:

    python examples_torch/plot_wasserstein_barycenters_1D.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from geomloss_tpu_torch import ImagesBarycenter
from _example_utils_torch import device_of, get_pyplot, savefig, tensor


def gaussian_hist(n, mean, std):
    t = np.linspace(0, 1, n)
    w = np.exp(-0.5 * ((t - mean) / std) ** 2)
    return (w / w.sum()).astype(np.float32)


def main(n=512, n_weights=7, scaling_N=200, device="cuda", plot=True):
    """``scaling_N``: descent steps per scale."""
    dev = device_of(device)
    A = gaussian_hist(n, 0.25, 0.04)
    B = gaussian_hist(n, 0.7, 0.09)
    measures = tensor(np.stack([A, B])[None], dev)  # (1, K=2, N)

    bars = []
    ts = np.linspace(0, 1, n_weights)
    for t in ts:
        w = tensor([[1 - t, t]], dev)
        bar = ImagesBarycenter(measures, w, blur=0.01, scaling_N=scaling_N)
        bars.append(bar[0, 0].cpu().numpy())
        mean = float((np.arange(n) / n * bars[-1]).sum() / bars[-1].sum())
        print(f"t={t:.2f}: barycenter mass={bars[-1].sum():.4f} mean={mean:.3f}")

    plt = get_pyplot() if plot else None
    if plt is not None:
        t_axis = np.linspace(0, 1, n)
        fig, ax = plt.subplots(figsize=(8, 5))
        for t, bar in zip(ts, bars):
            ax.plot(t_axis, bar, color=plt.cm.viridis(t), label=f"t={t:.2f}")
        ax.plot(t_axis, A, "k--", lw=1)
        ax.plot(t_axis, B, "k--", lw=1)
        ax.set_title("Wasserstein barycenters: displacement interpolation")
        ax.legend(fontsize=7)
        savefig(plt, "wasserstein_barycenters_1D.png")

    # The mean should interpolate linearly along the flow:
    return bars[len(bars) // 2].sum()


if __name__ == "__main__":
    main()
