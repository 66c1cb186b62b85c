"""Fitting a generative model with a Sinkhorn divergence
======================================================

Use the debiased Sinkhorn divergence as a data-fitting term inside a
standard PyTorch training loop: fit the parameters (means, log-stds) of a
small Gaussian mixture to an observed point cloud with Adam.

PyTorch counterpart of ``examples/model_fitting.py`` (Adam, as there; the
reference's ``examples/optimal_transport/model_fitting.py`` uses L-BFGS).
Run:

    python examples_torch/model_fitting.py
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch

from geomloss_tpu_torch import SamplesLoss
from _example_utils_torch import device_of, gaussian_mixture, get_pyplot, savefig, tensor


K = 3  # mixture components


def draw(gen, n):
    """The noise of ``n`` model samples: a uniform component index and a
    standard normal 2D vector each, from ``gen`` on its device."""
    ks = torch.randint(0, K, (n,), generator=gen, device=gen.device)
    eps = torch.randn(n, 2, generator=gen, device=gen.device)
    return ks, eps


def sample_model(params, ks, eps):
    """Reparametrized sampling (uniform mixture): differentiable with
    respect to the component means and log-stds."""
    means, log_std = params
    return means[ks] + log_std.exp()[ks, None] * eps


def train_step(params, opt, loss, data, noise):
    """One Adam step on ``loss(samples, data)``; returns the loss."""
    opt.zero_grad(set_to_none=True)
    val = loss(sample_model(params, *noise), data)
    val.backward()
    opt.step()
    return val.detach()


def main(N=1500, n_iters=150, device="cuda", plot=True):
    dev = device_of(device)
    data, _ = gaussian_mixture(
        N, [(0.25, 0.3), (0.6, 0.7), (0.8, 0.25)], [0.05, 0.08, 0.04], seed=0
    )
    data = tensor(data, dev)

    loss = SamplesLoss("sinkhorn", p=2, blur=0.03, diameter=2.0, scaling=0.7)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = (
        (0.5 + 0.1 * torch.randn(K, 2, generator=gen, device=dev)).requires_grad_(True),
        torch.full((K,), math.log(0.1), device=dev, requires_grad=True),
    )
    opt = torch.optim.Adam(params, lr=3e-2)

    for i in range(n_iters):
        val = train_step(params, opt, loss, data, draw(gen, N))
        if i % max(1, n_iters // 10) == 0:
            print(f"iter {i:4d}: S_eps = {val.item():.5f}")

    means = params[0].detach().cpu().numpy()
    print("fitted means:\n", means.round(3))

    plt = get_pyplot() if plot else None
    if plt is not None:
        with torch.no_grad():
            xs = sample_model(params, *draw(gen, N)).cpu().numpy()
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(*data.cpu().numpy().T, s=4, c="tab:gray", label="data")
        ax.scatter(*xs.T, s=4, c="tab:blue", alpha=0.5, label="model samples")
        ax.scatter(*means.T, s=80, c="red", marker="*", label="fitted means")
        ax.legend()
        ax.set_title("Sinkhorn-divergence model fitting (Adam)")
        savefig(plt, "model_fitting.png")

    return val.item()


if __name__ == "__main__":
    main()
