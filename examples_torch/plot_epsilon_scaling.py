"""Epsilon-scaling (simulated annealing) for Sinkhorn iterations
==============================================================

Visualize how the annealing schedule ``eps: diameter^p -> blur^p`` drives
the dual potentials to the sharp-OT solution in a logarithmic number of
iterations, compared to fixed-temperature Sinkhorn.

PyTorch counterpart of ``examples/plot_epsilon_scaling.py`` (the
reference's ``examples/sinkhorn_multiscale/plot_epsilon_scaling.py``). Run:

    python examples_torch/plot_epsilon_scaling.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.solvers.annealing import epsilon_schedule
from _example_utils_torch import annulus, crescent, device_of, get_pyplot, savefig, tensor


def main(N=2000, device="cuda", plot=True):
    dev = device_of(device)
    x = tensor(annulus(N, seed=1), dev)
    y = tensor(crescent(N, seed=2), dev)
    blur = 0.01

    # The schedule itself:
    eps_list = epsilon_schedule(p=2, diameter=1.0, blur=blur, scaling=0.5)
    print("annealing schedule (eps):", [f"{e:.2e}" for e in eps_list])

    # Values along increasingly tight scaling coefficients: each run uses
    # a longer schedule and approximates the sharp OT cost better.
    values = {}
    for scaling in [0.3, 0.5, 0.7, 0.9]:
        loss = SamplesLoss(
            "sinkhorn", p=2, blur=blur, diameter=1.0, scaling=scaling
        )
        n_its = len(epsilon_schedule(2, 1.0, blur, scaling))
        values[scaling] = (n_its, loss(x, y).item())
        print(
            f"scaling={scaling}: {n_its:3d} iterations, "
            f"S_eps = {values[scaling][1]:.8f}"
        )

    # The tightest run is the gold standard:
    ref = values[0.9][1]
    errors = {s: abs(v - ref) for s, (n, v) in values.items()}

    plt = get_pyplot() if plot else None
    if plt is not None:
        fig, axes = plt.subplots(1, 2, figsize=(11, 4))
        axes[0].semilogy(range(len(eps_list)), eps_list, "o-")
        axes[0].set_xlabel("iteration")
        axes[0].set_ylabel("eps")
        axes[0].set_title("Annealing schedule (scaling = 0.5)")
        ns = [values[s][0] for s in values]
        errs = [max(errors[s], 1e-12) for s in values]
        axes[1].semilogy(ns, errs, "o-")
        axes[1].set_xlabel("number of iterations")
        axes[1].set_ylabel("|S - S_ref|")
        axes[1].set_title("Accuracy vs schedule length")
        savefig(plt, "epsilon_scaling.png")

    return ref


if __name__ == "__main__":
    main()
