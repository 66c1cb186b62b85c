"""Label transfer with Optimal Transport
=======================================

Solve for the dual potentials with ``SamplesLoss(potentials=True)``, then
apply the implicit (never materialized) transport plan to a matrix of
one-hot label vectors with the streaming Gibbs kernel: the reference's
recipe (``examples/optimal_transport/plot_optimal_transport_labels.py``),
with ``gibbs_apply`` in place of the KeOps ``generic_sum``.

PyTorch counterpart of ``examples/plot_optimal_transport_labels.py``. Run:

    python examples_torch/plot_optimal_transport_labels.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.ops.softmin import gibbs_apply
from _example_utils_torch import device_of, gaussian_mixture, get_pyplot, savefig, tensor


def main(N=3000, device="cuda", plot=True):
    dev = device_of(device)
    # Three source blobs with known labels; three deformed target blobs:
    y, l_y = gaussian_mixture(
        N, [(0.25, 0.3), (0.5, 0.75), (0.8, 0.35)], 0.07, seed=0
    )
    x, l_x_true = gaussian_mixture(
        N, [(0.2, 0.25), (0.55, 0.8), (0.75, 0.3)], 0.09, seed=1
    )
    xt, yt = tensor(x, dev), tensor(y, dev)

    blur = 0.05
    solver = SamplesLoss(
        "sinkhorn", p=2, blur=blur, scaling=0.9, debias=False, potentials=True
    )
    F_i, G_j = solver(xt, yt)
    F_i, G_j = F_i.reshape(-1), G_j.reshape(-1)  # drop the dummy batch axis

    # Transfer one-hot labels through the implicit plan:
    #   Lab_i = sum_j exp((F_i + G_j - C_ij)/eps) * onehot(l_y[j]) * b_j
    eps = blur**2
    onehot = torch.nn.functional.one_hot(torch.as_tensor(l_y, device=dev), 3).float() / N  # fold b_j
    lab = gibbs_apply(xt, yt, F_i / eps, G_j / eps, onehot, eps, p=2)
    transferred = lab.argmax(-1).cpu().numpy()

    # Each source blob matches the corresponding target blob, so the
    # transferred labels should agree with the source's own components:
    accuracy = float((transferred == l_x_true).mean())
    rowsum = lab.sum(-1).cpu().numpy()
    print(f"plan row masses: mean={rowsum.mean():.4f} (should be ~1/N*N=1)")
    print(f"label-transfer accuracy: {accuracy:.3f}")

    plt = get_pyplot() if plot else None
    if plt is not None:
        colors = np.array([[0.85, 0.3, 0.3], [0.3, 0.6, 0.85], [0.4, 0.75, 0.4]])
        lab = lab.cpu().numpy()
        fig, axes = plt.subplots(1, 2, figsize=(11, 5))
        axes[0].scatter(*y.T, s=5, c=colors[l_y])
        axes[0].scatter(*x.T, s=5, c="k", alpha=0.4)
        axes[0].set_title("Labeled target (colors) + unlabeled source (black)")
        # Soft labels: normalize the transferred vectors to get colors:
        soft = lab / np.maximum(rowsum[:, None], 1e-30)
        axes[1].scatter(*x.T, s=5, c=np.clip(soft @ colors, 0, 1))
        axes[1].set_title("Source, colored by transferred labels")
        savefig(plt, "optimal_transport_labels.png")

    return float(rowsum.mean())


if __name__ == "__main__":
    main()
