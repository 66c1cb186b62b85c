"""Transferring labels between brain tractograms
==============================================

Fiber tracts are huge 3D point clouds (millions of points grouped into
streamlines). We segment an unlabeled tractogram by (1) solving a
large-scale OT problem with the multiscale backend, (2) transferring
bundle labels through the implicit plan, and (3) voting per fiber.

PyTorch counterpart of ``examples/transfer_labels_tractograms.py`` (the
reference's ``examples/brain_tractograms/transfer_labels.py`` loads real
tractograms; we synthesize arc-shaped fiber bundles). Run:

    python examples_torch/transfer_labels_tractograms.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.ops.softmin import gibbs_apply
from _example_utils_torch import device_of, fibers_3d, get_pyplot, savefig, tensor


N_BUNDLES = 3
BLUR = 0.02


def tractogram(seed, n_fibers, n_points=20):
    pts, fiber_ids, bundles = [], [], []
    for b in range(N_BUNDLES):
        p, ids = fibers_3d(n_fibers, n_points, seed=seed, bundle=b)
        pts.append(p)
        fiber_ids.append(ids + b * n_fibers)
        bundles.append(np.full(len(p), b, np.int32))
    return (
        np.concatenate(pts),
        np.concatenate(fiber_ids),
        np.concatenate(bundles),
    )


def transfer(x, y, labels_y, blur=BLUR):
    """The dual potentials of OT from ``x`` to ``y`` and the labels of
    ``y`` carried onto ``x`` through the implicit plan: ``(F, G, votes)``,
    ``votes`` of shape ``(N, N_BUNDLES)``."""
    solver = SamplesLoss(
        "sinkhorn", p=2, blur=blur, scaling=0.8, diameter=2.0,
        debias=False, potentials=True,
    )
    F_i, G_j = solver(x, y)
    F_i, G_j = F_i.reshape(-1), G_j.reshape(-1)

    # Label transfer through the implicit plan (streaming: the plan of up
    # to 10^12 entries is never materialized):
    eps = blur**2
    onehot = torch.nn.functional.one_hot(labels_y.long(), N_BUNDLES).to(x.dtype) / len(y)
    votes = gibbs_apply(x, y, F_i / eps, G_j / eps, onehot, eps, p=2)
    return F_i, G_j, votes


def main(n_fibers=600, device="cuda", plot=True):
    dev = device_of(device)
    # Labeled atlas and unlabeled subject (different seeds = anatomy):
    y, _, bundle_y = tractogram(0, n_fibers)
    x, fiber_x, bundle_x_true = tractogram(1, n_fibers)
    print(f"subject: {len(x):,} points, atlas: {len(y):,} points")

    _, _, votes = transfer(tensor(x, dev), tensor(y, dev), torch.as_tensor(bundle_y, device=dev))
    point_labels = votes.argmax(-1)

    # Majority vote per fiber, as one count of (fiber, label) pairs (ties
    # go to the lowest label, as np.bincount(...).argmax() gives):
    fibers = torch.as_tensor(fiber_x, device=dev).long()
    n_fib = int(fiber_x.max()) + 1
    counts = torch.bincount(fibers * N_BUNDLES + point_labels, minlength=n_fib * N_BUNDLES)
    fiber_labels = counts.reshape(n_fib, N_BUNDLES).argmax(-1)
    truth = torch.as_tensor(bundle_x_true, device=dev).long()
    acc_points = (point_labels == truth).sum().item() / len(x)
    acc_fibers = (fiber_labels[fibers] == truth).sum().item() / len(x)
    print(f"pointwise accuracy : {acc_points:.3f}")
    print(f"fiber-vote accuracy: {acc_fibers:.3f}")

    plt = get_pyplot() if plot else None
    if plt is not None:
        colors = np.array([[0.85, 0.3, 0.3], [0.3, 0.6, 0.85], [0.4, 0.75, 0.4]])
        transferred = fiber_labels[fibers].cpu().numpy()
        fig = plt.figure(figsize=(11, 5))
        for k, (pts, lab, title) in enumerate(
            [(y, bundle_y, "Labeled atlas"),
             (x, transferred, "Subject, transferred labels")]
        ):
            ax = fig.add_subplot(1, 2, k + 1, projection="3d")
            ax.scatter(*pts[::5].T, s=1, c=colors[lab[::5]])
            ax.set_title(title)
            ax.set_axis_off()
        savefig(plt, "tractogram_labels.png")

    return acc_fibers


if __name__ == "__main__":
    main()
