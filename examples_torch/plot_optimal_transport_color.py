"""Color transfer with Optimal Transport
=======================================

Treat the RGB values of two images as 3D point clouds and transport one
palette onto the other with the barycentric map of an entropic OT plan.

PyTorch counterpart of ``examples/plot_optimal_transport_color.py`` (the
reference's ``examples/optimal_transport/plot_optimal_transport_color.py``
loads photographs; we synthesize two differently-lit procedural images).
Run:

    python examples_torch/plot_optimal_transport_color.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from geomloss_tpu_torch import ot
from _example_utils_torch import device_of, get_pyplot, savefig, tensor


def make_image(seed, tint, side):
    """A procedural 'photograph': smooth noise + a color tint."""
    rng = np.random.RandomState(seed)
    g = rng.randn(8, 8, 3)
    # Upsample smoothly to side x side (in float32):
    up = np.kron(g, np.ones((side // 8, side // 8, 1))).astype(np.float32)
    img = np.clip(up * np.float32(0.15) + np.asarray(tint, np.float32), 0.0, 1.0)
    return img.astype(np.float32)


def main(side=64, device="cuda", plot=True):
    dev = device_of(device)
    side = 8 * max(2, side // 8)
    src = make_image(0, [0.7, 0.45, 0.3], side)  # warm
    tgt = make_image(1, [0.35, 0.5, 0.75], side)  # cool

    X = src.reshape(-1, 3)
    Y = tgt.reshape(-1, 3)

    res = ot.solve_sample(X_a=tensor(X, dev), X_b=tensor(Y, dev), reg=2 * 0.05**2, max_iter=100)
    X_new = res.a_to_b.cpu().numpy()  # each source color -> its image
    out = X_new.reshape(side, side, 3).clip(0, 1)

    print(f"palettes: src mean {X.mean(0).round(3)}, tgt mean {Y.mean(0).round(3)}")
    print(f"transferred mean   {X_new.mean(0).round(3)} (should match tgt)")

    plt = get_pyplot() if plot else None
    if plt is not None:
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        for ax, img, title in zip(
            axes, [src, tgt, out], ["source", "target palette", "transferred"]
        ):
            ax.imshow(img)
            ax.set_title(title)
            ax.axis("off")
        savefig(plt, "optimal_transport_color.png")

    return float(np.abs(X_new.mean(0) - Y.mean(0)).max())


if __name__ == "__main__":
    main()
