"""Sinkhorn divergences: interpolation between OT and MMD
=======================================================

The debiased Sinkhorn divergence S_eps interpolates between the sharp
Wasserstein distance (blur -> 0) and a kernel (MMD) norm (blur -> inf).
This script traces the value of S_eps, the biased OT_eps and the energy
distance across blur scales.

PyTorch counterpart of ``examples/plot_transport_blur.py`` (the
reference's ``examples/sinkhorn_multiscale/plot_transport_blur.py``). Run:

    python examples_torch/plot_transport_blur.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from geomloss_tpu_torch import SamplesLoss
from _example_utils_torch import device_of, get_pyplot, savefig, tensor


def main(N=2000, device="cuda", plot=True):
    dev = device_of(device)
    rng = np.random.RandomState(0)
    # Two samplings of the same distribution + a shifted one:
    base = rng.randn(N, 2).astype(np.float32) * 0.2 + 0.5
    same = rng.randn(N, 2).astype(np.float32) * 0.2 + 0.5
    shifted = same + np.array([0.3, 0.0], np.float32)
    x = tensor(base, dev)

    blurs = [0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0]
    rows = {"same": [], "shifted": []}
    for name, target in [("same", same), ("shifted", shifted)]:
        yt = tensor(target, dev)
        for blur in blurs:
            debiased = SamplesLoss(
                "sinkhorn", p=2, blur=blur, diameter=2.0, scaling=0.7
            )
            biased = SamplesLoss(
                "sinkhorn", p=2, blur=blur, diameter=2.0, scaling=0.7,
                debias=False,
            )
            rows[name].append((debiased(x, yt).item(), biased(x, yt).item()))
        energy = SamplesLoss("energy")(x, yt).item()
        print(f"{name:8s}: energy distance = {energy:.5f}")
        for blur, (s, o) in zip(blurs, rows[name]):
            print(f"  blur={blur:5.2f}:  S_eps={s:+.6f}   OT_eps={o:+.6f}")

    # The debiased divergence of two samplings of the SAME measure stays
    # near zero at every blur; the biased one drifts with eps:
    drift = max(abs(s) for s, _ in rows["same"])
    print(f"max |S_eps(same, same')| across blurs: {drift:.2e}")

    plt = get_pyplot() if plot else None
    if plt is not None:
        fig, ax = plt.subplots(figsize=(7, 5))
        for name, marker in [("same", "o"), ("shifted", "s")]:
            ax.semilogx(
                blurs, [s for s, _ in rows[name]], marker + "-",
                label=f"S_eps ({name})",
            )
            ax.semilogx(
                blurs, [o for _, o in rows[name]], marker + "--",
                label=f"OT_eps ({name})",
            )
        ax.set_xlabel("blur")
        ax.set_ylabel("loss value")
        ax.legend()
        ax.set_title("Debiased vs biased Sinkhorn across blur scales")
        savefig(plt, "transport_blur.png")

    return drift


if __name__ == "__main__":
    main()
