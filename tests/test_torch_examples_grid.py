"""The gallery's grid barycenters (``examples_torch/``), whose JAX
examples cost too much on the CPU (25-30 s each here), held through their
``ImagesBarycenter`` calls against the JAX package at a smaller size, to
1e-4 relative (float32 on both sides). Each script also runs at its smoke
size and must show its property (a barycenter of mass 1).

- ``plot_wasserstein_barycenters_1D``: the JAX example gives a middle
  barycenter of mass 2.11 at its smoke size (blur 0.01, 128 bins), where
  the port gives 1.0000: the JAX grid softmin underflows there. The call
  is held on the script's histograms at 64 bins, blur 0.05 and 5 steps a
  scale.
- ``plot_wasserstein_barycenters_2D``: one call on the script's four
  shapes at 16^2, equal weights, 10 steps a scale.

The first JAX barycenter call in each dimension costs ~10 s of compiles.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gallery_parity import close, gallery, one_thread, run_torch  # noqa: F401 (one_thread: an autouse fixture)

RTOL = 1e-4


def test_wasserstein_barycenters_1D(tmp_path):
    from geomloss_tpu import ImagesBarycenter as JaxBarycenter
    from geomloss_tpu_torch import ImagesBarycenter

    run_torch("plot_wasserstein_barycenters_1D", tmp_path)
    mod = gallery.load("plot_wasserstein_barycenters_1D")
    m = np.stack([mod.gaussian_hist(64, 0.25, 0.04), mod.gaussian_hist(64, 0.7, 0.09)])[None]
    w = np.array([[0.5, 0.5]], np.float32)
    got = ImagesBarycenter(torch.tensor(m), torch.tensor(w), blur=0.05, scaling_N=5).numpy()
    ref = np.asarray(JaxBarycenter(jnp.asarray(m), jnp.asarray(w), blur=0.05, scaling_N=5))
    close(got, ref, RTOL, atol=RTOL * np.abs(ref).max())


def test_wasserstein_barycenters_2D(tmp_path):
    from geomloss_tpu import ImagesBarycenter as JaxBarycenter
    from geomloss_tpu_torch import ImagesBarycenter

    run_torch("plot_wasserstein_barycenters_2D", tmp_path)
    mod = gallery.load("plot_wasserstein_barycenters_2D")
    m = mod.shapes(gallery.SMOKE["plot_wasserstein_barycenters_2D"]["n"])[None].astype(np.float32)
    w = np.full((1, 4), 0.25, np.float32)
    got = ImagesBarycenter(torch.tensor(m), torch.tensor(w), blur=0, scaling_N=10).numpy()
    ref = np.asarray(JaxBarycenter(jnp.asarray(m), jnp.asarray(w), blur=0, scaling_N=10))
    close(got, ref, RTOL, atol=RTOL * np.abs(ref).max())
