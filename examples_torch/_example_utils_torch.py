"""Shared helpers for the PyTorch examples gallery.

The samplers synthesize the gallery's point clouds procedurally, with
numpy from a seed, as the JAX gallery's helpers do (this module keeps its
own copy of them). Each script runs on the card unless its ``main()`` is
given ``device="cpu"``; asking for the card without one raises. Plotting
is optional: with ``plot=True`` a script saves its figure under
``examples_torch/output/`` when matplotlib is importable.

``SMOKE`` holds each script's sizes at the JAX gallery's smoke size, and
``PROPERTIES`` what each script prints as its check, as a function of what
its ``main()`` returns (and, for the flows, of the values of its descent
steps); :func:`load` and :func:`run` run a script and collect both.
"""

import contextlib
import importlib.util
import io
import math
import os
import re
import sys

import numpy as np
import torch

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output")


def device_of(name):
    """``torch.device(name)``; ``"cuda"`` without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run this example on the CPU")
    return dev


def tensor(a, dev, dtype=torch.float32):
    """A numpy array as a tensor on ``dev``."""
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def flow_step(objective, x, rate):
    """One explicit Euler step of a gradient flow: the value of
    ``objective(x)`` and ``x - rate * grad``, both detached."""
    x = x.detach().requires_grad_(True)
    val = objective(x)
    (g,) = torch.autograd.grad(val, x)
    with torch.no_grad():
        return val.detach(), x - rate * g


def get_pyplot():
    """Matplotlib's pyplot with a headless backend, or None."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        return None


def savefig(plt, name):
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, name)
    plt.savefig(path, dpi=110, bbox_inches="tight")
    plt.close("all")
    print(f"saved {path}")


# ------------------------------------------------------------------ samplers


def gaussian_mixture(n, centers, stds, weights=None, seed=0, d=2):
    """Sample ``n`` points from a Gaussian mixture (unit-square-ish)."""
    rng = np.random.RandomState(seed)
    centers = np.asarray(centers, np.float64)
    stds = np.broadcast_to(np.asarray(stds, np.float64), (len(centers),))
    if weights is None:
        weights = np.full(len(centers), 1.0 / len(centers))
    ks = rng.choice(len(centers), size=n, p=weights)
    return (centers[ks] + stds[ks, None] * rng.randn(n, d)).astype(np.float32), ks


def annulus(n, center=(0.5, 0.5), r0=0.25, r1=0.4, seed=0):
    rng = np.random.RandomState(seed)
    r = np.sqrt(rng.rand(n) * (r1**2 - r0**2) + r0**2)
    t = 2 * np.pi * rng.rand(n)
    return (np.stack([r * np.cos(t), r * np.sin(t)], axis=1) + np.asarray(center)).astype(np.float32)


def crescent(n, seed=0):
    rng = np.random.RandomState(seed)
    t = np.pi * rng.rand(n)
    r = 0.3 + 0.05 * rng.randn(n)
    pts = np.stack([0.5 + r * np.cos(t), 0.35 + r * np.sin(t)], axis=1)
    return pts.astype(np.float32)


def sphere_3d(n, seed=0, radius=0.4, center=(0.5, 0.5, 0.5)):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (np.asarray(center) + radius * v).astype(np.float32)


def torus_3d(n, seed=0, R=0.35, r=0.12, center=(0.5, 0.5, 0.5)):
    rng = np.random.RandomState(seed)
    u = 2 * np.pi * rng.rand(n)
    v = 2 * np.pi * rng.rand(n)
    x = (R + r * np.cos(v)) * np.cos(u)
    y = (R + r * np.cos(v)) * np.sin(u)
    z = r * np.sin(v)
    return (np.asarray(center) + np.stack([x, y, z], axis=1)).astype(np.float32)


def fibers_3d(n_fibers, n_points, seed=0, bundle=0):
    """Synthetic brain-fiber-like 3D streamlines: arcs from one region to
    another with smooth noise. Returns (n_fibers * n_points, 3) points and
    per-point fiber ids."""
    rng = np.random.RandomState(seed + 17 * bundle)
    t = np.linspace(0, 1, n_points)
    start = np.array([0.2, 0.3 + 0.2 * bundle, 0.3])
    end = np.array([0.8, 0.4 + 0.15 * bundle, 0.6])
    apex_h = 0.3 + 0.1 * bundle
    pts = []
    ids = []
    for k in range(n_fibers):
        jitter = 0.03 * rng.randn(3)
        arc = (
            (1 - t)[:, None] * (start + jitter)
            + t[:, None] * (end + jitter)
            + np.outer(np.sin(np.pi * t), np.array([0.0, 0.0, apex_h]))
        )
        arc += 0.005 * rng.randn(n_points, 3)
        pts.append(arc)
        ids.append(np.full(n_points, k))
    return (
        np.concatenate(pts).astype(np.float32),
        np.concatenate(ids).astype(np.int32),
    )


# ------------------------------------------------------------------ checks

#: Each script's size arguments at the JAX gallery's smoke size (the
#: ``smoke`` argument of its ``size()`` calls; ``gradient_flow`` as
#: ``tests/test_examples.py`` runs it). The defaults of each ``main()`` are
#: the full sizes.
SMOKE = {
    "gradient_flow": dict(n=256, steps=3),
    "plot_optimal_transport_2D": dict(N=80),
    "plot_optimal_transport_color": dict(side=16),
    "plot_optimal_transport_labels": dict(N=300),
    "plot_optimal_transport_cluster": dict(N=400),
    "plot_interpolation_3D": dict(N=1500),
    "plot_wasserstein_barycenters_1D": dict(n=128, n_weights=3, scaling_N=40),
    "plot_wasserstein_barycenters_2D": dict(n=16, grid=2),
    "plot_epsilon_scaling": dict(N=200),
    "plot_kernel_truncation": dict(N=400),
    "plot_transport_blur": dict(N=200),
    "plot_gradient_flows_1D": dict(N=50, n_steps=10),
    "plot_gradient_flows_2D": dict(N=150, n_steps=8),
    "model_fitting": dict(N=150, n_iters=15),
    "transfer_labels_tractograms": dict(n_fibers=40),
    "track_barycenter": dict(n_fibers=30, n_steps=4),
    "plot_profile": dict(N=400),
    "plot_barycenter_samples": dict(n=128, n_iter=3),
}


def printed(text, pattern):
    """The float that ``pattern``'s group reads in a script's output (the
    last match)."""
    return float(re.findall(pattern, text)[-1])


def _finite(*vals):
    return all(math.isfinite(float(v)) for v in vals)


def _decreases(values):
    return len(values) > 1 and _finite(*values) and values[-1] < values[0]


#: What each script prints as its check, as a predicate of ``(out, text,
#: values)``: what ``main()`` returned, what it printed, and the values of
#: its ``flow_step`` calls in order (empty for the other scripts).
PROPERTIES = {
    "gradient_flow": (
        "S_eps decreases along the flow",
        lambda out, text, values: out is None and _decreases(values),
    ),
    "plot_optimal_transport_2D": (
        "a positive OT value, plan mass within 1e-2 of 1",
        lambda out, text, values: out > 0 and abs(printed(text, r"plan mass = (\S+)") - 1) <= 1e-2,
    ),
    "plot_optimal_transport_color": (
        "the transferred mean within 0.02 of the target palette's",
        lambda out, text, values: 0 <= out <= 0.02,
    ),
    "plot_optimal_transport_labels": (
        "plan row masses within 0.05 of 1, label accuracy >= 0.9",
        lambda out, text, values: abs(out - 1) <= 0.05
        and printed(text, r"label-transfer accuracy: (\S+)") >= 0.9,
    ),
    "plot_optimal_transport_cluster": (
        "labeled and spatial clusters within 5e-2 of each other",
        lambda out, text, values: 0 <= out <= 5e-2,
    ),
    "plot_interpolation_3D": (
        "S_eps decreases along the flow",
        lambda out, text, values: _decreases(values) and out == values[-1],
    ),
    "plot_wasserstein_barycenters_1D": (
        "the middle barycenter's mass within 1e-2 of 1",
        lambda out, text, values: abs(out - 1) <= 1e-2,
    ),
    "plot_wasserstein_barycenters_2D": (
        "the barycenter's mass within 1e-2 of 1",
        lambda out, text, values: abs(out - 1) <= 1e-2,
    ),
    "plot_epsilon_scaling": (
        "a positive S_eps at scaling 0.9",
        lambda out, text, values: _finite(out) and out > 0,
    ),
    "plot_kernel_truncation": (
        "a kept tile fraction in (0, 1], truncate=8 within 1e-4 (relative) of the exact fine phase",
        lambda out, text, values: 0 < out <= 1
        and printed(text, r"truncate=8: value=\S+\s+\|error\|=(\S+)")
        <= 1e-4 * abs(printed(text, r"exact \(dense fine phase\): (\S+)")),
    ),
    "plot_transport_blur": (
        "S_eps between two samplings of one measure within 1e-2 of 0 at every blur",
        lambda out, text, values: 0 <= out <= 1e-2,
    ),
    "plot_gradient_flows_1D": (
        "the Sinkhorn flow's mean past the midpoint from the source's mean (0.2) to the target's (0.7375)",
        lambda out, text, values: 0.47 < out < 1,
    ),
    "plot_gradient_flows_2D": (
        "every loss decreases along its flow",
        lambda out, text, values: _finite(*out.values())
        and all(_decreases(v) for v in np.array_split(np.asarray(values), len(out))),
    ),
    "model_fitting": (
        "the final S_eps below the first",
        lambda out, text, values: _finite(out) and out < printed(text, r"iter\s+0: S_eps = (\S+)"),
    ),
    "transfer_labels_tractograms": (
        "fiber-vote accuracy >= 0.9",
        lambda out, text, values: out >= 0.9,
    ),
    "track_barycenter": (
        "the mean divergence decreases",
        lambda out, text, values: _decreases(values) and out == values[-1],
    ),
    "plot_profile": (
        "four positive timings",
        lambda out, text, values: len(out) == 4 and all(_finite(t) and t > 0 for t in out.values()),
    ),
    "plot_barycenter_samples": (
        "the t = 0 barycenter within 0.1 of the ring, the t = 0.5 one centred within 0.2 of x = 0",
        lambda out, text, values: out["endpoint_err_ring"] <= 0.1 and abs(out["midpoint_mean_x"]) <= 0.2,
    ),
}


def load(name):
    """A fresh instance of the gallery script ``examples_torch/<name>.py``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name + ".py")
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Tee(io.StringIO):
    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, s):
        self.out.write(s)
        return super().write(s)


def run(mod, **kwargs):
    """``mod.main(**kwargs)``, its output still printed: returns ``(out,
    text, values)``, what it returned and printed and the value of each of
    its ``flow_step`` calls."""
    values = []
    step = getattr(mod, "flow_step", None)
    if step is not None:
        def recorded(*args):
            val, x = step(*args)
            values.append(val.item())
            return val, x

        mod.flow_step = recorded
    tee = _Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(tee):
            out = mod.main(**kwargs)
    finally:
        if step is not None:
            mod.flow_step = step
    return out, tee.getvalue(), values


def check(name, out, text, values):
    """Whether a run of ``name`` shows its property; ``(ok, what)``."""
    what, holds = PROPERTIES[name]
    return bool(holds(out, text, values)), what
