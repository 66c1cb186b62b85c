"""Accuracy-vs-speed benchmark of the PyTorch port: the twin of
``bench_accuracy.py`` on an NVIDIA GPU.

The solver's error against a tightly converged reference, across backends,
truncation rules and epsilon-scaling values, on bench.py's clouds at
N = 5000 points (small enough for a dense float64 reference), after the
reference's accuracy protocol
(``examples/performances/plot_benchmarks_ot_3D.py:166-199``):

* the debiased-value sweep: {tensorized, online, multiscale} x scaling
  {.5, .7, .9} at blur .05 and .01, each loss against the tensorized
  scaling-0.99 value computed in float64;
* the potentials protocol: {multiscale truncate 1, multiscale truncate 5,
  online, tensorized} x scaling {.5, .7, .9, .99}, solved with
  ``debias=False, potentials=True``, reporting the blurred marginal error
  of the plan the potentials encode (``benchmarks_ot_solvers.py:106-173``)
  and the entropic Wasserstein distance ``sqrt(2 (<a,F> + <b,G>))``
  (``:187-205``) against the same distance from the float64 tensorized
  scaling-0.99 potentials.

The solves run in float32 (the kernels, on the card); the references and
the error functions (:func:`plan_marginals`, :func:`blurred_relative_error`,
:func:`marginal_error`, :func:`wasserstein_distance`, dense, in the inputs'
dtype) in float64. One JSON line per configuration; each time is the median
of 3 host-clock reps ending in a synchronize, after a warm-up:

    PYTHONPATH=. python bench_accuracy_torch.py

It runs on the card and fails without one; its functions also take the
CPU.
"""

import json
import statistics
import time

import torch

from bench_torch import card_line, device_of, sphere_cloud
from geomloss_tpu_torch import SamplesLoss

N = 5000  # small enough for a tensorized high-precision reference
SCALINGS = (0.5, 0.7, 0.9)
POTENTIAL_SCALINGS = (0.5, 0.7, 0.9, 0.99)
#: The potentials protocol's solvers: (name, backend, truncate).
POTENTIAL_CONFIGS = [
    ("multiscale-1", "multiscale", 1),
    ("multiscale-5", "multiscale", 5),
    ("online", "online", None),
    ("tensorized", "tensorized", None),
]


def _dense_cost(x, y):
    return ((x**2).sum(-1)[:, None] + (y**2).sum(-1)[None, :] - 2.0 * x @ y.T) / 2


def plan_marginals(blur, a, x, b, y, F, G):
    """Marginals of the plan encoded by the dual potentials
    (``benchmarks_ot_solvers.py:106-123``)."""
    eps = blur**2
    K = torch.exp((F[:, None] + G[None, :] - _dense_cost(x, y)) / eps)
    return a * (K @ b), b * (K.T @ a)


def blurred_relative_error(blur, x, a, A):
    """Kernel-norm relative error |A - a| / |a| w.r.t. k_eps
    (``benchmarks_ot_solvers.py:137-149``)."""
    K = torch.exp(-_dense_cost(x, x) / blur**2)
    d = A - a
    return torch.sqrt((d @ (K @ d)) / (a @ (K @ a)))


def marginal_error(blur, a, x, b, y, F, G):
    A, B = plan_marginals(blur, a, x, b, y, F, G)
    return 0.5 * (blurred_relative_error(blur, x, a, A) + blurred_relative_error(blur, y, b, B))


def wasserstein_distance(a, b, F, G):
    return torch.sqrt(2.0 * (a @ F + b @ G))


def timed(fn, dev, reps=3):
    """``fn()`` after a warm-up, and the median host-clock ms of ``reps``
    more calls, each ending in a synchronize."""
    out = fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def emit(card, **row):
    print(json.dumps({**row, "device": card}), flush=True)


def value_sweep(x, y, blur, dev, card, scalings=SCALINGS):
    """The debiased values of each backend and scaling against the float64
    tensorized scaling-0.99 value."""
    tag = "" if blur == 0.05 else "_blur" + f"{blur}".lstrip("0")
    ref_loss = SamplesLoss("sinkhorn", p=2, blur=blur, diameter=2.0, scaling=0.99, backend="tensorized")
    with torch.no_grad():
        ref = ref_loss(x.double(), y.double()).item()
    emit(card, metric=f"reference_value{tag}_scaling0.99_float64_torch", value=ref)
    for backend in ("tensorized", "online", "multiscale"):
        for scaling in scalings:
            loss = SamplesLoss("sinkhorn", p=2, blur=blur, diameter=2.0, scaling=scaling, backend=backend)
            with torch.no_grad():
                v, ms = timed(lambda: loss(x, y), dev)
            emit(card, metric=f"{backend}{tag}_scaling{scaling}_torch", value_ms=ms, loss_value=v.item(),
                 abs_error_vs_ref=abs(v.item() - ref))


def potentials_protocol(x, y, blur, dev, card, configs=POTENTIAL_CONFIGS, scalings=POTENTIAL_SCALINGS):
    """The reference's truncate-{1,5} / marginal-error sweep
    (``plot_benchmarks_ot_3D.py:166-199``)."""
    n, m = x.shape[0], y.shape[0]
    a = torch.full((n,), 1.0 / n, dtype=x.dtype, device=dev)
    b = torch.full((m,), 1.0 / m, dtype=y.dtype, device=dev)
    x64, y64, a64, b64 = x.double(), y.double(), a.double(), b.double()

    # Ground truth: tensorized potentials at scaling 0.99, in float64.
    gt_loss = SamplesLoss("sinkhorn", p=2, blur=blur, diameter=2.0, scaling=0.99, backend="tensorized",
                          debias=False, potentials=True)
    with torch.no_grad():
        F, G = gt_loss(a64, x64, b64, y64)
    truth = wasserstein_distance(a64, b64, F.reshape(-1), G.reshape(-1)).item()
    emit(card, metric=f"ground_truth_wasserstein_blur{blur}_float64_torch", value=truth)

    for name, backend, truncate in configs:
        for scaling in scalings:
            loss = SamplesLoss("sinkhorn", p=2, blur=blur, diameter=2.0, scaling=scaling, truncate=truncate,
                               backend=backend, debias=False, potentials=True)
            with torch.no_grad():
                (F, G), ms = timed(lambda: loss(a, x, b, y), dev)
                F, G = F.reshape(-1).double(), G.reshape(-1).double()
                me = marginal_error(blur, a64, x64, b64, y64, F, G).item()
                wd = wasserstein_distance(a64, b64, F, G).item()
            emit(card, metric=f"{name}_blur{blur}_scaling{scaling}_torch", value_ms=ms, marginal_error=me,
                 wasserstein=wd, err_vs_truth=abs(wd - truth))


def main():
    dev = device_of("cuda")
    card = card_line(dev)
    x = torch.from_numpy(sphere_cloud(N, 0)).to(dev)
    y = torch.from_numpy(sphere_cloud(N, 1)).to(dev)
    for blur in (0.05, 0.01):
        value_sweep(x, y, blur, dev, card)
    # The reference's full potentials protocol, for both blur legs:
    for blur in (0.05, 0.01):
        potentials_protocol(x, y, blur, dev, card)


if __name__ == "__main__":
    main()
