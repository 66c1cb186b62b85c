"""Extended benchmark suite of the PyTorch port: the twin of
``bench_suite.py`` on an NVIDIA GPU.

The reference's benchmark protocol
(``examples/performances/plot_benchmarks_samplesloss_3D.py``): loss +
gradient on 3-D unit-sphere clouds, an N sweep for the Sinkhorn (blur .05
and .01), gaussian MMD (blur .1) and energy-distance losses, with
bench_suite.py's configurations, sizes and ``MAXTIME`` guard (a
configuration stops growing N once a call takes longer):

    PYTHONPATH=. python bench_suite_torch.py

One JSON line per configuration and size, with bench_torch.py's timing
fields (:func:`bench_torch.measure`: ``value``, ``events_ms``, ``busy_ms``,
``idle_share``, ``launches``, ``peak_mem_gb``), ``first_s`` (the first
call, kernel build excluded) and a correctness field beside them:

* up to ``F64_MAX_N`` points, ``err_vs_float64`` and ``grad_err_vs_float64``:
  the float32 loss and gradient against the same call in float64 through
  the kernels' plain twins, on the same device, within ``bound_vs_float64``
  and ``grad_bound_vs_float64`` (``within_bound``: both). For the Sinkhorn
  losses the errors are relative (loss) and relative L2 (gradient), each
  within ``PATH_TOL``. For the kernel losses they are absolute: the MMD is
  a difference of three terms that nearly cancel, so the loss is held to
  ``MMD_LOSS_TOL`` times the sum of the terms, and the gradient's L2 error
  to ``MMD_GRAD_TOL`` times the larger L2 norm of its two parts (of
  1/2 <a,Kxx a> and of <a,Kxy b>);
* above ``EXACT_MIN_N`` points, ``rel_err_vs_exact``: against the same loss
  through ``backend="online", truncate=None``, as bench.py does. It has no
  bound: on the multiscale routes it measures the gap between the
  coarse-to-fine (and truncated) descent and the online one, which is the
  scheme's and not the kernels' (0 where the call is the online route
  itself).

Then the blur .01 / .05 ratio lines. The script runs on the card and
fails without one; :func:`run_config` also takes the CPU.
"""

import contextlib
import json
import time

import torch

from bench_torch import (PATH_TOL, card_line, device_of, loss_and_grad, measure, plain_twins, relative, sphere_cloud,
                         sync)
from geomloss_tpu_torch import SamplesLoss

MAXTIME = 60.0  # seconds per call, like the reference's MAXTIME guard
#: Sizes whose line holds the float32 loss against the float64 twins.
F64_MAX_N = 100_000
#: Sizes above this one hold the loss against the exact online value.
EXACT_MIN_N = 10_000
#: The MMD's bounds. The loss's: its error on an H100 is at most 4.5e-8 of
#: the terms (gaussian online at 1e5), and the smallest loss is 4.1e-6 of
#: them (energy at 1e5), so a kernel that drops or doubles the MMD lands
#: above this bound.
MMD_LOSS_TOL = 1e-6
MMD_GRAD_TOL = 1e-3


def sinkhorn(backend, blur):
    return dict(loss="sinkhorn", p=2, blur=blur, diameter=2.0, scaling=0.5, backend=backend)


def kernel(name, blur, backend="online", truncate=5):
    return dict(loss=name, blur=blur, backend=backend, truncate=truncate, diameter=2.0)


#: bench_suite.py's configurations: (name, SamplesLoss arguments, sizes).
CONFIGS = [
    ("sinkhorn_tensorized_blur.05", sinkhorn("tensorized", 0.05), [100, 1_000]),
    ("sinkhorn_multiscale_blur.05", sinkhorn("multiscale", 0.05), [10_000, 100_000, 1_000_000, 2_000_000, 4_000_000]),
    ("sinkhorn_multiscale_blur.01", sinkhorn("multiscale", 0.01), [10_000, 100_000, 1_000_000]),
    ("sinkhorn_online_blur.05", sinkhorn("online", 0.05), [10_000, 100_000]),
    ("sinkhorn_online_blur.01", sinkhorn("online", 0.01), [10_000, 100_000]),
    ("gaussian_mmd_blur.1", kernel("gaussian", 0.1), [10_000, 100_000]),
    ("gaussian_mmd_multiscale_blur.1", kernel("gaussian", 0.1, backend="multiscale", truncate=3),
     [100_000, 1_000_000]),
    ("energy_mmd", kernel("energy", None), [10_000, 100_000]),
]


@contextlib.contextmanager
def captured_terms():
    """The MMD's three terms (1/2 <a,Kxx a>, 1/2 <b,Kyy b>, <a,Kxy b>), as
    ``kernel_samples.scal`` returns them inside the block (summed, in the
    autograd graph), appended to the yielded list."""
    from geomloss_tpu_torch.models import kernel_samples as ks

    out, saved = [], ks.scal

    def scal(*args, **kwargs):
        r = saved(*args, **kwargs)
        out.append(r.sum())
        return r

    ks.scal = scal
    try:
        yield out
    finally:
        ks.scal = saved


def float64_check(kw, x, y, v, g):
    """The loss ``v`` and gradient ``g`` against the same call in float64
    through the plain twins: the line's fields (errors, bounds, the float64
    loss), relative for the Sinkhorn losses, absolute and scaled by the
    MMD's terms and gradient parts for the kernel losses."""
    x64 = x.detach().double().requires_grad_(True)
    with plain_twins(), captured_terms() as terms:
        v64 = SamplesLoss(**kw)(x64, y.double())
        (g64,) = torch.autograd.grad(v64, x64, retain_graph=True)
        err_g = (g.double() - g64).norm().item()
        if kw["loss"] == "sinkhorn":
            return dict(loss_float64=v64.item(), err_kind="relative", err_vs_float64=relative(v, v64.item()),
                        bound_vs_float64=PATH_TOL, grad_err_vs_float64=err_g / g64.norm().item(),
                        grad_bound_vs_float64=PATH_TOL)
        if len(terms) != 3:
            raise RuntimeError(f"{kw['loss']}: expected the MMD's three terms, captured {len(terms)}")
        t_xx, t_yy, t_xy = terms
        (g_self,) = torch.autograd.grad(0.5 * t_xx, x64, retain_graph=True)
        (g_cross,) = torch.autograd.grad(t_xy, x64)
    return dict(loss_float64=v64.item(), err_kind="absolute", err_vs_float64=abs(v - v64.item()),
                bound_vs_float64=MMD_LOSS_TOL * (0.5 * abs(t_xx.item()) + 0.5 * abs(t_yy.item()) + abs(t_xy.item())),
                grad_err_vs_float64=err_g,
                grad_bound_vs_float64=MMD_GRAD_TOL * max(g_self.norm().item(), g_cross.norm().item()))


def run_leg(name, kw, n, dev, card):
    """One configuration at one size: its JSON line (a dict)."""
    x = torch.from_numpy(sphere_cloud(n, 0)).to(dev)
    y = torch.from_numpy(sphere_cloud(n, 1)).to(dev)
    loss = SamplesLoss(**kw)
    step = lambda: loss_and_grad(loss, x, y)  # noqa: E731
    t0 = time.perf_counter()
    v, g = step()
    sync(dev)
    first_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    line = {"metric": f"{name}_N{n}_torch", "unit": "ms", "n": n, **measure(step, dev, 3 if n <= 200_000 else 1),
            "first_s": first_s, "loss_value": v.item()}
    if n <= F64_MAX_N:
        check = float64_check(kw, x, y, v.item(), g)
        line.update(check, within_bound=check["err_vs_float64"] <= check["bound_vs_float64"]
                    and check["grad_err_vs_float64"] <= check["grad_bound_vs_float64"])
    if n > EXACT_MIN_N:
        with torch.no_grad():
            exact = SamplesLoss(**{**kw, "backend": "online", "truncate": None})(x, y).item()
        line.update(loss_exact=exact, rel_err_vs_exact=relative(v.item(), exact))
    line["device"] = card
    return line


def run_config(name, kw, ns, dev, card, results):
    """bench_suite.py's loop: each size in turn until a call takes longer
    than MAXTIME; prints each line and keeps its time in ``results``."""
    lines = []
    for n in ns:
        line = run_leg(name, kw, n, dev, card)
        print(json.dumps(line), flush=True)
        lines.append(line)
        results[line["metric"]] = line["value"]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if line["value"] > MAXTIME * 1e3:
            print(json.dumps({"metric": f"{name}_torch", "maxtime_stop_after_n": n, "MAXTIME_s": MAXTIME}),
                  flush=True)
            break
    return lines


def main():
    dev = device_of("cuda")
    card = card_line(dev)
    results = {}
    for name, kw, ns in CONFIGS:
        run_config(name, kw, ns, dev, card, results)
    # The reference's headline eps-scaling claim: tightening blur .05 -> .01
    # costs only ~2x (plot_benchmarks_ot_3D.py:488-492).
    for backend in ("multiscale", "online"):
        for n in (100_000, 1_000_000):
            t05 = results.get(f"sinkhorn_{backend}_blur.05_N{n}_torch")
            t01 = results.get(f"sinkhorn_{backend}_blur.01_N{n}_torch")
            if t05 and t01:
                print(json.dumps({"metric": f"blur.01_over_.05_{backend}_N{n}_torch", "value": t01 / t05,
                                  "unit": "x", "device": card}), flush=True)


if __name__ == "__main__":
    main()
