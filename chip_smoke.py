"""GPU smoke run of geomloss_tpu_torch: builds the online kernels, checks
each against its plain PyTorch twin, drives the online Sinkhorn path at
N = M = 100,000, and times it.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them, or if any
phase fails. Phases, one line each:

1. device: the card's name, the device count and its power limit;
2. build: compiles ``geomloss_tpu_torch/csrc/online_kernels.cu``;
3. parity: each kernel against its twin on the card at N = M = 1e5 and at
   a ragged size, p in {1, 2};
4. main path: value and gradient of ``SamplesLoss("sinkhorn", p=2,
   blur=0.05, diameter=2.0, scaling=0.5, backend="online")`` between two
   100,000-point sphere clouds, held against the same solve through the
   plain twins in float64; then one warm-started solve; the kernel launch
   counts of that run; and a small problem against the dense float64 path;
5. timing: loss + gradient, kernel path and plain float32 path, and each
   kernel against its twin.

The line before the last two is a JSON object ``{"kernels": [...]}``; the
line before the last is the card's name and power limit as ``nvidia-smi``
reports them; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import math
import shutil
import subprocess
import sys
import time

import torch

N_POINTS = 100_000
RAGGED = (100_003, 99_991)
BLUR, DIAMETER, SCALING = 0.05, 2.0, 0.5

# Tolerances. Kernel parity: those of tests/test_pallas_kernels.py (LSE and
# step values rtol = atol = 2e-5; applies rtol 2e-3, atol 3e-5 x scale with
# scale = max_i sum_j |w_ij| |V_j|). Main path: float32 kernels against the
# float64 twins, relative error of the loss and relative L2 error of the
# gradient, each <= 1e-3.
VAL_RTOL = VAL_ATOL = 2e-5
APPLY_RTOL, APPLY_ATOL_SCALE = 2e-3, 3e-5
PATH_TOL = 1e-3

# TPU kernel each CUDA kernel replaces (wrapper definition, file:line).
REPLACES = {
    "lse": "geomloss_tpu/ops/pallas_kernels.py:239",
    "sinkhorn_step": "geomloss_tpu/ops/pallas_kernels.py:379",
    "sinkhorn_step_sym": "geomloss_tpu/ops/pallas_kernels.py:559",
    "gibbs_apply": "geomloss_tpu/ops/pallas_kernels.py:722",
}
SOURCE = "geomloss_tpu_torch/csrc/online_kernels.cu"


def fail(msg):
    raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync_ms(fn, reps):
    """Host clock around ``reps`` calls ending in a synchronize, in ms."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def event_ms(fn, reps):
    """CUDA-event time of ``reps`` calls after a warm-up, in ms per call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    # --- 1. Device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    print(f"[device] {kind} x{count}; nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from bench import sphere_cloud
    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.models.sinkhorn_samples import sinkhorn_online
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    # --- 2. Build, from the sources of this checkout -----------------------------
    shutil.rmtree(ck.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ck.build()
    print(f"[build] {SOURCE} -> {ck.BUILD_DIR} in {time.perf_counter() - t0:.1f} s", flush=True)

    # --- 3. Kernel parity on the card --------------------------------------------
    f32 = torch.float32
    x0 = torch.from_numpy(sphere_cloud(N_POINTS, 0)).to(dev)
    y0 = torch.from_numpy(sphere_cloud(N_POINTS, 1)).to(dev)
    max_err = {name: 0.0 for name in REPLACES}

    def check_val(name, label, got, ref):
        err = (got - ref).abs()
        excess = (err - (VAL_ATOL + VAL_RTOL * ref.abs())).max().item()
        max_err[name] = max(max_err[name], err.max().item())
        print(f"[parity] {name:17s} {label}: max_abs_err {err.max().item():.3e} "
              f"(tol {VAL_ATOL:g} + {VAL_RTOL:g}|ref|)", flush=True)
        if not excess <= 0:
            fail(f"{name} {label} misses its tolerance by {excess:.3e}")

    for N, M in [(N_POINTS, N_POINTS), RAGGED]:
        x = torch.from_numpy(sphere_cloud(N, 0)).to(dev)
        y = torch.from_numpy(sphere_cloud(M, 1)).to(dev)
        for p in (1, 2):
            eps = BLUR**p
            label = f"N={N} M={M} p={p}"
            la = torch.full((N,), -math.log(N), dtype=f32, device=dev)
            lb = torch.full((M,), -math.log(M), dtype=f32, device=dev)
            f = torch.zeros(N, dtype=f32, device=dev)
            g = torch.zeros(M, dtype=f32, device=dev)
            lse_ref = ck.lse_blocked(x, y, lb, eps, p)
            check_val("lse", label, ck.lse(x, y, lb, eps, p), lse_ref)
            got = ck.sinkhorn_step(x, y, f, g, la, lb, eps, p)
            for d, (a, b) in enumerate(zip(got, ck.sinkhorn_step_blocked(x, y, f, g, la, lb, eps, p))):
                check_val("sinkhorn_step", f"{label} {'xy' if d == 0 else 'yx'}", a, b)
            check_val("sinkhorn_step_sym", label, ck.sinkhorn_step_sym(x, f, la, eps, p),
                      ck.sinkhorn_step_sym_blocked(x, f, la, eps, p))
            # Row-normalized weights, as in the softmin backward passes:
            for kind_c in ("gibbs", "gibbs_grad"):
                for C in (3, 4):
                    V = y if C == 3 else torch.cat([torch.ones_like(y[:, :1]), y], 1)
                    args = (x, y, -lse_ref, lb, V, eps, p, kind_c)
                    got = ck.gibbs_apply(*args)
                    ref = ck.gibbs_apply_blocked(*args)
                    scale = ck.gibbs_apply_blocked(x, y, -lse_ref, lb, V.abs(), eps, p, kind_c).abs().max().item()
                    err = (got - ref).abs()
                    excess = (err - (APPLY_ATOL_SCALE * scale + APPLY_RTOL * ref.abs())).max().item()
                    max_err["gibbs_apply"] = max(max_err["gibbs_apply"], err.max().item())
                    print(f"[parity] gibbs_apply       {label} {kind_c} C={C}: max_abs_err "
                          f"{err.max().item():.3e} (tol {APPLY_ATOL_SCALE:g}*{scale:.3g} + "
                          f"{APPLY_RTOL:g}|ref|)", flush=True)
                    if not excess <= 0:
                        fail(f"gibbs_apply {label} {kind_c} C={C} misses its tolerance by {excess:.3e}")

    # --- 4. Main path ------------------------------------------------------------
    loss = SamplesLoss("sinkhorn", p=2, blur=BLUR, diameter=DIAMETER, scaling=SCALING, backend="online")
    kw = dict(p=2, blur=BLUR, diameter=DIAMETER, scaling=SCALING)
    w = torch.full((1, N_POINTS), 1.0 / N_POINTS, dtype=f32, device=dev)

    def value_and_grad(fn, x):
        x = x.detach().clone().requires_grad_(True)
        v = fn(x)
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    ck.reset_launch_counts()
    t0 = time.perf_counter()
    v_k, g_k = value_and_grad(lambda x: loss(x, y0), x0)
    raw = sinkhorn_online(w, x0[None], w, y0[None], potentials="raw", **kw)
    x1 = (x0 - 0.5 * N_POINTS * g_k).detach()  # one gradient-flow step
    v_w, g_w = value_and_grad(
        lambda x: sinkhorn_online(w, x[None], w, y0[None], init_potentials=raw, warm_start_iters=3, **kw)[0],
        x1,
    )
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(ck.launch_counts)
    print(f"[main] launches {json.dumps(launches)} in {path_s:.2f} s (first call, build excluded)", flush=True)
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the path was never launched: {launches}")

    # Reference: the same solves through the plain twins, in float64.
    f64 = torch.float64
    w64 = w.to(f64)
    v_r, g_r = value_and_grad(
        lambda x: sinkhorn_online(w64, x[None], w64, y0.to(f64)[None], impl="blocked", **kw)[0],
        x0.to(f64),
    )
    raw64 = sinkhorn_online(w64, x0.to(f64)[None], w64, y0.to(f64)[None], potentials="raw", impl="blocked", **kw)
    v_wr, g_wr = value_and_grad(
        lambda x: sinkhorn_online(w64, x[None], w64, y0.to(f64)[None], init_potentials=raw64,
                                  warm_start_iters=3, impl="blocked", **kw)[0],
        x1.to(f64),
    )

    def compare(label, v, g, v_ref, g_ref):
        if g.shape != (N_POINTS, 3) or not (torch.isfinite(v) and torch.isfinite(g).all()):
            fail(f"{label}: non-finite or misshapen output")
        rel_v = abs(v.item() - v_ref.item()) / abs(v_ref.item())
        rel_g = ((g.to(f64) - g_ref).norm() / g_ref.norm()).item()
        print(f"[main] {label}: loss {v.item():.9e} (float64 twins {v_ref.item():.9e}), "
              f"loss rel err {rel_v:.3e}, grad rel L2 err {rel_g:.3e} (tol {PATH_TOL:g})", flush=True)
        if not (rel_v <= PATH_TOL and rel_g <= PATH_TOL):
            fail(f"{label} misses its tolerance")

    compare(f"online N=M={N_POINTS} cold", v_k, g_k, v_r, g_r)
    compare(f"online N=M={N_POINTS} warm start", v_w, g_w, v_wr, g_wr)

    # Small problem: kernels against the dense float64 path (no twin involved).
    xs, ys = x0[:5000], y0[:5000]
    v_s, g_s = value_and_grad(lambda x: loss(x, ys), xs)
    dense = SamplesLoss("sinkhorn", p=2, blur=BLUR, diameter=DIAMETER, scaling=SCALING, backend="tensorized")
    v_d, g_d = value_and_grad(lambda x: dense(x, ys.to(f64)), xs.to(f64))
    rel_v = abs(v_s.item() - v_d.item()) / abs(v_d.item())
    rel_g = ((g_s.to(f64) - g_d).norm() / g_d.norm()).item()
    print(f"[main] online N=M={xs.shape[0]} vs tensorized float64: loss rel err {rel_v:.3e}, "
          f"grad rel L2 err {rel_g:.3e} (tol {PATH_TOL:g})", flush=True)
    if not (rel_v <= PATH_TOL and rel_g <= PATH_TOL):
        fail("small online problem misses the dense float64 reference")

    # --- 5. Timing -----------------------------------------------------------------
    plain = lambda x: sinkhorn_online(w, x[None], w, y0[None], impl="blocked", **kw)[0]  # noqa: E731
    reps = 5
    ms_path = sync_ms(lambda: value_and_grad(lambda x: loss(x, y0), x0), reps)
    ms_plain = sync_ms(lambda: value_and_grad(plain, x0), reps)
    ms_path2 = sync_ms(lambda: value_and_grad(lambda x: loss(x, y0), x0), reps)
    print(f"[time] loss+grad N=M={N_POINTS} online, host clock, {reps} reps: kernels {ms_path:.3f} / "
          f"{ms_path2:.3f} ms, plain float32 twins {ms_plain:.3f} ms; card {card}", flush=True)

    eps = BLUR**2
    la = torch.full((N_POINTS,), -math.log(N_POINTS), dtype=f32, device=dev)
    z = torch.zeros(N_POINTS, dtype=f32, device=dev)
    lse_ref = ck.lse_blocked(x0, y0, la, eps, 2)
    V1 = torch.cat([torch.ones_like(y0[:, :1]), y0], 1)  # C = 4, as in the backward
    cases = {
        "lse": (lambda: ck.lse(x0, y0, la, eps, 2), lambda: ck.lse_blocked(x0, y0, la, eps, 2)),
        "sinkhorn_step": (lambda: ck.sinkhorn_step(x0, y0, z, z, la, la, eps, 2),
                          lambda: ck.sinkhorn_step_blocked(x0, y0, z, z, la, la, eps, 2)),
        "sinkhorn_step_sym": (lambda: ck.sinkhorn_step_sym(x0, z, la, eps, 2),
                              lambda: ck.sinkhorn_step_sym_blocked(x0, z, la, eps, 2)),
        "gibbs_apply": (lambda: ck.gibbs_apply(x0, y0, -lse_ref, la, V1, eps, 2),
                        lambda: ck.gibbs_apply_blocked(x0, y0, -lse_ref, la, V1, eps, 2)),
    }
    kernels = []
    for name, (kern, twin) in cases.items():
        ms = event_ms(kern, 10)
        plain_ms = event_ms(twin, 3)
        print(f"[time] {name:17s} N=M={N_POINTS} p=2: kernel {ms:.3f} ms, twin {plain_ms:.3f} ms "
              f"(CUDA events); card {card}", flush=True)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms,
        })

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
