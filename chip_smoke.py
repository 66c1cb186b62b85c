"""GPU smoke run of geomloss_tpu_torch: builds the kernels, checks each
against its plain PyTorch twin, drives the online and the multiscale
Sinkhorn paths at N = M = 100,000, and times them.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them, or if any
phase fails. Phases, one line each:

1. device: the card's name, the device count and its power limit;
2. build: compiles ``geomloss_tpu_torch/csrc/online_kernels.cu`` and
   ``block_sparse_kernels.cu``, one ``nvcc`` each, started together;
3. repair: peak device memory of the two step kernels at N = M = 1e6 under
   256 MB beyond their inputs, and two calls bitwise equal;
4. parity: each online kernel against its twin on the card at N = M = 1e5
   and at a ragged size, p in {1, 2}; the two block-sparse kernels
   (absorbed sums, full and triangle tables; dual apply, C = 4) against
   their twins on the truncation tables of the multiscale path at 1e5,
   p in {1, 2};
5. online path: value and gradient of ``SamplesLoss("sinkhorn", p=2,
   blur=0.05, diameter=2.0, scaling=0.5, backend="online")`` between two
   100,000-point sphere clouds, held against the same solve through the
   plain twins in float64; then one warm-started solve; the kernel launch
   counts of that run; and a small problem against the dense float64 path;
6. multiscale path (bench.py's call: ``backend="auto"``, which resolves
   to multiscale at this size): value and gradient against the same solve
   through the float64 twins; for information, against the online float64
   value of phase 5 and against ``truncate=None``; the launch counts of
   that run;
7. timing: loss + gradient of both paths, kernels and plain float32 twins;
   each kernel against its twin; the device's idle share over one
   multiscale call (``torch.profiler``).

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
from concurrent.futures import ThreadPoolExecutor

import torch

N_POINTS = 100_000
N_REPAIR = 1_000_000
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
#: Extra device memory one step call may take beyond its inputs at 1e6.
REPAIR_BYTES = 256e6

# TPU kernel each CUDA kernel replaces (wrapper definition, file:line).
REPLACES = {
    "lse": "geomloss_tpu/ops/pallas_kernels.py:239",
    "sinkhorn_step": "geomloss_tpu/ops/pallas_kernels.py:379",
    "sinkhorn_step_sym": "geomloss_tpu/ops/pallas_kernels.py:559",
    "gibbs_apply": "geomloss_tpu/ops/pallas_kernels.py:722",
    "absorbed_sum_tiles": "geomloss_tpu/ops/block_sparse.py:653",
    "gibbs_apply_tiles": "geomloss_tpu/ops/block_sparse.py:859",
}
SOURCES = {
    "online_kernels": "geomloss_tpu_torch/csrc/online_kernels.cu",
    "block_sparse_kernels": "geomloss_tpu_torch/csrc/block_sparse_kernels.cu",
}


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


def profile_busy_ms(fn):
    """Wall time of one call, the device's kernel time in it (ms) and its
    number of kernel launches (torch.profiler), with the eight kernels
    that took the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # the ops that launched them
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows), sum(r[1] for r in rows), rows[:8]


def capture_fine_state(ms, solve):
    """Arguments of the first fine step and the first symmetric fine step
    of one multiscale solve: the sorted clouds, potentials and truncation
    tables the block-sparse kernels get on that path."""
    rec = {}
    pair, sym = ms.sinkhorn_step_walk_banded, ms.sinkhorn_step_walk_banded_sym

    def pair_rec(*args):
        rec.setdefault("xy", args)
        return pair(*args)

    def sym_rec(*args):
        rec.setdefault("xx", args)
        return sym(*args)

    ms.sinkhorn_step_walk_banded, ms.sinkhorn_step_walk_banded_sym = pair_rec, sym_rec
    try:
        with torch.no_grad():
            solve()
    finally:
        ms.sinkhorn_step_walk_banded, ms.sinkhorn_step_walk_banded_sym = pair, sym
    if set(rec) != {"xy", "xx"}:
        fail(f"the multiscale solve ran no truncated fine step ({sorted(rec)})")
    return rec


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
    from geomloss_tpu_torch.models import multiscale as ms
    from geomloss_tpu_torch.models.sinkhorn_samples import sinkhorn_online
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    # --- 2. Build, from the sources of this checkout -----------------------------
    shutil.rmtree(ck.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(ck.build), pool.submit(cbs.build)]:
            fut.result()
    print(f"[build] {', '.join(SOURCES.values())} -> {ck.BUILD_DIR} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    f32, f64 = torch.float32, torch.float64
    max_err = {name: 0.0 for name in REPLACES}

    # --- 3. Repair: bounded, deterministic step kernels at 1e6 --------------------
    xr = torch.from_numpy(sphere_cloud(N_REPAIR, 2)).to(dev)
    yr = torch.from_numpy(sphere_cloud(N_REPAIR, 3)).to(dev)
    lr = torch.full((N_REPAIR,), -math.log(N_REPAIR), dtype=f32, device=dev)
    zr = torch.zeros(N_REPAIR, dtype=f32, device=dev)
    for name, call in (
        ("sinkhorn_step", lambda: ck.sinkhorn_step(xr, yr, zr, zr, lr, lr, BLUR**2, 2)),
        ("sinkhorn_step_sym", lambda: (ck.sinkhorn_step_sym(xr, zr, lr, BLUR**2, 2),)),
    ):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        first = call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        extra = torch.cuda.max_memory_allocated() - base
        same = all(torch.equal(a, b) for a, b in zip(first, call()))
        finite = all(bool(torch.isfinite(a).all()) for a in first)
        print(f"[repair] {name:17s} N=M={N_REPAIR}: peak extra memory {extra / 1e6:.1f} MB "
              f"(limit {REPAIR_BYTES / 1e6:.0f} MB), two calls bitwise equal: {same}, "
              f"{secs:.3f} s; card {card}", flush=True)
        if not (extra < REPAIR_BYTES and same and finite):
            fail(f"{name} at N=M={N_REPAIR}: scratch over budget, nondeterministic or not finite")
    del xr, yr, lr, zr, first

    # --- 4. Kernel parity on the card --------------------------------------------
    x0 = torch.from_numpy(sphere_cloud(N_POINTS, 0)).to(dev)
    y0 = torch.from_numpy(sphere_cloud(N_POINTS, 1)).to(dev)

    def check_val(name, label, got, ref):
        err = (got - ref).abs()
        excess = (err - (VAL_ATOL + VAL_RTOL * ref.abs())).max().item()
        max_err[name] = max(max_err[name], err.max().item())
        print(f"[parity] {name:18s} {label}: max_abs_err {err.max().item():.3e} "
              f"(tol {VAL_ATOL:g} + {VAL_RTOL:g}|ref|)", flush=True)
        if not excess <= 0:
            fail(f"{name} {label} misses its tolerance by {excess:.3e}")

    def check_apply(name, label, got, ref, scale):
        err = (got - ref).abs()
        excess = (err - (APPLY_ATOL_SCALE * scale + APPLY_RTOL * ref.abs())).max().item()
        max_err[name] = max(max_err[name], err.max().item())
        print(f"[parity] {name:18s} {label}: max_abs_err {err.max().item():.3e} "
              f"(tol {APPLY_ATOL_SCALE:g}*{scale:.3g} + {APPLY_RTOL:g}|ref|)", flush=True)
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
                    scale = ck.gibbs_apply_blocked(x, y, -lse_ref, lb, V.abs(), eps, p, kind_c).abs().max().item()
                    check_apply("gibbs_apply", f"{label} {kind_c} C={C}", ck.gibbs_apply(*args),
                                ck.gibbs_apply_blocked(*args), scale)

    # The block-sparse kernels on the tables of the multiscale path at 1e5.
    kw = dict(blur=BLUR, diameter=DIAMETER, scaling=SCALING)
    w = torch.full((N_POINTS,), 1.0 / N_POINTS, dtype=f32, device=dev)
    fine = {}
    for p in (1, 2):
        fine[p] = capture_fine_state(ms, lambda: ms.sinkhorn_multiscale(w, x0, w, y0, p=p, **kw))
        e, xs, ys, la, lb, f, g, cols, cnt, _, tile, _ = fine[p]["xy"]
        _, _, _, f_aa, cols_xx, cnt_xx, _, _, _ = fine[p]["xx"]
        label = (f"N=M={N_POINTS} p={p} tile={tile} ck={cols.shape[1]} "
                 f"kept {int(cnt.sum())}/{cols.numel()} (xx {int(cnt_xx.sum())})")
        phi, psi, phx = la + f / e, lb + g / e, la + f_aa / e
        for tri, args in (
            (False, (xs, ys, phi, psi, e, cols, cnt, p, tile, False)),
            (True, (xs, xs, phx, phx, e, cols_xx, cnt_xx, p, tile, True)),
        ):
            got, ref = cbs.absorbed_sum_tiles(*args), cbs.absorbed_sum_tiles_blocked(*args)
            same = all(torch.equal(a, b) for a, b in zip(got, cbs.absorbed_sum_tiles(*args)))
            if not same:
                fail(f"absorbed_sum_tiles {label}: two calls differ")
            # As the fine step reads them: S = f + eps (loga - log sums).
            if tri:
                check_val("absorbed_sum_tiles", f"{label} triangle",
                          ck._absorbed_update(f_aa, la, e, got[0] + got[1]),
                          ck._absorbed_update(f_aa, la, e, ref[0] + ref[1]))
            else:
                for d, (a, b, pot, lw) in enumerate(zip(got, ref, (f, g), (la, lb))):
                    check_val("absorbed_sum_tiles", f"{label} {'xy' if d == 0 else 'yx'}",
                              ck._absorbed_update(pot, lw, e, a), ck._absorbed_update(pot, lw, e, b))
        # The dual apply of the extrapolation backward: raw weights, C = 4.
        kind_t = "gibbs" if p == 2 else "gibbs_grad"
        Vy = torch.cat([torch.ones_like(ys[:, :1]), ys], 1)
        Vx = torch.cat([torch.ones_like(xs[:, :1]), xs], 1)
        for tri, args in (
            (False, (xs, ys, phi, psi, Vy, Vx, e, cols, cnt, p, kind_t, tile, False)),
            (True, (xs, xs, phx, phx, Vx, Vx, e, cols_xx, cnt_xx, p, kind_t, tile, True)),
        ):
            got, ref = cbs.gibbs_apply_tiles(*args), cbs.gibbs_apply_tiles_blocked(*args)
            same = all(torch.equal(a, b) for a, b in zip(got, cbs.gibbs_apply_tiles(*args)))
            if not same:
                fail(f"gibbs_apply_tiles {label}: two calls differ")
            scales = cbs.gibbs_apply_tiles_blocked(*args[:4], args[4].abs(), args[5].abs(), *args[6:])
            for d in range(2):
                check_apply("gibbs_apply_tiles", f"{label}{' triangle' if tri else ''} "
                            f"{'rows' if d == 0 else 'cols'} C=4", got[d], ref[d], scales[d].abs().max().item())

    # --- 5. Online path ----------------------------------------------------------
    loss = SamplesLoss("sinkhorn", p=2, blur=BLUR, diameter=DIAMETER, scaling=SCALING, backend="online")
    kw2 = dict(p=2, **kw)
    wb = w[None]

    def value_and_grad(fn, x):
        x = x.detach().clone().requires_grad_(True)
        v = fn(x)
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    ck.reset_launch_counts()
    cbs.reset_launch_counts()
    t0 = time.perf_counter()
    v_k, g_k = value_and_grad(lambda x: loss(x, y0), x0)
    raw = sinkhorn_online(wb, x0[None], wb, y0[None], potentials="raw", **kw2)
    x1 = (x0 - 0.5 * N_POINTS * g_k).detach()  # one gradient-flow step
    v_w, g_w = value_and_grad(
        lambda x: sinkhorn_online(wb, x[None], wb, y0[None], init_potentials=raw, warm_start_iters=3, **kw2)[0],
        x1,
    )
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(ck.launch_counts)
    print(f"[online] launches {json.dumps(launches)} in {path_s:.2f} s (first call, build excluded)", flush=True)
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the online path was never launched: {launches}")

    # Reference: the same solves through the plain twins, in float64.
    w64 = wb.to(f64)
    v_r, g_r = value_and_grad(
        lambda x: sinkhorn_online(w64, x[None], w64, y0.to(f64)[None], impl="blocked", **kw2)[0],
        x0.to(f64),
    )
    raw64 = sinkhorn_online(w64, x0.to(f64)[None], w64, y0.to(f64)[None], potentials="raw", impl="blocked", **kw2)
    v_wr, g_wr = value_and_grad(
        lambda x: sinkhorn_online(w64, x[None], w64, y0.to(f64)[None], init_potentials=raw64,
                                  warm_start_iters=3, impl="blocked", **kw2)[0],
        x1.to(f64),
    )

    def rel_errs(v, g, v_ref, g_ref):
        rel_v = abs(v.item() - v_ref.item()) / abs(v_ref.item())
        rel_g = ((g.to(f64) - g_ref.to(f64)).norm() / g_ref.to(f64).norm()).item()
        return rel_v, rel_g

    def compare(tag, label, v, g, v_ref, g_ref):
        if g.shape != (N_POINTS, 3) or not (torch.isfinite(v) and torch.isfinite(g).all()):
            fail(f"{label}: non-finite or misshapen output")
        rel_v, rel_g = rel_errs(v, g, v_ref, g_ref)
        print(f"[{tag}] {label}: loss {v.item():.9e} (float64 twins {v_ref.item():.9e}), "
              f"loss rel err {rel_v:.3e}, grad rel L2 err {rel_g:.3e} (tol {PATH_TOL:g})", flush=True)
        if not (rel_v <= PATH_TOL and rel_g <= PATH_TOL):
            fail(f"{label} misses its tolerance")

    compare("online", f"online N=M={N_POINTS} cold", v_k, g_k, v_r, g_r)
    compare("online", f"online N=M={N_POINTS} warm start", v_w, g_w, v_wr, g_wr)

    # Small problem: kernels against the dense float64 path (no twin involved).
    xs5, ys5 = x0[:5000], y0[:5000]
    v_s, g_s = value_and_grad(lambda x: loss(x, ys5), xs5)
    dense = SamplesLoss("sinkhorn", p=2, blur=BLUR, diameter=DIAMETER, scaling=SCALING, backend="tensorized")
    v_d, g_d = value_and_grad(lambda x: dense(x, ys5.to(f64)), xs5.to(f64))
    rel_v, rel_g = rel_errs(v_s, g_s, v_d, g_d)
    print(f"[online] online N=M={xs5.shape[0]} vs tensorized float64: loss rel err {rel_v:.3e}, "
          f"grad rel L2 err {rel_g:.3e} (tol {PATH_TOL:g})", flush=True)
    if not (rel_v <= PATH_TOL and rel_g <= PATH_TOL):
        fail("small online problem misses the dense float64 reference")

    # --- 6. Multiscale path: bench.py's call, backend "auto" ---------------------
    auto = SamplesLoss("sinkhorn", p=2, blur=BLUR, diameter=DIAMETER, scaling=SCALING)
    ck.reset_launch_counts()
    cbs.reset_launch_counts()
    t0 = time.perf_counter()
    v_m, g_m = value_and_grad(lambda x: auto(x, y0), x0)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches_ms = {**ck.launch_counts, **cbs.launch_counts}
    print(f"[multiscale] launches {json.dumps(launches_ms)} in {path_s:.2f} s (first call)", flush=True)
    if not all(launches_ms[k] > 0 for k in ("lse", "absorbed_sum_tiles", "gibbs_apply_tiles")):
        fail(f"a kernel of the multiscale path was never launched: {launches_ms}")
    w64 = w.to(f64)
    v_mr, g_mr = value_and_grad(
        lambda x: ms.sinkhorn_multiscale(w64, x, w64, y0.to(f64), impl="blocked", **kw2), x0.to(f64)
    )
    compare("multiscale", f"multiscale (auto) N=M={N_POINTS}", v_m, g_m, v_mr, g_mr)
    v_n, g_n = value_and_grad(lambda x: ms.sinkhorn_multiscale(w, x, w, y0, truncate=None, **kw2), x0)
    for label, (v_ref, g_ref) in (("online float64 twins (phase 5)", (v_r, g_r)),
                                  ("truncate=None kernels", (v_n, g_n))):
        rel_v, rel_g = rel_errs(v_m, g_m, v_ref, g_ref)
        print(f"[multiscale] for information, against {label}: loss rel err {rel_v:.3e}, "
              f"grad rel L2 err {rel_g:.3e}", flush=True)

    # --- 7. Timing -----------------------------------------------------------------
    reps = 5
    plain = lambda x: sinkhorn_online(wb, x[None], wb, y0[None], impl="blocked", **kw2)[0]  # noqa: E731
    ms_plain = lambda x: ms.sinkhorn_multiscale(w, x, w, y0, impl="blocked", **kw2)  # noqa: E731
    path = {
        "online": (lambda: value_and_grad(lambda x: loss(x, y0), x0),
                   lambda: value_and_grad(plain, x0)),
        "multiscale": (lambda: value_and_grad(lambda x: auto(x, y0), x0),
                       lambda: value_and_grad(ms_plain, x0)),
    }
    for name, (kern, twin) in path.items():
        ms_path = sync_ms(kern, reps)
        ms_twin = sync_ms(twin, 2)
        ms_path2 = sync_ms(kern, reps)
        print(f"[time] loss+grad N=M={N_POINTS} {name}, host clock, {reps} reps: kernels {ms_path:.3f} / "
              f"{ms_path2:.3f} ms, plain float32 twins {ms_twin:.3f} ms (2 reps); card {card}", flush=True)

    wall, busy, n_launch, top = profile_busy_ms(path["multiscale"][0])
    print(f"[time] multiscale loss+grad under torch.profiler: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {100 * (1 - busy / wall):.1f} %, {n_launch} kernel launches; card {card}", flush=True)
    for dev_ms, calls, key in top:
        print(f"[time]   {dev_ms:9.3f} ms {calls:5d} x {key[:90]}", flush=True)

    eps = BLUR**2
    la = torch.full((N_POINTS,), -math.log(N_POINTS), dtype=f32, device=dev)
    z = torch.zeros(N_POINTS, dtype=f32, device=dev)
    lse_ref = ck.lse_blocked(x0, y0, la, eps, 2)
    V1 = torch.cat([torch.ones_like(y0[:, :1]), y0], 1)  # C = 4, as in the backward
    e, xs, ys, la_f, lb_f, f, g, cols, cnt, _, tile, _ = fine[2]["xy"]
    t_args = (xs, ys, la_f + f / e, lb_f + g / e, e, cols, cnt, 2, tile, False)
    Vy = torch.cat([torch.ones_like(ys[:, :1]), ys], 1)
    Vx = torch.cat([torch.ones_like(xs[:, :1]), xs], 1)
    a_args = (*t_args[:4], Vy, Vx, e, cols, cnt, 2, "gibbs", tile, False)
    cases = {
        "lse": (lambda: ck.lse(x0, y0, la, eps, 2), lambda: ck.lse_blocked(x0, y0, la, eps, 2)),
        "sinkhorn_step": (lambda: ck.sinkhorn_step(x0, y0, z, z, la, la, eps, 2),
                          lambda: ck.sinkhorn_step_blocked(x0, y0, z, z, la, la, eps, 2)),
        "sinkhorn_step_sym": (lambda: ck.sinkhorn_step_sym(x0, z, la, eps, 2),
                              lambda: ck.sinkhorn_step_sym_blocked(x0, z, la, eps, 2)),
        "gibbs_apply": (lambda: ck.gibbs_apply(x0, y0, -lse_ref, la, V1, eps, 2),
                        lambda: ck.gibbs_apply_blocked(x0, y0, -lse_ref, la, V1, eps, 2)),
        "absorbed_sum_tiles": (lambda: cbs.absorbed_sum_tiles(*t_args),
                               lambda: cbs.absorbed_sum_tiles_blocked(*t_args)),
        "gibbs_apply_tiles": (lambda: cbs.gibbs_apply_tiles(*a_args),
                              lambda: cbs.gibbs_apply_tiles_blocked(*a_args)),
    }
    src = {name: SOURCES["block_sparse_kernels" if name.endswith("_tiles") else "online_kernels"]
           for name in cases}
    all_launches = {**launches, **{k: launches_ms[k] for k in cbs.launch_counts}}
    kernels = []
    for name, (kern, twin) in cases.items():
        ms_k = event_ms(kern, 10)
        plain_ms = event_ms(twin, 3)
        where = (f"N=M={N_POINTS} p=2" if name in ck.launch_counts
                 else f"first fine step's table, kept {int(cnt.sum())} tile pairs of {tile}")
        print(f"[time] {name:18s} {where}: kernel {ms_k:.3f} ms, twin {plain_ms:.3f} ms "
              f"(CUDA events); card {card}", flush=True)
        kernels.append({
            "name": name, "route": "cuda", "source": src[name], "replaces": REPLACES[name],
            "launches": all_launches[name], "max_abs_err": max_err[name],
            "ms": ms_k, "plain_ms": plain_ms,
        })

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
