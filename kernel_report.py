"""Build report and CUDA-event times of the register-tiled pair kernels of
geomloss_tpu_torch on one GPU: kernel 1 (``lse``), kernels 2, 3 and 4
(``sinkhorn_step``, ``sinkhorn_step_sym``, ``gibbs_apply``), kernels 5
and 6 (``absorbed_sum_tiles``, ``gibbs_apply_tiles``), kernel 7
(``lse_tiles``, and ``lse_sparse`` on it) and kernel 8
(``gibbs_apply_sparse``), kernel 12 (``absorbed_sum_sparse``, and
``absorbed_sum_walk`` on it) and kernel 11 (``gibbs_apply_walk``, on
kernel 8).

    python3 kernel_report.py [--root DIR] [--report tiles step sparse online lse sums]
                             [--sizes 100000 2000000]
                             [--dim 3] [--backend auto] [--reps 3] [--no-build-report] [--dump DIR]

``--root`` imports the package from another checkout (for example the
parent commit unpacked with ``git archive``), so that two versions can be
compared on one card in one job: run parent, change, change, parent.

Prints, from the build of both libraries:

- each kernel's registers, stack and spills as ``nvcc -Xptxas -v`` gave
  them (the ``.log`` beside each library);
- for the kernels of SASS_LABELS, the instruction counts of the hot loop
  of their SASS (``cuobjdump -sass``): the innermost loop with the most
  MUFU instructions, by opcode class, and per pair (over its MUFU count:
  one exp2 per pair at these instantiations).

Then each report of ``--report`` (all six by default):

- ``tiles``: for each of ``--sizes``, bench.py's call (``SamplesLoss(
  "sinkhorn", p=2, blur=0.05, diameter=2.0, scaling=0.5)``, value and
  gradient in x, two unit-sphere clouds of seeds 0 and 1, in ``--dim``
  dimensions through ``--backend``: ``multiscale`` for a D above 3, which
  ``auto`` sends to the online backend) is run once with every kernel 5
  and 6 call recorded; each recorded call is then timed alone, and so are
  both kernels on the first fine step's xy table;
- ``step``: the same call with ``backend="online"`` at N = M = 1e5 (in
  ``--dim`` dimensions), and ``SamplesLoss()`` at 1e4 points in D = 32:
  kernel 2's wrapper calls and launches, the device time of each kernel in
  one call (``torch.profiler``) and the idle share, and one kernel-2 call
  timed alone beside its MUFU bound and issue floor;
- ``sparse``: the gaussian MMD's truncated route (``SamplesLoss(
  "gaussian", blur=0.1, truncate=3, backend="multiscale")``) at
  N = M = 1e6: each of its kernel-8 applies with its table (kept tile
  pairs, mean and longest row, channels), timed alone beside its MUFU
  bound and issue floor, and the device time of one call; then kernel 8
  at each of its weight kinds, C = 1 and 4, on the same route's xy table
  at 1e5;
- ``online``: kernel 3 (the debias step) per call at N = 1e5 (CUDA events
  and host clock) and kernel 4 in each mode at C = 1 and 4 at N = M =
  1e5, beside their MUFU bound and issue floor; both at D = 32 and 1e4
  points (kernel 4 at C = 33, the backward's channels); kernel 8's modes
  at 1e5 as in ``sparse``; then the energy, gaussian online and
  laplacian multiscale MMD calls at 1e5 (blur 0.1, truncate 3): host
  clock per call, and under ``torch.profiler`` the device busy time, the
  idle share and the device time of each kernel;
- ``lse``: bench.py's call at 1e5 and at the largest of ``--sizes`` (the
  mid path) profiled (device busy and idle share, the device time of
  kernels 1 and 7 in it); kernel 1 at each shape the call launches it
  with (4,096 coarse points, the mid cloud), with their counts, and
  at N = M = 1e5 and at 1e4 in D = 32; kernel 7 on the mid path's four
  extrapolation tables; kernel 9 (``lse_sparse``) on ``softmin_sparse``'s
  uncapped table at 1e5 (the gaussian MMD's geometry, blur 0.1, truncate
  3): each beside its MUFU bound and issue floor, kernel 1 beside the
  dense PyTorch composition ``logsumexp(h - cdist(x, y)^2 / 2 eps)``
  where its matrix fits, and the device kernels one ``lse`` call
  launches (``torch.profiler``), PyTorch's and its own;
- ``sums``: for each of ``--sizes``, bench.py's call (``backend="auto"``)
  is run once with its first fine step recorded; on that step's xy table,
  kernel 12 (``absorbed_sum_sparse``), kernel 10 (``absorbed_sum_walk``
  on its unclipped walk), kernel 11 (``gibbs_apply_walk``, V = [1, y])
  and the walk table's decode (``_walk_rows``), each timed with CUDA
  events and under ``torch.profiler`` (the device time of one call and
  its device launches by kernel, PyTorch's and the library's), beside its
  MUFU bound and issue floor, with the table's kept tiles per row.

Times are CUDA events after a warm-up; each report ends with a JSON line
holding them and the card's name and power limit. Needs a CUDA device.
"""

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

from chip_smoke import (
    FINE_CALLS,
    MUFU_PER_CLOCK,
    card_line,
    event_ms,
    first_step_state,
    issue_ms,
    kernel_label,
    pair_slots,
    profile_busy_ms,
    ptxas_usage,
    recording,
    sm_clock_hz,
    sphere_cloud,
    table_stats,
    value_and_grad,
)

#: Opcode classes counted in a hot loop (by the opcode's first field).
SASS_CLASSES = ("MUFU", "SHFL", "LDS", "LDG", "LDL", "STL", "FFMA", "FADD", "FMUL", "FSEL", "SEL", "FMNMX", "FSETP",
                "ISETP", "BAR", "STS")
#: Kernels whose hot loop is read, at bench.py's instantiation (D = 3,
#: p = 2; applies in mode 0, and in the energy and inv_dist modes 3 and 4).
#: Kernels 1 and 7 were templated on <D, P> (one thread per row) before
#: their register-tiled forms on <P, KV>.
#: Kernels 2-6 and 8 were templated on <D, P> and <D, MODE> before their
#: register-tiled forms; since, kernels 2, 3 and 5 on <P, KV> (KV float4s
#: per packed point, 0 for the wide form), kernel 6 on <MODE, WIDE> and
#: kernels 4 and 8 on <MODE, KV, CH> (CH channels). Kernel 5 at p = 2,
#: D = 8 (KV = 3) is read too. In a build of the first forms, <2,1> names
#: another instantiation (D = 2, p = 1), and so do <3,1> and <4,1> of the
#: two-argument kernels (D = 3 and 4); kernel 4's first form in modes 3 and
#: 4 is <3,3> and <3,4>. Kernel 12 was templated on <D, P> (one thread per
#: row) before its register-tiled form on <P, KV>: <3,2> is the first
#: form's D = 3, p = 2, <2,1> and <2,3> the second's p = 2, D = 3 and 8.
SASS_LABELS = ("lse_kernel<3,2>", "tiles_lse_kernel<3,2>", "lse_kernel<2,1>", "tiles_lse_kernel<2,1>",
               "tiles_step_kernel<3,2>", "tiles_apply_kernel<3,0>", "tiles_step_kernel<2,1>",
               "tiles_step_kernel<2,3>", "tiles_apply_kernel<0,0>", "step_kernel<3,2>", "step_kernel<2,1>",
               "sparse_apply_kernel<3,0>", "sparse_apply_kernel<0,1,1>", "sparse_apply_kernel<0,1,4>",
               "sparse_apply_kernel<3,1,1>", "sparse_apply_kernel<4,1,1>",
               "sym_step_kernel<3,2>", "sym_step_kernel<2,1>", "apply_kernel<3,0>", "apply_kernel<3,3>",
               "apply_kernel<3,4>", "apply_kernel<0,1,1>", "apply_kernel<0,1,4>", "apply_kernel<3,1,1>",
               "apply_kernel<4,1,1>", "apply_kernel<3,1,4>", "apply_kernel<4,1,4>",
               "sparse_sum_kernel<3,2>", "sparse_sum_kernel<2,1>", "sparse_sum_kernel<2,3>")


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_functions(text):
    """``{kernel label: [(address, opcode, operands), ...]}`` of a
    ``cuobjdump -sass`` listing."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), [])
            continue
        m = _SASS_LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def hot_loop(instrs):
    """The innermost loop (a backward branch and its target, holding no
    other) with the most MUFU instructions, the shortest of those, or any
    loop if no innermost one has a MUFU: ``(start, end, [opcodes])``, or
    None. Per pass of a register-tiled pair block, that is the pass."""
    loops = []
    for addr, op, rest in instrs:
        m = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    best = None
    for inner_only in (True, False):
        for s, e in loops:
            if inner_only and any(s <= s2 and e2 <= e and (s2, e2) != (s, e) for s2, e2 in loops):
                continue
            ops = [o for a, o, _ in instrs if s <= a <= e]
            key = (sum(o.startswith("MUFU") for o in ops), -len(ops))
            if key[0] and (best is None or key > best[0]):
                best = (key, (s, e, ops))
        if best:
            return best[1]
    return None


def loop_counts(ops):
    """Instruction counts of a loop body by opcode class, its total and the
    total per MUFU instruction (per pair where a pair takes one)."""
    counts = {c: 0 for c in SASS_CLASSES}
    for op in ops:
        base = op.split(".")[0]
        if base in counts:
            counts[base] += 1
    counts["total"] = len(ops)
    counts["per_pair"] = round(len(ops) / counts["MUFU"], 3) if counts["MUFU"] else None
    return counts


def build_report(libs, dump=None):
    """Print the ptxas usage of every kernel of the built libraries and the
    hot loops of the kernels of SASS_LABELS (their SASS listings written
    under ``dump``, if given); returns ``(ptxas usage, hot-loop counts)``."""
    usage, loops = {}, {}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib in libs:
        so = lib._name
        usage.update(ptxas_usage(open(os.path.splitext(so)[0] + ".log").read()))
        sass = sass_functions(subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout)
        for name, instrs in sorted(sass.items()):
            if name not in SASS_LABELS:
                continue
            loop = hot_loop(instrs)
            if loop is None:
                continue
            s, e, ops = loop
            loops[name] = loop_counts(ops)
            if dump:
                os.makedirs(dump, exist_ok=True)
                with open(os.path.join(dump, re.sub(r"\W", "_", name) + ".sass"), "w") as fh:
                    fh.writelines(f"{a:06x} {'>' if s <= a <= e else ' '} {op}{rest}\n" for a, op, rest in instrs)
            print(f"[sass] {name}: {len(instrs)} instructions; hot loop 0x{s:x}-0x{e:x}: {json.dumps(loops[name])}",
                  flush=True)
    for name, u in sorted(usage.items()):
        print(f"[ptxas] {name}: {u}", flush=True)
    return usage, loops


def kernel_times(rows):
    """Device ms and launches of a profile's rows, summed by kernel name."""
    out = {}
    for dev_ms, calls, key in rows:
        m = re.search(r"::(\w+)", key) or re.match(r"(\w+)", key)
        name = m.group(1) if m else key[:40]
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + dev_ms, n + calls)
    return out


def tiles_report(torch, mods, args, card):
    """Kernels 5 and 6 in bench.py's call at each size."""
    SamplesLoss, ms, cbs = mods["SamplesLoss"], mods["ms"], mods["cbs"]
    dev = torch.device("cuda")
    loss = SamplesLoss("sinkhorn", p=2, blur=0.05, diameter=2.0, scaling=0.5, backend=args.backend)
    names = ("absorbed_sum_tiles", "gibbs_apply_tiles")
    for n in args.sizes:
        x0 = torch.from_numpy(sphere_cloud(n, 0, args.dim)).to(dev).requires_grad_(True)
        y0 = torch.from_numpy(sphere_cloud(n, 1, args.dim)).to(dev)
        with recording(cbs, names) as rec, recording(ms, ("sinkhorn_step_walk_banded",)) as rec_ms:
            (g,) = torch.autograd.grad(loss(x0, y0), x0)
        torch.cuda.synchronize()
        res = {"root": args.root, "report": "tiles", "n": n, "dim": args.dim, "backend": args.backend, "card": card}
        torch.set_grad_enabled(False)
        for name in names:
            times = []
            for k, (a, kw) in enumerate(rec[name]):
                fn = getattr(cbs, name)
                t = event_ms(lambda: fn(*a, **kw), args.reps)
                cols, cnt = a[7:9] if name == "gibbs_apply_tiles" else a[5:7]
                tri = a[-1]  # the block-sparse ops pass every argument positionally
                times.append(t)
                print(f"[time] {name} call {k}: {t:.3f} ms, table {tuple(cols.shape)} kept {int(cnt.sum())} "
                      f"tri={tri} (CUDA events, {args.reps} reps); card {card}", flush=True)
            res[name] = times
            print(f"[time] {name} N=M={n}: {len(times)} calls, sum {sum(times):.3f} ms", flush=True)
        e, xs, ys, la, lb, f, gg, cols, cnt, p, tile, _ = rec_ms["sinkhorn_step_walk_banded"][0][0]
        t_args = (xs, ys, la + f / e, lb + gg / e, e, cols, cnt, 2, tile, False)
        Vy = torch.cat([torch.ones_like(ys[:, :1]), ys], 1)
        Vx = torch.cat([torch.ones_like(xs[:, :1]), xs], 1)
        a_args = (*t_args[:4], Vy, Vx, e, cols, cnt, 2, "gibbs", tile, False)
        first = {"absorbed_sum_tiles": event_ms(lambda: cbs.absorbed_sum_tiles(*t_args), args.reps),
                 "gibbs_apply_tiles": event_ms(lambda: cbs.gibbs_apply_tiles(*a_args), args.reps)}
        res["first_fine_table"] = dict(first, kept_tiles=int(cnt.sum()), tile=tile, pairs=int(cnt.sum()) * tile * tile)
        print(json.dumps(res), flush=True)
        del x0, y0, g, rec, rec_ms, t_args, a_args, xs, ys, Vx, Vy
        torch.cuda.empty_cache()
        torch.set_grad_enabled(True)


def step_report(torch, mods, args, card, clock):
    """Kernel 2 in the online call at 1e5 (``--dim``) and in SamplesLoss()
    at 1e4 points in D = 32."""
    SamplesLoss, ck = mods["SamplesLoss"], mods["ck"]
    dev = torch.device("cuda")
    kw = dict(p=2, blur=0.05, diameter=2.0, scaling=0.5)
    for n, dim, backend in ((100_000, args.dim, "online"), (10_000, 32, "auto")):
        loss = SamplesLoss("sinkhorn", backend=backend, **kw)
        x0 = torch.from_numpy(sphere_cloud(n, 0, dim)).to(dev)
        y0 = torch.from_numpy(sphere_cloud(n, 1, dim)).to(dev)
        call = lambda: value_and_grad(lambda x: loss(x, y0), x0)  # noqa: E731
        call()
        ck.reset_launch_counts()
        with recording(ck, ("sinkhorn_step",)) as rec:
            call()
        torch.cuda.synchronize()
        launches = {k: v for k, v in ck.launch_counts.items() if v}
        wall, busy, n_launch, rows = profile_busy_ms(call, top=None)
        by_kernel = kernel_times(rows)
        a, kwa = rec["sinkhorn_step"][0]
        t = event_ms(lambda: ck.sinkhorn_step(*a, **kwa), args.reps)
        pairs = n * n
        kv = math.ceil((dim + 1) / 4)
        mufu = 1e3 * pairs / (MUFU_PER_CLOCK * clock)
        slots = pair_slots("sinkhorn_step", kv)
        floor = issue_ms(slots, pairs, clock)
        res = {"root": args.root, "report": "step", "n": n, "dim": dim, "backend": backend,
               "sinkhorn_step_calls": len(rec["sinkhorn_step"]), "launches": launches,
               "wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall, "device_launches": n_launch,
               "device_ms_by_kernel": {k: round(v[0], 4) for k, v in by_kernel.items()},
               "device_launches_by_kernel": {k: v[1] for k, v in by_kernel.items()},
               "sinkhorn_step_ms": t, "mufu_bound_ms": mufu, "issue_floor_ms": floor, "card": card}
        print(f"[step] N=M={n} D={dim} {backend}: {len(rec['sinkhorn_step'])} kernel-2 calls, launches "
              f"{json.dumps(launches)}; one call {t:.3f} ms (CUDA events, {args.reps} reps), MUFU bound {mufu:.3f} ms, "
              f"issue floor {floor:.3f} ms ({slots} slots per pair); profiled wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms, idle {100 * (1 - busy / wall):.1f} %; card {card}", flush=True)
        print(json.dumps(res), flush=True)
        del x0, y0, rec, a, kwa
        torch.cuda.empty_cache()


def sparse_report(torch, mods, args, card, clock):
    """Kernel 8's applies in the gaussian MMD's truncated route at 1e6."""
    SamplesLoss, cbs = mods["SamplesLoss"], mods["cbs"]
    dev = torch.device("cuda")
    n = 1_000_000
    loss = SamplesLoss("gaussian", blur=0.1, truncate=3, backend="multiscale")
    x0 = torch.from_numpy(sphere_cloud(n, 0, args.dim)).to(dev)
    y0 = torch.from_numpy(sphere_cloud(n, 1, args.dim)).to(dev)
    call = lambda: value_and_grad(lambda x: loss(x, y0), x0)  # noqa: E731
    call()
    with recording(cbs, ("gibbs_apply_sparse",)) as rec:
        v, _ = call()
    torch.cuda.synchronize()
    wall, busy, n_launch, rows = profile_busy_ms(call, top=None)
    by_kernel = kernel_times(rows)
    applies = []
    for k, (a, kwa) in enumerate(rec["gibbs_apply_sparse"]):
        x, y, phi, psi, V, eps, cols, counts, p, kind, bn, bm = a
        kept, mean, most, at_cap = table_stats(cols, counts)
        pairs = kept * bn * bm
        C = V.shape[1]
        t = event_ms(lambda: cbs.gibbs_apply_sparse(*a, **kwa), args.reps)
        mufu = 1e3 * pairs / (MUFU_PER_CLOCK * clock)
        ch = 1 if C == 1 else 4
        kv = math.ceil((x.shape[1] + 1) / 4)
        slots = pair_slots("gibbs_apply_sparse", kv, ch)
        floor = issue_ms(slots * math.ceil(C / ch), pairs, clock)
        applies.append({"ms": t, "C": C, "p": p, "kind": kind, "tile": (bn, bm), "kept_tile_pairs": kept,
                        "pairs": pairs, "row_mean": mean, "row_max": most, "rows_at_width": at_cap,
                        "width": cols.shape[1], "mufu_bound_ms": mufu * math.ceil(C / ch), "issue_floor_ms": floor})
        print(f"[sparse] apply {k}: {t:.3f} ms (CUDA events, {args.reps} reps); p={p} {kind} C={C}, tiles {bn}x{bm}, "
              f"table {tuple(cols.shape)}, {kept} kept tile pairs ({pairs:.4g} pairs), kept tiles per row mean "
              f"{mean:.2f} max {most}, {at_cap} rows at the width; MUFU bound {mufu * math.ceil(C / ch):.3f} ms, "
              f"issue floor {floor:.3f} ms ({slots} slots per pair and launch); card {card}", flush=True)
    del rec
    modes = sparse_modes(torch, mods, args, card)
    res = {"root": args.root, "report": "sparse", "n": n, "dim": args.dim, "loss": v.item(), "applies": applies,
           "modes_1e5": modes,
           "wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall, "device_launches": n_launch,
           "device_ms_by_kernel": {k: round(val[0], 4) for k, val in by_kernel.items()},
           "device_launches_by_kernel": {k: val[1] for k, val in by_kernel.items()}, "card": card}
    print(f"[sparse] gaussian multiscale N=M={n}: profiled wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"{100 * (1 - busy / wall):.1f} %; card {card}", flush=True)
    print(json.dumps(res), flush=True)
    del x0, y0
    torch.cuda.empty_cache()


def sparse_modes(torch, mods, args, card, n=100_000):
    """Kernel 8 at every weight kind (p = 2 gibbs, p = 1 gibbs, gibbs_grad,
    energy, inv_dist), C = 1 and 4, on the xy table of the gaussian MMD's
    truncated route at ``n`` points: ``{label: ms}``."""
    SamplesLoss, ks, cbs = mods["SamplesLoss"], mods["ks"], mods["cbs"]
    dev = torch.device("cuda")
    loss = SamplesLoss("gaussian", blur=0.1, truncate=3, backend="multiscale")
    x0 = torch.from_numpy(sphere_cloud(n, 0, args.dim)).to(dev)
    y0 = torch.from_numpy(sphere_cloud(n, 1, args.dim)).to(dev)
    with recording(ks, ("kernel_matvec_sparse",)) as rec, torch.no_grad():
        loss(x0, y0)
    a, kwa = rec["kernel_matvec_sparse"][2]  # the xy product
    xs, ys, v, mask, tile = a[0], a[1], a[2], a[4], kwa["block"]
    zx, zy = torch.zeros_like(xs[:, 0]), torch.zeros_like(ys[:, 0])
    out = {}
    for p, kind in ((2, "gibbs"), (1, "gibbs"), (1, "gibbs_grad"), (1, "energy"), (1, "inv_dist")):
        for V in (v[:, None], v[:, None] * torch.cat([torch.ones_like(ys[:, :1]), ys], 1)):
            call = (xs, ys, zx, zy, V, 0.1**p, mask.cols, mask.counts, p, kind, tile, tile)
            label = f"p={p} {kind} C={V.shape[1]}"
            out[label] = event_ms(lambda: cbs.gibbs_apply_sparse(*call), args.reps)
            print(f"[sparse] N=M={n} mask_xy {label}: {out[label]:.3f} ms (CUDA events, {args.reps} reps); card {card}",
                  flush=True)
    return out


def host_ms(torch, fn, reps):
    """Host-clock ms per call of ``fn`` (each ending in a synchronize),
    after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def online_report(torch, mods, args, card, clock):
    """Kernels 3 and 4 alone at 1e5 and at D = 32, kernel 8's modes, and the
    MMD calls at 1e5 that run kernels 4 and 8."""
    SamplesLoss, ck = mods["SamplesLoss"], mods["ck"]
    dev = torch.device("cuda")
    res = {"root": args.root, "report": "online", "card": card}
    for n, dim in ((100_000, args.dim), (10_000, 32)):
        x0 = torch.from_numpy(sphere_cloud(n, 0, dim)).to(dev)
        y0 = torch.from_numpy(sphere_cloud(n, 1, dim)).to(dev)
        la = torch.full((n,), -math.log(n), device=dev)
        z = torch.zeros(n, device=dev)
        kv2, kv1 = math.ceil((dim + 1) / 4), math.ceil(dim / 4)
        key = f"n{n}_d{dim}"
        # Kernel 3: the debias step of the online call (p = 2, eps = blur^2).
        eps = 0.05**2
        call = lambda: ck.sinkhorn_step_sym(x0, z, la, eps, 2)  # noqa: E731
        pairs = n * (n + 1) // 2
        k3 = {"ms": event_ms(call, args.reps), "wall_ms": host_ms(torch, call, args.reps),
              "mufu_bound_ms": 1e3 * pairs / (MUFU_PER_CLOCK * clock),
              "issue_floor_ms": issue_ms(pair_slots("sinkhorn_step_sym", kv2), pairs, clock)}
        print(f"[online] sinkhorn_step_sym N={n} D={dim} p=2: {k3['ms']:.3f} ms (CUDA events), {k3['wall_ms']:.3f} ms "
              f"(host clock), MUFU bound {k3['mufu_bound_ms']:.3f} ms, issue floor {k3['issue_floor_ms']:.3f} ms "
              f"({pair_slots('sinkhorn_step_sym', kv2)} slots per pair); card {card}", flush=True)
        res[f"sinkhorn_step_sym_{key}"] = k3
        # Kernel 4 in each mode; at D = 32 in mode 0 at C = 1 + D, as in the backward.
        pairs = n * n
        modes = ((0, 2, "gibbs"), (1, 1, "gibbs"), (2, 1, "gibbs_grad"), (3, 1, "energy"), (4, 1, "inv_dist"))
        ones_y = torch.cat([torch.ones_like(y0[:, :1]), y0], 1)
        for mode, p, kind in modes if dim <= 3 else modes[:1]:
            phi = -ck.lse(x0, y0, la, 0.05**p, p)
            for V in (ones_y[:, :1], ones_y[:, :4]) if dim <= 3 else (ones_y,):
                C = V.shape[1]
                t = event_ms(lambda: ck.gibbs_apply(x0, y0, phi, la, V, 0.05**p, p, kind), args.reps)
                ch = 1 if C == 1 else 4
                kv = kv2 if mode == 0 else kv1
                groups = math.ceil(C / ch)
                floor = (issue_ms(pair_slots("gibbs_apply", kv, ch, mode) * groups, pairs, clock)
                         if mode in (0, 3, 4) else None)
                entry = {"ms": t, "C": C, "mufu_bound_ms": 1e3 * pairs * groups / (MUFU_PER_CLOCK * clock),
                         "issue_floor_ms": floor}
                res[f"gibbs_apply_{key}_mode{mode}_C{C}"] = entry
                print(f"[online] gibbs_apply N=M={n} D={dim} mode {mode} (p={p} {kind}) C={C}: {t:.3f} ms (CUDA "
                      f"events), MUFU bound {entry['mufu_bound_ms']:.3f} ms (one MUFU op per pair and group), issue "
                      f"floor {'not counted' if floor is None else f'{floor:.3f} ms'}; card {card}", flush=True)
        del x0, y0, la, z
        torch.cuda.empty_cache()
    res["kernel8_modes_1e5"] = sparse_modes(torch, mods, args, card)
    n = 100_000
    x0 = torch.from_numpy(sphere_cloud(n, 0, args.dim)).to(dev)
    y0 = torch.from_numpy(sphere_cloud(n, 1, args.dim)).to(dev)
    for label, kw in (("energy", dict(loss="energy", blur=0.1)),
                      ("gaussian online", dict(loss="gaussian", blur=0.1, backend="online")),
                      ("laplacian multiscale", dict(loss="laplacian", blur=0.1, truncate=3, backend="multiscale"))):
        loss = SamplesLoss(**kw)
        call = lambda: value_and_grad(lambda x: loss(x, y0), x0)  # noqa: E731
        wall_h = host_ms(torch, call, args.reps)
        wall, busy, n_launch, rows = profile_busy_ms(call, top=None)
        by_kernel = kernel_times(rows)
        res[f"mmd {label}"] = {"host_ms": wall_h, "wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
                               "device_launches": n_launch,
                               "device_ms_by_kernel": {k: round(v[0], 4) for k, v in by_kernel.items()},
                               "device_launches_by_kernel": {k: v[1] for k, v in by_kernel.items()}}
        print(f"[online] MMD {label} N=M={n}: {wall_h:.3f} ms per call (host clock, {args.reps} reps); profiled wall "
              f"{wall:.3f} ms, device busy {busy:.3f} ms, idle {100 * (1 - busy / wall):.1f} %; card {card}",
              flush=True)
    print(json.dumps(res), flush=True)
    del x0, y0
    torch.cuda.empty_cache()


def lse_report(torch, mods, args, card, clock):
    """Kernel 1 at the shapes of bench.py's call, at 1e5 and in D = 32;
    kernel 7 on the mid path's tables; kernel 9 at 1e5."""
    SamplesLoss, ck, cbs, ks, tbs = mods["SamplesLoss"], mods["ck"], mods["cbs"], mods["ks"], mods["tbs"]
    from geomloss_tpu_torch.solvers.sinkhorn_loop import log_weights

    dev = torch.device("cuda")
    res = {"root": args.root, "report": "lse", "card": card}
    loss = SamplesLoss("sinkhorn", p=2, blur=0.05, diameter=2.0, scaling=0.5)
    kv1 = math.ceil((args.dim + 1) / 4)  # p = 2: a row's last slot carries minus its running max

    def timed(label, name, call, pairs, kv, dense=None):
        """CUDA events around ``reps`` calls (the host's pace where a call
        is short), and the device time of one call (``torch.profiler``:
        its kernels alone, PyTorch's included)."""
        t = event_ms(call, args.reps)
        _, busy, n_launch, _ = profile_busy_ms(lambda: [call() for _ in range(args.reps)], top=None)
        slots = pair_slots(name, kv)
        e = {"ms": t, "device_ms": busy / args.reps, "device_launches": n_launch / args.reps, "pairs": pairs,
             "mufu_bound_ms": 1e3 * pairs / (MUFU_PER_CLOCK * clock), "issue_floor_ms": issue_ms(slots, pairs, clock),
             "slots": slots}
        if dense is not None:
            e["dense_pytorch_ms"] = event_ms(dense, args.reps)
        res[label] = e
        print(f"[lse] {label}: {t:.4f} ms (CUDA events, {args.reps} reps), device {e['device_ms']:.4f} ms in "
              f"{e['device_launches']:g} launches (torch.profiler), MUFU bound {e['mufu_bound_ms']:.4f} ms, issue floor "
              f"{e['issue_floor_ms']:.4f} ms ({slots} slots per pair)"
              + (f", dense PyTorch logsumexp over cdist {e['dense_pytorch_ms']:.4f} ms" if dense else "")
              + f"; card {card}", flush=True)

    tables7 = []
    for n in sorted({100_000, max(args.sizes)}):
        x0 = torch.from_numpy(sphere_cloud(n, 0, args.dim)).to(dev)
        y0 = torch.from_numpy(sphere_cloud(n, 1, args.dim)).to(dev)
        value_and_grad(lambda x: loss(x, y0), x0)
        with recording(ck, ("lse",)) as rec, recording(cbs, ("lse_tiles",)) as rec7:
            value_and_grad(lambda x: loss(x, y0), x0)
        torch.cuda.synchronize()
        # Kernel 1's device time in one call (its kernels and merges), and
        # the call's busy and idle share.
        wall, busy, n_launch, rows = profile_busy_ms(lambda: value_and_grad(lambda x: loss(x, y0), x0), top=None)
        k1 = {k: v for k, v in kernel_times(rows).items() if "lse" in k}
        res[f"call_n{n}"] = {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
                             "device_launches": n_launch, "lse_kernels": k1}
        print(f"[lse] bench.py's call N=M={n} profiled: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
              f"{100 * (1 - busy / wall):.1f} %, {n_launch} launches; kernels 1 and 7 (ms, launches) "
              f"{json.dumps(k1)}; card {card}", flush=True)
        shapes = {}
        for a, kw in rec["lse"]:
            key = (a[0].shape[0], a[1].shape[0])
            shapes.setdefault(key, [0, a, kw])[0] += 1
        res[f"lse_calls_n{n}"] = {f"{k[0]}x{k[1]}": v[0] for k, v in shapes.items()}
        print(f"[lse] bench.py's call N=M={n}: kernel-1 calls by shape {json.dumps(res[f'lse_calls_n{n}'])}, "
              f"kernel-7 calls {len(rec7['lse_tiles'])}", flush=True)
        for (N, M), (count, a, kw) in sorted(shapes.items()):
            x, y, h, eps = a[:4]
            p = a[4] if len(a) > 4 else kw.get("p", 2)
            dense = None
            if N * M <= 16384 * 16384:
                dense = lambda x=x, y=y, h=h, eps=eps: torch.logsumexp(  # noqa: E731
                    h[None, :] - torch.cdist(x, y).square() / (2 * eps), dim=1)
            timed(f"lse_{N}x{M}_in_n{n}", "lse", lambda a=a, kw=kw: ck.lse(*a, **kw), N * M, kv1, dense)
        if n == max(args.sizes):
            tables7 = [a for a, _ in rec7["lse_tiles"]]
        del x0, y0, rec, rec7
        torch.cuda.empty_cache()
    # Device kernels of one call at the coarse shape (PyTorch's and kernel 1's).
    x = torch.from_numpy(sphere_cloud(4096, 0, args.dim)).to(dev)
    y = torch.from_numpy(sphere_cloud(4096, 1, args.dim)).to(dev)
    h = torch.full((4096,), -math.log(4096), device=dev)
    for p in (2, 1):
        _, _, n_launch, rows = profile_busy_ms(lambda: ck.lse(x, y, h, 0.05**p, p), top=None)
        res[f"lse_device_launches_p{p}"] = {"launches": n_launch, "kernels": kernel_times(rows)}
        print(f"[lse] one lse call N=M=4096 p={p}: {n_launch} device kernel launches: "
              f"{json.dumps({k: v[1] for k, v in kernel_times(rows).items()})}", flush=True)
    for n, dim in ((100_000, args.dim), (10_000, 32)):
        x = torch.from_numpy(sphere_cloud(n, 0, dim)).to(dev)
        y = torch.from_numpy(sphere_cloud(n, 1, dim)).to(dev)
        h = torch.full((n,), -math.log(n), device=dev)
        timed(f"lse_n{n}_d{dim}", "lse", lambda: ck.lse(x, y, h, 0.05**2, 2), n * n, math.ceil((dim + 1) / 4))
    for k, a in enumerate(tables7):
        kept = int(a[5].clamp(max=a[4].shape[1]).sum())
        timed(f"lse_tiles_extrapolation{k}_n{max(args.sizes)}", "lse_tiles", lambda a=a: cbs.lse_tiles(*a),
              kept * a[6] * a[7], kv1)
    # Kernel 9: softmin_sparse's forward on the uncapped geometry table of
    # the gaussian MMD's truncated route at 1e5.
    n = 100_000
    x0 = torch.from_numpy(sphere_cloud(n, 0, args.dim)).to(dev)
    y0 = torch.from_numpy(sphere_cloud(n, 1, args.dim)).to(dev)
    with recording(ks, ("kernel_matvec_sparse",)) as rec, torch.no_grad():
        SamplesLoss("gaussian", blur=0.1, truncate=3, backend="multiscale")(x0, y0)
    (xs, ys, v, _, mask0), kw = rec["kernel_matvec_sparse"][2]
    aw = rec["kernel_matvec_sparse"][0][0][2]
    tile = kw["block"]
    mask = tbs.masks_from_geometry(xs, ys, 0.3, tile, cap=ys.shape[0] // tile, w_x=aw, w_y=v)
    kept = int(mask.counts.clamp(max=mask.cols.shape[1]).sum())
    a9 = (xs, ys, log_weights(v), 0.01, mask.cols, mask.counts, 2, tile, tile)
    res["lse_sparse_table"] = {"row_tiles": mask.cols.shape[0], "width": mask.cols.shape[1], "kept": kept,
                               "row_max": int(mask.counts.max())}
    timed(f"lse_sparse_n{n}", "lse_sparse", lambda: cbs.lse_sparse(*a9), kept * tile * tile, kv1)
    print(json.dumps(res), flush=True)
    torch.cuda.empty_cache()


def sums_report(torch, mods, args, card, clock):
    """Kernels 12, 10 and 11 and the walk decode on the first fine step's
    xy table of bench.py's call at each size."""
    SamplesLoss, ms, cbs, tbs = mods["SamplesLoss"], mods["ms"], mods["cbs"], mods["tbs"]
    dev = torch.device("cuda")
    loss = SamplesLoss("sinkhorn", p=2, blur=0.05, diameter=2.0, scaling=0.5)
    for n in args.sizes:
        x0 = torch.from_numpy(sphere_cloud(n, 0, args.dim)).to(dev)
        y0 = torch.from_numpy(sphere_cloud(n, 1, args.dim)).to(dev)
        with recording(ms, FINE_CALLS) as rec, torch.no_grad():
            loss(x0, y0)
        st = first_step_state(rec)
        del rec, x0, y0
        e, p, tile, xy = st["e"], st["p"], st["tile"], st["xy"]
        xs, ys = st["xs"], st["ys"]
        phi, psi = st["la"] + st["f"] / e, st["lb"] + st["g"] / e
        width = xy.cols.shape[1]
        tbl = tbs.walk_plan(xy.cols, xy.counts, width)
        nI = xy.cols.shape[0]
        V = torch.cat([torch.ones_like(ys[:, :1]), ys], 1)
        kept, mean, most, at_cap = table_stats(xy.cols, xy.counts)
        pairs = kept * tile * tile
        kv = math.ceil((xs.shape[1] + 1) / 4)
        res = {"root": args.root, "report": "sums", "n": n, "dim": args.dim, "tile": tile, "row_tiles": nI,
               "width": width, "kept_tiles": kept, "row_mean": mean, "row_max": most, "rows_at_width": at_cap,
               "pairs": pairs, "mufu_bound_ms": 1e3 * pairs / (MUFU_PER_CLOCK * clock), "card": card}
        print(f"[sums] N=M={n}: first fine xy table {nI} row tiles of {tile} x width {width}, {kept} kept tiles, "
              f"per row mean {mean:.2f} max {most}, {at_cap} rows at the width; {pairs:.4g} pairs", flush=True)
        calls = {
            "absorbed_sum_sparse": (lambda: cbs.absorbed_sum_sparse(xs, ys, phi, psi, e, xy.cols, xy.counts, p, tile),
                                    pair_slots("absorbed_sum_sparse", kv)),
            "absorbed_sum_walk": (lambda: cbs.absorbed_sum_walk(xs, ys, phi, psi, e, tbl, p, tile),
                                  pair_slots("absorbed_sum_walk", kv)),
            "gibbs_apply_walk": (lambda: cbs.gibbs_apply_walk(xs, ys, phi, psi, V, e, tbl, p, "gibbs", tile, tile),
                                 pair_slots("gibbs_apply_sparse", kv, 4)),
            "walk_rows": (lambda: cbs._walk_rows(tbl, nI), None),
        }
        for name, (call, slots) in calls.items():
            t = event_ms(call, args.reps)
            _, busy, n_launch, rows = profile_busy_ms(lambda: [call() for _ in range(args.reps)], top=None)
            by_kernel = kernel_times(rows)
            entry = {"ms": t, "device_ms": busy / args.reps, "device_launches": n_launch / args.reps,
                     "device_ms_by_kernel": {k: round(v[0] / args.reps, 4) for k, v in by_kernel.items()},
                     "device_launches_by_kernel": {k: v[1] / args.reps for k, v in by_kernel.items()}}
            if slots is not None:
                entry.update(slots=slots, issue_floor_ms=issue_ms(slots, pairs, clock))
            res[name] = entry
            floor = f", issue floor {entry['issue_floor_ms']:.3f} ms ({slots} slots per pair)" if slots else ""
            print(f"[sums] {name} N=M={n}: {t:.4f} ms (CUDA events, {args.reps} reps), device {entry['device_ms']:.4f} "
                  f"ms in {entry['device_launches']:g} launches per call (torch.profiler): "
                  f"{json.dumps(entry['device_launches_by_kernel'])}; MUFU bound {res['mufu_bound_ms']:.3f} ms{floor}; "
                  f"card {card}", flush=True)
        print(json.dumps(res), flush=True)
        del st, xs, ys, phi, psi, tbl, V, calls
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--report", nargs="*", choices=("tiles", "step", "sparse", "online", "lse", "sums"),
                    default=["tiles", "step", "sparse", "online", "lse", "sums"])
    ap.add_argument("--sizes", type=int, nargs="+", default=[100_000, 2_000_000])
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-build-report", action="store_true")
    ap.add_argument("--dump", help="directory for the SASS listings of the kernels read")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_report.py needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.models import kernel_samples as ks
    from geomloss_tpu_torch.models import multiscale as ms
    from geomloss_tpu_torch.ops import block_sparse as tbs
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    card = card_line()
    clock = sm_clock_hz()
    t0 = time.perf_counter()
    libs = [ck.build(), cbs.build()]
    print(f"[build] {', '.join(lib._name for lib in libs)} in {time.perf_counter() - t0:.1f} s (root {args.root})",
          flush=True)
    if not args.no_build_report:
        build_report(libs, args.dump)
    mods = dict(SamplesLoss=SamplesLoss, ms=ms, ks=ks, cbs=cbs, ck=ck, tbs=tbs)
    if "step" in args.report:
        step_report(torch, mods, args, card, clock)
    if "sparse" in args.report:
        sparse_report(torch, mods, args, card, clock)
    if "online" in args.report:
        online_report(torch, mods, args, card, clock)
    if "tiles" in args.report:
        tiles_report(torch, mods, args, card)
    if "lse" in args.report:
        lse_report(torch, mods, args, card, clock)
    if "sums" in args.report:
        sums_report(torch, mods, args, card, clock)


if __name__ == "__main__":
    main()
