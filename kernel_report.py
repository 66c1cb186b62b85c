"""Build report and CUDA-event times of the block-sparse kernels 5 and 6
(``absorbed_sum_tiles``, ``gibbs_apply_tiles``) of geomloss_tpu_torch on
one GPU.

    python3 kernel_report.py [--root DIR] [--sizes 100000 2000000] [--dim 3] [--backend auto]
                             [--reps 3] [--no-build-report]

``--root`` imports the package from another checkout (for example the
parent commit unpacked with ``git archive``), so that two versions can be
compared on one card in one job: run parent, change, change, parent.

Prints, from the build of the block-sparse library:

- each kernel's registers, stack and spills as ``nvcc -Xptxas -v`` gave
  them (the ``.log`` beside the library);
- for kernels 5 and 6 at D = 3 (p = 2, apply mode 0: bench.py's call) and
  kernel 5 at D = 8, the instruction counts of the hot loop of their SASS
  (``cuobjdump -sass``): the innermost loop with the most MUFU
  instructions, by opcode class.

Then, for each size, bench.py's call (``SamplesLoss("sinkhorn", p=2,
blur=0.05, diameter=2.0, scaling=0.5)``, value and gradient in x, two
unit-sphere clouds of seeds 0 and 1, in ``--dim`` dimensions through
``--backend``: ``multiscale`` for a D above 3, which ``auto`` sends to the
online backend) is run once with every kernel 5 and 6 call recorded; each
recorded call is then timed alone (CUDA events, after a warm-up), and so
are both kernels on the first fine step's xy table. The last line of each
size is a JSON object with these times and the card's name and power
limit. Needs a CUDA device.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

from chip_smoke import card_line, event_ms, kernel_label, ptxas_usage, recording, sphere_cloud

#: Opcode classes counted in a hot loop (by the opcode's first field).
SASS_CLASSES = ("MUFU", "SHFL", "LDS", "LDG", "LDL", "STL", "FFMA", "FADD", "FMUL", "FSEL", "SEL", "FMNMX", "FSETP",
                "ISETP", "BAR", "STS")
#: Kernels whose hot loop is read, at bench.py's instantiation: D = 3, p = 2
#: (kernel 6: apply mode 0). Kernels 5 and 6 were templated on <D, P> and
#: <D, MODE> before their register-tiled form, and on <P, KV> (KV float4s
#: per packed point, 0 for the wide form) and <MODE, WIDE> since; kernel 5
#: at p = 2, D = 8 (KV = 3) is read too. In a build of the first form,
#: <2,1> names another instantiation (D = 2, p = 1).
SASS_LABELS = ("tiles_step_kernel<3,2>", "tiles_apply_kernel<3,0>", "tiles_step_kernel<2,1>",
               "tiles_step_kernel<2,3>", "tiles_apply_kernel<0,0>")


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
    """The loop (a backward branch and its target) with the most MUFU
    instructions, the shortest of those: ``(start, end, [opcodes])``, or
    None. Per pass of a register-tiled pair block, that is the pass."""
    best = None
    for addr, op, rest in instrs:
        m = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) <= addr:
            s, e = int(m.group(1), 16), addr
            ops = [o for a, o, _ in instrs if s <= a <= e]
            key = (sum(o.startswith("MUFU") for o in ops), -len(ops))
            if best is None or key > best[0]:
                best = (key, (s, e, ops))
    return best[1] if best else None


def loop_counts(ops):
    """Instruction counts of a loop body by opcode class, and its total."""
    counts = {c: 0 for c in SASS_CLASSES}
    for op in ops:
        base = op.split(".")[0]
        if base in counts:
            counts[base] += 1
    counts["total"] = len(ops)
    return counts


def build_report(lib, dump=None):
    """Print the ptxas usage of every kernel of a built library and the hot
    loops of kernels 5 and 6 (their SASS listings written under ``dump``,
    if given); returns ``(ptxas usage, hot-loop counts)``."""
    so = lib._name
    log = open(os.path.splitext(so)[0] + ".log").read()
    usage = ptxas_usage(log)
    for name, u in sorted(usage.items()):
        print(f"[ptxas] {name}: {u}", flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = sass_functions(subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout)
    loops = {}
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
    return usage, loops


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--sizes", type=int, nargs="+", default=[100_000, 2_000_000])
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-build-report", action="store_true")
    ap.add_argument("--dump", help="directory for the SASS listings of kernels 5 and 6")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_report.py needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.models import multiscale as ms
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    card = card_line()
    t0 = time.perf_counter()
    ck.build()
    lib = cbs.build()
    print(f"[build] {lib._name} in {time.perf_counter() - t0:.1f} s (root {args.root})", flush=True)
    if not args.no_build_report:
        build_report(lib, args.dump)

    dev = torch.device("cuda")
    loss = SamplesLoss("sinkhorn", p=2, blur=0.05, diameter=2.0, scaling=0.5, backend=args.backend)
    names = ("absorbed_sum_tiles", "gibbs_apply_tiles")
    for n in args.sizes:
        x0 = torch.from_numpy(sphere_cloud(n, 0, args.dim)).to(dev).requires_grad_(True)
        y0 = torch.from_numpy(sphere_cloud(n, 1, args.dim)).to(dev)
        with recording(cbs, names) as rec, recording(ms, ("sinkhorn_step_walk_banded",)) as rec_ms:
            (g,) = torch.autograd.grad(loss(x0, y0), x0)
        torch.cuda.synchronize()
        res = {"root": args.root, "n": n, "dim": args.dim, "backend": args.backend, "card": card}
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


if __name__ == "__main__":
    main()
