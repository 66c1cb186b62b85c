"""Phase breakdown of the PyTorch port's multiscale backend at 1M-4M points:
the twin of ``tools/profile_phases_r4.py`` on an NVIDIA GPU.

Times each phase of the cascade that ``SamplesLoss("sinkhorn", p=2,
blur=0.05, diameter=2.0, scaling=0.5, backend="multiscale")`` runs on
bench.py's clouds, from outside: one loss + gradient call records the
inputs (and results) of the module's own functions, and each phase is then
that function called once more on them, between two CUDA events (the
host clock on the CPU). Nothing in ``models/multiscale.py`` changes. Phases:

  full                 loss + gradient, the whole call (after a warm-up)
  sort_one_cloud       spatial_sort_blocks, one cloud (x2 in the solve)
  prologue             multiscale_prologue: sorts, coarse phase, mid phase,
                       the extrapolation onto the fine clouds and the tables
  coarse_phase         the coarse annealing iterations (the first _iterate)
  run_mid_phase        the pooled intermediate scale (above 2^20 points)
  extrap_to_fine       the four extrapolations onto the fine clouds
                       (_extrapolate: kernel 7 on the mid path, else kernel 1)
  tables               the truncation tables (_mid_tables on the mid path,
                       else _coarse_tables), with their kept tiles per row
  kept_stats_cap128    the mid path's xy table rebuilt at cap=128: kept
                       tiles per row against mid_cap (the rows that keep
                       as many or more, which widen the table past it)
  fine_tables          fine_tables: each fine temperature's slices and
                       re-thresholded counts of the three tables
  fine_steps           the truncated fine iterations (the last _iterate over
                       _truncated_fine_phase's step), with each step's time
  last_extrap_fwd      the differentiable last extrapolation, forward
  last_extrap_fwd_bwd  the same, forward and backward (the gradient in x)

The TPU script's ``extrap_dense_one_sweep`` and ``dense_pair_step`` (K = 18
against K = 3 bf16 splits) time TPU workarounds the port does not have.
Each re-run phase that returns the solve's own tensors says whether they
came out bitwise equal (``same_as_solve``). One JSON row per phase and
size on stdout; with ``--out FILE`` the rows also go to a new JSONL file
(the TPU rows of ``PROFILE_PHASES.jsonl`` stay as they are):

    PYTHONPATH=. python tools/profile_phases_torch.py [--out FILE]

It runs on the card and fails without one; :func:`profile` also takes the
CPU.
"""

import argparse
import contextlib
import json
import time

import torch

from bench_torch import card_line, device_of, loss_and_grad, sphere_cloud
from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.models import multiscale as ms
from geomloss_tpu_torch.ops.block_sparse import build_tile_masks

SIZES = (1_000_000, 2_000_000, 4_000_000)
#: The phases, in the order of their rows; ``MID_ONLY`` exist on the mid
#: path alone (above ``multiscale.N_FINE_OK`` points).
PHASES = ("full", "sort_one_cloud", "prologue", "coarse_phase", "run_mid_phase", "extrap_to_fine", "tables",
          "kept_stats_cap128", "fine_tables", "fine_steps", "last_extrap_fwd", "last_extrap_fwd_bwd")
MID_ONLY = ("run_mid_phase", "kept_stats_cap128")
CALL = dict(p=2, blur=0.05, diameter=2.0, scaling=0.5)
#: The functions of models/multiscale.py whose calls the phases re-run.
RECORDED = ("spatial_sort_blocks", "multiscale_prologue", "_iterate", "run_mid_phase", "_extrapolate",
            "_mid_tables", "_coarse_tables", "_truncated_fine_phase")
#: Width of the kept-tile statistics' table (the TPU script's roomy cap).
WIDE_CAP = 128


@contextlib.contextmanager
def recorded(module, names):
    """Yields ``{name: [(args, kwargs, result), ...]}`` of every call to
    ``module.<name>`` in the block (the calls go through unchanged)."""
    rec = {name: [] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def wrap(name):
        def call(*args, **kwargs):
            r = saved[name](*args, **kwargs)
            rec[name].append((args, kwargs, r))
            return r

        return call

    for name in names:
        setattr(module, name, wrap(name))
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def one_call(fn, dev):
    """``(fn(), ms, host_ms)``: one call between two CUDA events (the host
    clock on the CPU), and the host clock around it."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        host = (time.perf_counter() - t0) * 1e3
        return out, host, host
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def same(a, b):
    """Two (nested tuples of) tensors bitwise equal."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(u, v) for u, v in zip(a, b))
    return a == b


def kept(counts, cap):
    c = counts.float()
    return dict(kept_mean=c.mean().item(), kept_max=int(counts.max()), rows_at_cap=int((counts >= cap).sum()),
                cap=int(cap))


def rerun(rec, name, index=0):
    """Call the recorded ``index``-th call of ``name`` again."""
    args, kwargs, _ = rec[name][index]
    return getattr(ms, name)(*args, **kwargs)


def profile(n, dev, card, emit):
    """Every phase at ``n`` points: one row each through ``emit(**row)``."""
    x = torch.from_numpy(sphere_cloud(n, 0)).to(dev)
    y = torch.from_numpy(sphere_cloud(n, 1)).to(dev)
    loss = SamplesLoss("sinkhorn", **CALL, backend="multiscale")

    def row(phase, ms_, host_ms, **kw):
        emit(N=n, phase=phase, ms=ms_, host_ms=host_ms, **kw, clock="cuda events" if dev.type == "cuda" else "host",
             device=card)

    with recorded(ms, RECORDED) as rec:
        loss_and_grad(loss, x, y)  # the warm-up, and the phases' inputs
    (v, g), t, h = one_call(lambda: loss_and_grad(loss, x, y), dev)
    row("full", t, h, loss=v.item(), grad_finite=bool(torch.isfinite(g).all()))
    pro = rec["multiscale_prologue"][0][2]
    mid = bool(rec["run_mid_phase"])

    _, t, h = one_call(lambda: rerun(rec, "spatial_sort_blocks"), dev)
    row("sort_one_cloud", t, h, n_pad=pro.x_s.shape[0], tile=pro.tile, block_size=pro.block_size,
        note="x2 in the solve")
    _, t, h = one_call(lambda: rerun(rec, "multiscale_prologue"), dev)
    row("prologue", t, h, mid_path=mid, jump_eps=pro.eps_j, eps_fine=pro.eps_fine)
    with torch.no_grad():
        out, t, h = one_call(lambda: rerun(rec, "_iterate", 0), dev)
        row("coarse_phase", t, h, same_as_solve=same(out, rec["_iterate"][0][2]), coarse_points=pro.x_c.shape[0])
        if mid:
            out, t, h = one_call(lambda: rerun(rec, "run_mid_phase"), dev)
            row("run_mid_phase", t, h, same_as_solve=same(out, rec["run_mid_phase"][0][2]),
                mid_points=out[1].shape[0])
        last = len(rec["_extrapolate"]) - 1  # onto the fine clouds (the first, coarse -> mid, on the mid path)
        out, t, h = one_call(lambda: rerun(rec, "_extrapolate", last), dev)
        row("extrap_to_fine", t, h, same_as_solve=same(out, rec["_extrapolate"][last][2]))

        builder = "_mid_tables" if mid else "_coarse_tables"
        masks, t, h = one_call(lambda: rerun(rec, builder), dev)
        row("tables", t, h, builder=builder, same_as_solve=same(masks, rec[builder][0][2]),
            **kept(masks[0].counts, masks[0].cols.shape[1]))
        if mid:
            x_sd, y_sd, a_w, b_w, fine, eps_b, p, truncate, tile, cap_m = rec["_mid_tables"][0][0][:10]
            eps_min = rec["_mid_tables"][0][1].get("eps_min")
            if cap_m is None:
                cap_m = ms.mid_cap(x_sd.shape[0], tile)
            wide, t, h = one_call(lambda: build_tile_masks(x_sd, y_sd, fine[0], fine[1], eps_b, p, truncate, tile,
                                                           cap=WIDE_CAP, w_x=a_w, w_y=b_w, eps_min=eps_min), dev)
            c = wide.counts
            row("kept_stats_cap128", t, h, mean=c.float().mean().item(),
                p99=float(torch.quantile(c.float(), 0.99)), max=int(c.max()),
                rows_at_mid_cap=int((c >= cap_m).sum()), cap=int(cap_m))

    fargs = rec["_truncated_fine_phase"][0][0]
    masks, eps_m, x_s, y_s, a_log_f, b_log_f, eps_fine, p, truncate = fargs[:9]
    with torch.no_grad():
        def slice_all():
            table = ms.fine_tables(masks[0], eps_m, eps_fine, truncate)
            return [table(m, e) for e in eps_fine for m in masks if m is not None]

        _, t, h = one_call(slice_all, dev)
        row("fine_tables", t, h, temperatures=len(eps_fine), tables=sum(m is not None for m in masks))

        step = rec["_truncated_fine_phase"][0][2][0]
        k = next(i for i, (args, _, _) in enumerate(rec["_iterate"]) if args[0] is step)
        args_k, _, fine_out = rec["_iterate"][k]
        out, t, h = one_call(lambda: rerun(rec, "_iterate", k), dev)
        per_eps = [one_call(lambda e=e: step(e, *args_k[1]), dev)[1] for e in eps_fine]
        row("fine_steps", t, h, same_as_solve=same(out, fine_out), eps=eps_fine, per_eps_ms=per_eps)

    # The last extrapolation on a fresh leaf (the solve's graph is spent),
    # differentiated in x alone, as the solve is.
    xs = x_s.detach().requires_grad_(True)
    _, extrap = ms._truncated_fine_phase(masks, eps_m, xs, y_s.detach(), *fargs[4:])
    eps_last = pro.eps_list[-1]
    a_s, b_s = pro.a_s.detach(), pro.b_s.detach()

    def fwd():
        return extrap(eps_last, *fine_out)

    def fwd_bwd():
        S_xy, S_yx, S_xx, S_yy = fwd()
        total = (a_s * S_xy).sum() + (b_s * S_yx).sum()
        if S_xx is not None:
            total = total + (a_s * S_xx).sum() + (b_s * S_yy).sum()
        return torch.autograd.grad(total, xs)

    _, t, h = one_call(fwd, dev)
    row("last_extrap_fwd", t, h)
    _, t, h = one_call(fwd_bwd, dev)
    row("last_extrap_fwd_bwd", t, h)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the rows to this new JSONL file")
    args = ap.parse_args()
    dev = device_of("cuda")
    card = card_line(dev)
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "w")) if args.out else None

        def emit(**row):
            line = json.dumps(row)
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()

        for n in SIZES:
            profile(n, dev, card, emit)
            if dev.type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
