"""One run of one cell: set-up, a closed loop of loss + gradient calls for
``--seconds``, the comparison with the reference, one result line.

The program under test is ``geomloss_tpu_torch``: the window drives the
public entry that the cell's configuration names (``"entry"``: the
callable, built from ``"call"``, its inputs in order and the one the
gradient is taken in; ``SamplesLoss.__call__`` for every configuration so
far) and autograd's backward through it, as a training loop does (one
caller, each call waiting for the last). Everything else here (the inputs,
the spans, the trace's reading, the reference and the comparison) is the
benchmark's own.
"""

import argparse
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

from . import guard, trace as tracing
from .layout import Layout


class ForbiddenModules(RuntimeError):
    """A module of JAX or of the JAX package was loaded in the process."""


def process_age_s():
    """Seconds since this process started, from ``/proc`` (to 10 ms)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def smi(fields):
    """``nvidia-smi``'s reading of ``fields`` for the first card, or
    ``None`` where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(fn, args, wrt, rows, seconds, device, traced):
    """The closed loop: calls until ``seconds`` of host clock have passed.
    Returns each call's value and compared gradient rows (copied to the
    host between calls, so that the device's peak is the program's), its
    host-clock seconds, and, traced, its forward and backward spans."""
    import torch

    values, grads, times, fwd, bwd = [], [], [], [], []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        v = fn(*args)
        if traced:
            _sync(device)
            t1 = time.perf_counter()
        (g,) = torch.autograd.grad(v, args[wrt])
        _sync(device)
        t2 = time.perf_counter()
        values.append(v.detach().cpu())
        grads.append(g.index_select(0, rows).cpu())
        del v, g
        times.append(t2 - t0)
        if traced:
            fwd.append(t1 - t0)
            bwd.append(t2 - t1)
        if t2 - start >= seconds:
            return values, grads, times, t2 - start, fwd, bwd


def _finite(v):
    return v if v is not None and math.isfinite(v) else None


#: The numbers a run can compare; a cell's limits file names those it does.
NUMBERS = ("loss_rel", "grad_rel")


def judge(values, grads, ref_value, ref_grad, limits):
    """Each call's value against the reference's (``loss_rel``, relative
    error) and its gradient rows (``grad_rel``, relative L2 error over the
    rows). Returns ``(failed, checks, worst)``: the calls outside the limit
    of a number that the cell compares (or not finite), each compared
    number, the worst over the calls, beside its limit, and the worst of
    every number, compared or not."""
    import torch

    v = torch.stack(values).double().cpu()
    G = torch.stack(grads).double()
    R = ref_grad.to(G.device, torch.float64)
    per_call = {
        "loss_rel": (v - ref_value).abs() / abs(ref_value),
        "grad_rel": ((G - R[None]).flatten(1).norm(dim=1) / R.norm()).cpu(),
    }
    ok = torch.ones(v.shape[0], dtype=torch.bool)
    checks = {}
    for name in NUMBERS:
        if name in limits:
            limit = limits[name]["limit"]
            ok &= per_call[name] <= limit  # NaN compares false
            checks[name] = {"value": _finite(float(per_call[name].max())), "limit": limit}
    worst = {name: _finite(float(x.max())) for name, x in per_call.items()}
    return int((~ok).sum()), checks, worst


#: Calls before the window: each shape of the cell warmed up, every kernel
#: built and loaded.
WARMUP_CALLS = 2

#: Gradient rows (drawn from the seed) that each call hands the comparison.
CHECK_ROWS = 16384


class Prepared:
    """A cell's set-up: its description, the entry built from its
    configuration, the inputs drawn from the seed, and the gradient rows
    compared."""

    def __init__(self, lay, cell_name, seed, device):
        import torch

        self.cell = lay.cell(cell_name)
        self.config = lay.config(self.cell["config"])
        self.traffic = lay.traffic(self.cell["traffic"])
        self.limits = lay.limits(cell_name)
        self.call = dict(self.config["call"], **self.traffic.get("call", {}))
        self.device = device
        entry = self.config["entry"]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        self.inputs = lay.clouds(self.traffic["clouds"])(self.traffic, gen, getattr(torch, self.config["dtype"]), device)
        self.grad_input = entry["grad"]
        n = self.inputs[self.grad_input].shape[0]
        self.rows = torch.randperm(n, generator=gen, device=device)[:CHECK_ROWS]
        self.compute_reference = lay.reference(self.config["reference"])
        module, attr = entry["callable"].split(":")
        self.fn = getattr(importlib.import_module(module), attr)(**self.call)
        # The program's arguments: the inputs, the one differentiated a leaf
        # of its own.
        self.args = [
            self.inputs[k].detach().clone().requires_grad_(True) if k == self.grad_input else self.inputs[k]
            for k in entry["inputs"]
        ]
        self.wrt = entry["inputs"].index(self.grad_input)

    def warm_up(self):
        import torch

        for _ in range(WARMUP_CALLS):
            v = self.fn(*self.args)
            torch.autograd.grad(v, self.args[self.wrt])
            del v
        _sync(self.device)

    def free_program(self):
        """Drops the program's entry and arguments (the inputs stay)."""
        import torch

        del self.fn, self.args
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, **kw):
        """The reference's value and gradient rows, and its seconds."""
        _sync(self.device)
        t0 = time.perf_counter()
        value, grad = self.compute_reference(self.inputs, self.call, self.rows, **kw)
        _sync(self.device)
        return value, grad, time.perf_counter() - t0


def run_cell(lay, cell_name, seed, seconds, traced, device, control=False):
    """One run of a cell on ``device``. Returns ``(result, lines,
    readings)``: the result's dict, the lines that name each compared
    number beside its limit, and the readings that limits are set from
    (every number's worst over the calls, the reference's seconds, and with
    ``control`` the control's numbers: the reference computed in float32
    with TF32 products, put in the program's place). Raises
    :class:`ForbiddenModules` if JAX was loaded by the time the window
    closed."""
    import torch

    cuda = device.type == "cuda"
    cell = Prepared(lay, cell_name, seed, device)
    cell.warm_up()
    setup_s = process_age_s()

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU])
        prof.__enter__()
    try:
        values, grads, times, window_s, fwd, bwd = _window(
            cell.fn, cell.args, cell.wrt, cell.rows, seconds, device, traced
        )
    finally:
        if prof is not None:
            with warnings.catch_warnings():
                # (that a profiler without a schedule keeps one cycle's events)
                warnings.simplefilter("ignore", UserWarning)
                prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    found = guard.forbidden_modules()
    if found:
        raise ForbiddenModules(", ".join(found))

    calls = len(times)
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.cell["chips"],
        "memory_peak_bytes": peak,
    }
    metrics, breakdown = {}, None
    if traced:
        events = tracing.device_events(prof) if cuda else []
        del prof
        clock = smi("clocks.max.sm") if cuda else None
        traffic = cell.traffic
        tr = tracing.Trace(
            calls, window_s, fwd, bwd, events,
            tracing.port_kernel_names(lay.root / "geomloss_tpu_torch" / "csrc"),
            cell.call, (traffic["n"], traffic["m"], traffic["dim"]), device_info["kind"],
            float(clock[0]) * 1e6 if clock else None,
        )
        for m in lay.per_layer(cell_name):
            value = lay.reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s() / cell.cell["chips"], window_s=window_s)
        breakdown = {"device_ops": tracing.top_ops(events), "idle_gaps": tracing.idle_gaps(events)}
    else:
        ms = [1e3 * t for t in times]
        e2e = {
            "ms_per_call": 1e3 * window_s / calls,
            "p90_ms": statistics.quantiles(ms, n=10)[-1] if calls > 1 else ms[0],
            "peak_mem_gb": peak / 1e9 if peak is not None else None,
            "setup_s": setup_s,
        }
        for m in lay.end_to_end(cell_name):
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    limit = smi("power.limit") if cuda else None
    if limit:
        device_info["power_limit_w"] = float(limit[0])

    # The program's state is freed before the reference runs (in blocks,
    # on the same device); the peak was read before it.
    cell.free_program()
    ref_value, ref_grad, ref_s = cell.reference()
    failed, checks, worst = judge(values, grads, ref_value, ref_grad, cell.limits)
    readings = {"worst": worst, "reference_s": ref_s, "reference_value": ref_value}
    if control:
        c_value, c_grad, c_s = cell.reference(dtype=torch.float32, tf32=True)
        c_failed, _, c_worst = judge([torch.tensor(c_value)], [c_grad], ref_value, ref_grad, cell.limits)
        readings.update(control=c_worst, control_correct=c_failed == 0, control_s=c_s)
    found = guard.forbidden_modules()
    if found:
        raise ForbiddenModules(", ".join(found))

    result = {
        "correct": failed == 0 and calls > 0,
        "attempted": calls,
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = [f"{k} {v!r} (not compared in this cell)" for k, v in worst.items() if k not in checks]
    lines += [f"{k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines, readings


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once and print its result line.")
    ap.add_argument("--workload", required=True, help="the cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: per-layer metrics from a traced window")
    return ap.parse_args(argv)


def main(argv=None):
    """The command line: one run on the card. Exits with 2, printing no
    result, where the card or the cards the cell asks for are missing, and
    with 3 where JAX was loaded."""
    args = parse_args(argv)
    lay = Layout()
    cell = lay.cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"benchmark: cell {args.workload} needs {cell['chips']} CUDA device(s); found {have}", file=sys.stderr)
        return 2
    # (PyTorch's default, held: the configurations state float32 without TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        result, lines, _ = run_cell(lay, args.workload, args.seed, args.seconds, bool(args.trace),
                                 torch.device("cuda", 0))
    except ForbiddenModules as e:
        print(f"benchmark: JAX modules loaded in the run's process: {e}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
