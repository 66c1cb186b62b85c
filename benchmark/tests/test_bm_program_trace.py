"""The readers of the per-layer metrics that read inside the program: its
spans and counters (``geomloss_tpu_torch.utils.profiling``) beside the
traced window's device events.

A synthetic window with known spans, counts and device events gives each
metric its value by hand; a window the program recorded on the CPU gives
the idle inside its spans and outside them, which add up to the window's
idle; a program without the recorder, or a window it recorded nothing in,
gives no value.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.layout import Layout
from benchmark.metrics import _program_trace as pt
from benchmark.trace import Trace, union_ns
from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.utils import profiling
from geomloss_tpu_torch.utils.profiling import Span

#: The metrics of this file, each with the cells it lists.
METRICS = {
    "device.idle_in_port_ms": {"gaussian.sphere-1e6", "sinkhorn.online-1e5"},
    "solver.eps_loop_idle_ms": {"sinkhorn.online-1e5"},
    "multiscale.tables_idle_ms": {"gaussian.sphere-1e6"},
    "host.reads_per_call": {"gaussian.sphere-1e6", "sinkhorn.online-1e5"},
    "tables.kept_tiles_per_row": {"gaussian.sphere-1e6"},
    "kernels.gpairs_per_call": {"gaussian.sphere-1e6", "sinkhorn.online-1e5"},
    "kernels.port_launches_per_call": {"gaussian.sphere-1e6", "sinkhorn.online-1e5"},
}

MS = 1_000_000  # ns


def _trace(calls, events):
    return Trace(calls, 1.0, [], [], events, set(), {}, (1, 1, 3), "cpu", None)


@pytest.fixture
def lay():
    return Layout()


def _window(monkeypatch, spans, counts):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    monkeypatch.setattr(profiling, "counts", lambda by_call=False: dict(counts))


def test_the_entries_list_their_cells(lay):
    layers = {m["layer"] for m in lay.spec["per_layer"] if m["name"] not in METRICS}
    for m in lay.spec["per_layer"]:
        if m["name"] in METRICS:
            assert set(m["workloads"]) == METRICS[m["name"]] and m["source"] == "device_trace"
            assert m["layer"] in layers and m["moves"] == "ms_per_call"


def test_a_synthetic_window_by_hand(lay, monkeypatch):
    # Two calls. Call 1: loss [0, 10] ms, its eps loop [2, 8], its tables
    # [1, 2], its backward [12, 15] on another thread; call 2: loss [20, 30]
    # with an eps loop [21, 29].
    spans = [
        Span("multiscale.tables", 1 * MS, 2 * MS, 0, 1, 1, 1),
        Span("solver.eps_loop", 2 * MS, 8 * MS, 0, 1, 1, 2),
        Span("loss", 0, 10 * MS, None, 1, 1, 0),
        Span("backward.X", 12 * MS, 15 * MS, None, 1, 2, 3),
        Span("solver.eps_loop", 21 * MS, 29 * MS, 4, 2, 1, 5),
        Span("loss", 20 * MS, 30 * MS, None, 2, 1, 4),
    ]
    # Device busy [0.5, 1.5], [3, 7], [9, 13], [22, 30] ms.
    events = [("k", 0.5 * MS, 1.5 * MS), ("k", 3 * MS, 7 * MS), ("k", 9 * MS, 13 * MS), ("k", 22 * MS, 30 * MS)]
    counts = {"host.reads": 6, "tables.kept_tiles": 90, "tables.row_tiles": 30, "kernels.pairs": 5e9,
              "kernels.launches.lse": 3, "kernels.launches.gibbs_apply": 5, "tables.other": 1}
    _window(monkeypatch, spans, counts)
    tr = _trace(2, events)
    read = {name: lay.reader(name)(tr) for name in METRICS}
    # Idle under some span: [0, 10] less 1 + 4 + 1 busy = 4; [12, 15] less
    # 1 = 2; [20, 30] less 8 = 2; 8 ms over 2 calls.
    assert read["device.idle_in_port_ms"] == pytest.approx(4.0)
    # Eps loops: [2, 8] less 4 = 2; [21, 29] less 7 = 1.
    assert read["solver.eps_loop_idle_ms"] == pytest.approx(1.5)
    # Tables: [1, 2] less 0.5.
    assert read["multiscale.tables_idle_ms"] == pytest.approx(0.25)
    assert read["host.reads_per_call"] == 3.0
    assert read["tables.kept_tiles_per_row"] == 3.0
    assert read["kernels.gpairs_per_call"] == pytest.approx(2.5)
    assert read["kernels.port_launches_per_call"] == 4.0


def test_idle_inside_and_outside_add_up():
    events = [("k", 1, 4), ("k", 3, 6), ("k", 9, 12), ("k", 20, 21)]
    spans = [(0, 5), (2, 8), (11, 15)]
    inside = pt.idle_ns(spans, events)
    outside = pt.idle_ns([(8, 11), (15, 25)], events)
    # [0, 8] less 5 busy, [11, 15] less 1; [8, 11] less 2, [15, 25] less 1:
    assert inside == 3 + 3 and outside == 1 + 9
    assert inside + outside == 25 - union_ns(events)


def test_a_window_recorded_by_the_program(lay):
    # Two online calls on the CPU, recorded under a profiler; device events
    # placed by hand in the middle of each eps step and backward span.
    n = 600
    x = torch.randn(n, 3, requires_grad=True)
    y = torch.randn(n, 3) + 0.5
    loss = SamplesLoss("sinkhorn", p=2, blur=0.1, diameter=4.0, backend="online")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            torch.autograd.grad(loss(x, y), x)
    spans = profiling.spans()
    assert sum(s.name == "loss" for s in spans) == 2
    events = []
    for s in spans:
        if s.name in ("solver.eps_step", "solver.last_extrapolation") or s.name.startswith("backward."):
            q = (s.end_ns - s.start_ns) // 4
            events.append(("k", s.start_ns + q, s.end_ns - q))
    events.sort(key=lambda e: e[1])
    lo, hi = min(s.start_ns for s in spans), max(s.end_ns for s in spans)
    tr = Trace(2, (hi - lo) / 1e9, [], [], events, set(), {}, (n, n, 3), "cpu", None)
    in_port = lay.reader("device.idle_in_port_ms")(tr)
    loop = lay.reader("solver.eps_loop_idle_ms")(tr)
    assert 0 < loop < in_port
    port = pt.merged((s.start_ns, s.end_ns) for s in spans)
    gaps = [(a[1], b[0]) for a, b in zip(port, port[1:])]
    outside = pt.idle_ns(gaps, events) / 1e6 / 2
    window_idle = (hi - lo - union_ns(events)) / 1e6 / 2
    assert in_port + outside == pytest.approx(window_idle, rel=1e-12)
    # The online route reads nothing to the host; the CPU launches no kernel.
    assert lay.reader("host.reads_per_call")(tr) == 0.0
    assert lay.reader("kernels.port_launches_per_call")(tr) == 0.0
    assert lay.reader("tables.kept_tiles_per_row")(tr) is None
    profiling.reset()


def test_no_recorder_or_an_empty_window_gives_nothing(lay, monkeypatch):
    tr = _trace(3, [("k", 0, 10)])
    profiling.reset()
    assert all(lay.reader(name)(tr) is None for name in METRICS)
    # A program without the recorder (the benchmark's own metrics still read):
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counts")
    assert all(lay.reader(name)(tr) is None for name in METRICS)
    assert lay.reader("host.launches_per_call")(tr) == 1 / 3
