"""The benchmark's energy-distance cell on the CPU: its plain reference
(``benchmark/reference/energy.py``) against ``SamplesLoss("energy")`` in
float64, the pairs that each route's gradient leaves out, the work count
of ``kernels.energy_roofline``, and the readers of its three per-layer
metrics on synthetic and recorded windows.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.layout import Layout
from benchmark.metrics import _energy_work
from benchmark.trace import Trace
from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.ops import costs, cuda_kernels
from geomloss_tpu_torch.utils import profiling
from geomloss_tpu_torch.utils.profiling import Span

CELL = "energy.sphere-1e6"
METRICS = ("mmd.applies_per_call", "mmd.gpairs_per_call", "kernels.energy_roofline")
CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def lay():
    return Layout()


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------------------
#  The reference against the port
# ------------------------------------------------------------------------------


def _planted_clouds(lay, n, gap):
    """Upstream's clouds (float64), with two near pairs planted ``gap``
    apart: ``x_1`` beside ``x_0``, and ``y_0`` beside ``x_2``."""
    gen = torch.Generator().manual_seed(3)
    inputs = lay.clouds("geomloss-sphere")({"n": n, "m": n, "dim": 3}, gen, torch.float64, torch.device("cpu"))
    x, y = inputs["x"], inputs["y"]
    x[1] = x[0] + gap * torch.tensor([0.6, 0.8, 0.0], dtype=torch.float64)
    y[0] = x[2] + gap * torch.tensor([0.0, 0.6, -0.8], dtype=torch.float64)
    return inputs


def _left_out(inputs, rows, cut):
    """The gradient rows' terms of the pairs whose squared distance lies at
    or under ``cut`` (a point with itself adds nothing)."""
    a, x, b, y = (inputs[k] for k in "axby")

    def part(pts, w, self_idx):
        diff = x[rows][:, None, :] - pts[None, :, :]
        sq = (diff * diff).sum(-1)
        near = (sq <= cut) & (sq > 0)
        if self_idx:
            near[torch.arange(rows.shape[0]), rows] = False
        inv = torch.where(near, sq.clamp_min(1e-300).rsqrt(), torch.zeros_like(sq))
        return (w[None, :, None] * inv[..., None] * diff).sum(1), int(near.sum())

    gy, ny = part(y, b, False)
    gx, nx = part(x, a, True)
    return a[rows][:, None] * (gy - gx), nx + ny


#: Each route's gradient cut: the online route's kernels zero the pairs at
#: or under GRAD_SQDIST_CUT (1e-6); the tensorized route's autograd through
#: sqrt(clamp(sq, 1e-8)) those under the clamp.
CUTS = {"online": cuda_kernels.GRAD_SQDIST_CUT, "tensorized": costs.SQDIST_FLOOR}


@pytest.mark.parametrize("gap", [5e-4, 5e-5], ids=["under-1e-3", "under-1e-4"])
@pytest.mark.parametrize("backend", ["online", "tensorized"])
def test_reference_is_the_port_less_its_cut_in_float64(lay, backend, gap, monkeypatch):
    n = 2500
    inputs = _planted_clouds(lay, n, gap)
    rows = torch.cat([torch.arange(3), 3 + torch.randperm(n - 3, generator=torch.Generator().manual_seed(5))[:297]])
    a, x, b, y = (inputs[k] for k in "axby")
    xg = x.clone().requires_grad_(True)
    v = SamplesLoss("energy", backend=backend)(a, xg, b, y)
    (g,) = torch.autograd.grad(v, xg)
    compute = lay.reference(lay.config("energy-sphere3d")["reference"])
    # Blocks of about 200 rows a sum, 1,700 columns a gradient block: the
    # triangles' off-diagonal parts and the rows' own columns across blocks.
    monkeypatch.setitem(compute.__globals__, "BLOCK_PAIRS", 1 << 19)
    value, grad = compute(inputs, {"loss": "energy"}, rows)
    # The value has no cut: the same floor, every pair.
    assert abs(float(v.detach()) - value) <= 1e-12 * abs(value)
    # The gradient: the reference's exact one less the pairs the route cuts.
    left_out, pairs = _left_out(inputs, rows, CUTS[backend])
    planted = gap * gap <= CUTS[backend]
    assert pairs >= (3 if planted else 0)  # x_0 - x_1 from both rows, x_2 - y_0
    assert float((g[rows] - (grad - left_out)).norm()) <= 1e-10 * float(grad.norm())
    if planted:
        # The cut is a departure a limit can see: the planted rows move.
        assert float((g[rows[:3]] - grad[:3]).norm()) > 1e-4 * float(grad[:3].norm())
    else:
        assert float((g[rows[:3]] - grad[:3]).norm()) <= 1e-10 * float(grad[:3].norm())


def test_the_control_reads_tf32_products(lay):
    """One precision lower (float32, TF32 products) the reference moves
    far more than float32 alone does."""
    n = 1500
    inputs = _planted_clouds(lay, n, 0.01)
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(5))[:200]
    compute = lay.reference("energy")
    _, g64 = compute(inputs, {"loss": "energy"}, rows)
    f32 = {k: t.float() for k, t in inputs.items()}
    errs = {}
    for tf32 in (False, True):
        _, g = compute(f32, {"loss": "energy"}, rows, dtype=torch.float32, tf32=tf32)
        errs[tf32] = float((g.double() - g64).norm() / g64.norm())
    assert errs[True] > 20 * errs[False]


# ------------------------------------------------------------------------------
#  The work count
# ------------------------------------------------------------------------------


def test_energy_work_by_hand():
    # 2 x 3 pairs at 3 D + 2, a triangle of 3 at 4 D + 3, of 6 at 2 D + 1.
    pairs, ops, nbytes = _energy_work.energy_work(2, 3, 3)
    assert pairs == 6 + 3 + 6
    assert ops == 6 * 11 + 3 * 15 + 6 * 7
    # a, x, b, y read (2 + 6 + 3 + 9 float32), the value and 2 x 3 written.
    assert nbytes == 4 * 20 + 4 + 4 * 6


def test_least_time_by_hand():
    n, clock = 1_000_000, 1.98e9
    pairs, ops, nbytes = _energy_work.energy_work(n, n, 3)
    assert pairs == n * n + n * (n + 1)
    per_s = 132 * clock
    # The FP32 pipe bounds at the cell's size, above the MUFU and the bytes:
    assert ops / (128 * per_s) > pairs / (16 * per_s) > nbytes / 3.35e12
    assert _energy_work.least_seconds(n, n, 3, CARD, clock) == pytest.approx(ops / (128 * per_s))
    assert 0.6 < _energy_work.least_seconds(n, n, 3, CARD, clock) < 0.7
    # No figures, no roofline (never a 0 %).
    assert _energy_work.least_seconds(n, n, 3, "NVIDIA A100-SXM4-80GB", 1.41e9) is None
    assert _energy_work.least_seconds(n, n, 3, CARD, None) is None


# ------------------------------------------------------------------------------
#  The readers
# ------------------------------------------------------------------------------


MS = 1_000_000  # ns


def _trace(calls, events, call=None, sizes=(1, 1, 3), card="cpu", clock=None):
    return Trace(calls, 1.0, [], [], events, set(), call or {}, sizes, card, clock)


def _window(monkeypatch, spans, counts):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    monkeypatch.setattr(profiling, "counts", lambda by_call=False: dict(counts))


def test_the_entries_list_the_cell(lay):
    for m in lay.spec["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL] and m["moves"] == "ms_per_call"
            assert callable(lay.reader(m["name"]))
    assert {m["name"] for m in lay.per_layer(CELL)} >= set(METRICS)
    assert not set(METRICS) & {m["name"] for m in lay.per_layer("gaussian.sphere-1e6")}
    assert lay.config(lay.cell(CELL)["config"])["call"] == {"loss": "energy"}
    assert lay.limits(CELL)["cell"] == CELL


def test_a_synthetic_window_by_hand(lay, monkeypatch):
    # Two calls of five applies over 1e12 pairs each; the device busy 2 x
    # 2,600 ms of the window.
    spans = [Span("loss", 0, 10 * MS, None, 1, 1, 0), Span("loss", 20 * MS, 30 * MS, None, 2, 1, 1)]
    counts = {"matvec.forwards": 6, "matvec.backward_applies": 4, "matvec.pairs": 10 * 10**12,
              "kernels.pairs": 1}
    _window(monkeypatch, spans, counts)
    events = [("apply_kernel", 0, 2600 * MS), ("apply_kernel", 3000 * MS, 5600 * MS)]
    tr = _trace(2, events, {"loss": "energy"}, (10**6, 10**6, 3), CARD, 1.98e9)
    assert lay.reader("mmd.applies_per_call")(tr) == 5
    assert lay.reader("mmd.gpairs_per_call")(tr) == 5000
    least = _energy_work.least_seconds(10**6, 10**6, 3, CARD, 1.98e9)
    assert lay.reader("kernels.energy_roofline")(tr) == pytest.approx(100 * least / 2.6)
    # Another loss, or a card without figures: no roofline.
    assert lay.reader("kernels.energy_roofline")(_trace(2, events, {"loss": "gaussian"}, (10**6, 10**6, 3), CARD,
                                                        1.98e9)) is None
    assert lay.reader("kernels.energy_roofline")(_trace(2, events, {"loss": "energy"}, (10**6, 10**6, 3))) is None


def test_a_program_without_the_counters_gives_nothing(lay, monkeypatch):
    # A window with spans but none of the matvec's counters (a program that
    # does not count them): no value, and no error.
    _window(monkeypatch, [Span("loss", 0, MS, None, 1, 1, 0)], {"host.reads": 3})
    tr = _trace(1, [])
    assert lay.reader("mmd.applies_per_call")(tr) is None
    assert lay.reader("mmd.gpairs_per_call")(tr) is None
    _window(monkeypatch, [], {})
    assert lay.reader("mmd.applies_per_call")(tr) is None


def test_a_window_recorded_by_the_program(lay):
    n = 700
    inputs = _planted_clouds(lay, n, 0.01)
    a, x, b, y = (inputs[k].float() for k in "axby")
    x.requires_grad_(True)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                v = SamplesLoss("energy", backend="online")(a, x, b, y)
                torch.autograd.grad(v, x)
        tr = _trace(2, [], {"loss": "energy", "backend": "online"}, (n, n, 3))
        # Three applies a call, all in the forward: xx and xy carry the
        # gradient's channels, so the backward makes none.
        assert lay.reader("mmd.applies_per_call")(tr) == 3
        assert lay.reader("mmd.gpairs_per_call")(tr) == 3 * n * n / 1e9
    finally:
        profiling.reset()
