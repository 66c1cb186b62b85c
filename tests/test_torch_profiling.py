"""The program's recorder (``geomloss_tpu_torch.utils.profiling``) on the
CPU: spans and counters recorded while a ``torch.profiler`` session
records, and nothing otherwise.

Each route of ``SamplesLoss`` that the benchmark's cells or the operator's
profile run records its spans the expected number of times under one call
id (the backward passes' spans too), nested inside their parents, on the
clock of the profiler's own events; every listed host read is counted
where it happens; the buffer drops its oldest spans past its bound.
"""

import collections
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from geomloss_tpu_torch import SamplesLoss
from geomloss_tpu_torch.models import multiscale as ms
from geomloss_tpu_torch.ops import block_sparse as bs
from geomloss_tpu_torch.ops import clustering
from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
from geomloss_tpu_torch.ops import cuda_kernels as ck
from geomloss_tpu_torch.solvers.annealing import max_diameter, scaling_parameters
from geomloss_tpu_torch.utils import profiling as prof


@pytest.fixture(autouse=True)
def fresh_recorder():
    prof.reset()
    yield
    prof.reset()


def _cloud(n, seed, shift=0.0):
    """A sphere cloud of diameter 1, as the benchmark's (uneven)."""
    v = np.random.RandomState(seed).randn(n, 3)
    v[:, 0] += shift
    return torch.tensor(v / (2 * np.linalg.norm(v, axis=1, keepdims=True)), dtype=torch.float32)


def _weights(n, seed):
    w = np.abs(np.random.RandomState(seed).randn(n))
    return torch.tensor(w / w.sum(), dtype=torch.float32)


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, prof.spans(), prof.counts()


# ------------------------------------------------------------------------------
#  Off outside a profiler session
# ------------------------------------------------------------------------------


def test_nothing_is_recorded_outside_a_profiler_session():
    n = 600
    x, y = _cloud(n, 0, 1.0).requires_grad_(True), _cloud(n, 1)
    v = SamplesLoss("gaussian", blur=0.1, truncate=3, backend="multiscale")(_weights(n, 2), x, _weights(n, 3), y)
    torch.autograd.grad(v, x)
    assert not prof.recording()
    assert prof.spans() == [] and prof.counts() == {}
    # No device sum was built for the tables, and a tensor count is dropped:
    assert len(prof._memo) == 0
    prof.count("tables.kept_tiles", torch.tensor(3))
    assert prof.counts() == {} and prof._window_dev == []
    # The host totals count, recording or not (the launch counters):
    before = ck.launch_counts["lse"]
    prof.count(ck.LAUNCHES + "lse")
    assert ck.launch_counts["lse"] == before + 1 and prof.totals["kernels.launches.lse"] == before + 1
    assert prof.counts() == {}


def test_launch_counts_are_views_of_the_registry():
    for view in (ck.launch_counts, cbs.launch_counts):
        assert not isinstance(view, dict) and set(view) == set(dict(view))
    cbs.reset_launch_counts()
    prof.count(ck.LAUNCHES + "walk_rows", 2)
    assert cbs.launch_counts["walk_rows"] == 2 and {**cbs.launch_counts}["walk_rows"] == 2
    cbs.reset_launch_counts()
    assert not any(cbs.launch_counts.values())
    with pytest.raises(KeyError):
        ck.launch_counts["walk_rows"]


def test_a_span_is_a_shared_no_op_when_off():
    assert prof.span("loss") is prof.span("multiscale.sort")
    with prof.span("loss", new_call=True):
        prof.count("host.reads")
    assert prof.spans() == [] and prof.counts() == {}


# ------------------------------------------------------------------------------
#  The routes' spans
# ------------------------------------------------------------------------------


def _call(kw, n, mid=False, monkeypatch=None):
    if mid:
        monkeypatch.setattr(ms, "N_FINE_OK", 2048)
    a, b = _weights(n, 2), _weights(n, 3)
    x, y = _cloud(n, 0, 1.0).requires_grad_(True), _cloud(n, 1)

    def run():
        v = SamplesLoss(**kw)(a, x, b, y)
        return torch.autograd.grad(v, x)[0]

    return a, x, b, y, run


SINKHORN = dict(loss="sinkhorn", p=2, blur=0.01, diameter=1.0)


def _schedule(x, y, kw):
    return scaling_parameters(x, y, kw["p"], kw["blur"], None, kw["diameter"], 0.5)[2]


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.seq]


def _check_tree(spans):
    """One call id, the backward spans with it; every child inside its
    parent's interval, on the parent's thread."""
    assert len({s.call_id for s in spans}) == 1 and spans[0].call_id is not None
    by_seq = {s.seq: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_seq[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns and p.thread == s.thread
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots if not s.name.startswith("backward.")] == ["loss"]


def test_online_route_spans():
    n = 1000
    _, x, _, y, run = _call(dict(SINKHORN, backend="online"), n)
    _, spans, counts = _recorded(run)
    names = collections.Counter(s.name for s in spans)
    assert names == {"loss": 1, "solver.eps_loop": 1, "solver.eps_step": len(_schedule(x, y, SINKHORN)),
                     "solver.last_extrapolation": 1, "backward.SoftminExtrapolation": 1,
                     "backward.SoftminExtrapolationSym": 1}
    _check_tree(spans)
    loop = next(s for s in spans if s.name == "solver.eps_loop")
    assert all(s.name == "solver.eps_step" for s in _children(spans, loop))
    assert counts.get("host.reads", 0) == 0  # the diameter is given


@pytest.mark.parametrize("mid", [False, True], ids=["classic", "mid"])
def test_multiscale_sinkhorn_route_spans(mid, monkeypatch):
    n = 4096
    kw = dict(SINKHORN, backend="multiscale")
    a, x, b, y, run = _call(kw, n, mid, monkeypatch)
    _, spans, counts = _recorded(run)
    pro = ms.multiscale_prologue(a, x.detach(), b, y, 2, 0.01, None, 1.0, 0.5, 5, None, None, True, None, None,
                                 False, "auto", "auto", None, 2000, "auto")
    eps_list = pro.eps_list
    jump = ms.jump_index(eps_list, ms.default_cluster_scale(1.0, 3), 2)
    n_delay = ms.mid_delay(n, eps_list, jump, 0.5, 2)
    assert (n_delay > 0) == mid and pro.eps_fine
    names = collections.Counter(s.name for s in spans)
    fine = len(pro.eps_fine)
    expected = {
        "loss": 1, "multiscale.prologue": 1, "multiscale.sort": 2, "multiscale.coarse": 1,
        "multiscale.extrapolate": 1, "solver.eps_loop": 2 + mid, "solver.eps_step": jump + 1 + n_delay + fine,
        # the prologue's tables, then three re-thresholded tables a fine step and for the last extrapolation:
        "multiscale.tables": 1 + 3 * (fine + 1), "solver.last_extrapolation": 1,
        "backward.SoftminExtrapolationWalkBanded": 1, "backward.SoftminExtrapolationWalkBandedSym": 1,
    }
    if mid:
        expected["multiscale.mid"] = 1
    assert names == expected
    _check_tree(spans)
    phases = {s.name: s for s in spans}
    coarse_loop = [s for s in _children(spans, phases["multiscale.coarse"]) if s.name == "solver.eps_loop"]
    assert len(_children(spans, coarse_loop[0])) == jump + 1
    fine_loop = [s for s in spans if s.name == "solver.eps_loop" and s.parent == phases["loss"].seq]
    assert len([c for c in _children(spans, fine_loop[0]) if c.name == "solver.eps_step"]) == fine
    # kept_width's three reads (the prologue's tables) and fine_tables' one a table:
    assert counts["host.reads"] == 6
    assert counts["tables.row_tiles"] == 3 * pro.x_s.shape[0] // pro.tile
    assert counts["tables.kept_tiles"] == sum(int(m.counts.sum()) for m in pro.masks)


def test_gaussian_multiscale_route_spans():
    n = 3000
    kw = dict(loss="gaussian", blur=0.1, truncate=3, backend="multiscale")
    a, x, b, y, run = _call(kw, n)
    _, spans, counts = _recorded(run)
    names = collections.Counter(s.name for s in spans)
    assert names == {"loss": 1, "multiscale.sort": 2, "multiscale.tables": 3, "mmd.applies": 1,
                     "backward.KernelMatvecSparse": 2}
    _check_tree(spans)
    # The three tables' reads and counts, against the same tables built unrecorded:
    tile = ms.auto_tile(n)
    (_, a_s), (_, x_s), _ = ms.spatial_sort_blocks(a, x.detach(), None, None, tile, tile)
    (_, b_s), (_, y_s), _ = ms.spatial_sort_blocks(b, y, None, None, tile, tile)
    masks = [bs.masks_from_geometry(x_s, y_s, 0.3, tile, w_x=a_s, w_y=b_s),
             bs.masks_from_geometry(x_s, x_s, 0.3, tile, w_x=a_s, w_y=a_s, sym=True),
             bs.masks_from_geometry(y_s, y_s, 0.3, tile, w_x=b_s, w_y=b_s, sym=True)]
    # Three matvecs, two of them (K_xx a and K_xy b, x requiring grad)
    # with the gradient's channels in their forward:
    assert counts == {"host.reads": 3, "tables.row_tiles": sum(m.counts.shape[0] for m in masks),
                      "tables.kept_tiles": sum(int(m.counts.sum()) for m in masks),
                      "matvec.forwards": 3, "matvec.grad_in_forward": 2}


def test_energy_online_route_counts():
    """The energy loss above 5000^2 pairs (``auto``: the online route)
    makes three streaming applies, all in its forward (xx, yy, xy), each
    over N M pairs: the two whose x requires grad (xx and xy) carry the
    gradient's channels, so the backward of either makes none."""
    n = 5008
    _, x, _, y, run = _call(dict(loss="energy"), n)
    _, spans, counts = _recorded(run)
    names = collections.Counter(s.name for s in spans)
    assert names == {"loss": 1, "mmd.applies": 1, "backward.GibbsMatvec": 2}
    _check_tree(spans)
    assert counts == {"matvec.forwards": 3, "matvec.grad_in_forward": 2, "matvec.pairs": 3 * n * n}


def test_calls_take_new_ids_and_backward_keeps_its_call():
    n = 500
    _, x, _, y, run = _call(dict(SINKHORN, backend="online"), n)
    _, spans, counts = _recorded(lambda: (run(), run()))
    ids = sorted({s.call_id for s in spans})
    assert len(ids) == 2
    for call in ids:
        mine = [s for s in spans if s.call_id == call]
        loss = next(s for s in mine if s.name == "loss")
        backward = [s for s in mine if s.name.startswith("backward.")]
        assert len(backward) == 2 and all(s.start_ns >= loss.end_ns for s in backward)
    assert prof.counts(by_call=True) == {}


# ------------------------------------------------------------------------------
#  The clock, the counts, the bound
# ------------------------------------------------------------------------------


def test_spans_share_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.span("outer"):
            with torch.profiler.record_function("inner"):
                torch.ones(64).sum()
    (outer,) = prof.spans()
    inner = [e for e in p.profiler.kineto_results.events() if e.name() == "inner"]
    assert len(inner) == 1
    start = inner[0].start_ns()
    assert outer.start_ns <= start and start + inner[0].duration_ns() <= outer.end_ns
    # The span's own record_function event is the profiler's too:
    assert any(e.name() == "outer" for e in p.profiler.kineto_results.events())


def test_device_counts_are_read_once_and_kept_by_call():
    t = torch.tensor(3)
    with profile(activities=[ProfilerActivity.CPU]):
        with prof.span("loss", new_call=True) as s:
            prof.count("tables.kept_tiles", t, 5)
            prof.count("tables.kept_tiles", t)
            prof.count("host.reads", 2)
        call = s.call_id
    assert prof.counts() == {"tables.kept_tiles": 18, "host.reads": 2}
    assert prof.counts(by_call=True) == {("tables.kept_tiles", call): 18, ("host.reads", call): 2}


def test_a_table_sum_is_computed_once_per_table(monkeypatch):
    cnt = torch.tensor([3, 1, 2], dtype=torch.int32)
    calls = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            got = prof.table_sum(cnt, "kept", lambda: calls.append(1) or cnt.sum())
        assert int(prof.kept_tiles(cnt, 2)) == 5
    assert len(calls) == 1 and int(got) == 6


def test_the_buffer_drops_its_oldest_spans(monkeypatch):
    monkeypatch.setattr(prof, "MAX_SPANS", 4)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(10):
            with prof.span(f"s{i}"):
                prof.count("tables.kept_tiles", torch.tensor(i), 2)
    assert [s.name for s in prof.spans()] == ["s6", "s7", "s8", "s9"]
    assert prof.dropped() == 6
    # The device counts stay bounded too (folded by key), and add up:
    assert len(prof._window_dev) <= 4 and prof.counts() == {"tables.kept_tiles": 90}


def test_threads_record_and_count_without_losing_updates():
    threads, rounds = 2 * (os.cpu_count() or 2), 200
    before = prof.totals.get("host.reads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):

            def work():
                for _ in range(rounds):
                    with prof.span("loss", new_call=True):
                        prof.count("host.reads")

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    spans = prof.spans()
    assert len(spans) == threads * rounds and len({s.call_id for s in spans}) == threads * rounds
    assert prof.totals["host.reads"] == before + threads * rounds
    assert prof.counts() == {"host.reads": threads * rounds}


def _kept_width():
    bs.kept_width(torch.tensor([[1.0, -1.0], [1.0, 1.0]]), 8)


def _chunks():
    slot_i, slot_j = cbs._live_slots(torch.tensor([[0, 1], [1, 0]], dtype=torch.int32),
                                     torch.tensor([2, 1], dtype=torch.int32), False)
    R, chunks, live = cbs._chunks(slot_i, slot_j, 2, 2, False, cbs.TILES_SCRATCH_BYTES)
    assert live and sum(c[1] for c in chunks) == 3


def _fine_tables():
    score = torch.tensor([[3.0, 1.0, -1.0], [2.0, -1.0, -2.0]])
    mask = bs._tile_mask(score, 3, False)
    ms.fine_tables(mask, 0.5, [0.5, 0.25], 5)(mask, 0.25)


def _max_diameter():
    max_diameter(torch.zeros(3, 2), torch.ones(4, 2))


def _clustering():
    clustering.cluster_ranges_centroids(torch.rand(5, 2), np.array([0, 1, 0, 2, 1]))


def _walk_plan():
    cbs.walk_plan(torch.tensor([[0, 1], [1, 0]], dtype=torch.int32), torch.tensor([2, 1], dtype=torch.int32), 2)


READS = {"kept_width": _kept_width, "chunks_live_count": _chunks, "fine_tables": _fine_tables,
         "max_diameter": _max_diameter, "clustering": _clustering, "walk_plan": _walk_plan}


@pytest.mark.parametrize("site", sorted(READS))
def test_host_reads_are_counted_where_they_happen(site, monkeypatch):
    # kernels 5 and 6 read the live count of a table past their scratch budget:
    monkeypatch.setattr(cbs, "TILES_SCRATCH_BYTES", 1)
    before = prof.totals.get("host.reads", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        READS[site]()
    assert prof.totals["host.reads"] == before + 1
    assert prof.counts()["host.reads"] == 1


@pytest.mark.parametrize("N", [1, 255, 256, 257, 1000, 4096, 100_003])
def test_sym_step_pairs_count_the_triangle_of_tiles(N):
    B = 256
    nb = -(-N // B)
    for t0 in range(0, nb, max(1, nb // 5)):
        for n in range(1, nb - t0 + 1, max(1, (nb - t0) // 4)):
            want = sum(min(B, N - I * B) * (N - I * B) for I in range(t0, t0 + n))
            assert ck.sym_step_pairs(N, t0, n) == want
    # Every launch of one call together: the triangle, whole diagonal tiles.
    R, _ = ck.sym_step_plan(N)
    total = sum(ck.sym_step_pairs(N, t0, min(R, nb - t0)) for t0 in range(0, nb, R))
    assert total == N * (N + 1) // 2 + sum(r * (r - 1) // 2 for r in [B] * (N // B) + ([N % B] if N % B else []))
