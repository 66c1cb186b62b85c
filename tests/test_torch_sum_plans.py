"""Host-side plan of kernel 12 (and kernels 10, 8 and 11 on it): the ranges
into which ``sum_rows_plan`` cuts each row tile's kept tiles, and the
split-and-merge of their partial row sums.

No JAX, no card: the plan is checked for coverage, order, fill and
scratch, and for giving a ``(cols, counts)`` table and its walk the same
cut; a float64 mirror of the kernel's split and fixed-order merge is held
against the plain twins ``absorbed_sum_sparse_blocked`` and
``absorbed_sum_walk_blocked``.
"""

import pytest
import torch

from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
from geomloss_tpu_torch.ops import cuda_kernels as ck
from geomloss_tpu_torch.ops.cuda_kernels import _fold_norms, _log_weights_blk
from torch_parity_utils import kept_table, potentials, problem

#: Blocks of two register-tiled blocks on each of the H100's 132 SMs.
CARD_BLOCKS = 2 * 132


def _ranges(count, S):
    """Kept-tile ranges of the S blocks of a row with ``count`` kept tiles,
    as the kernel cuts them: ``floor(q count / S) .. floor((q + 1) count /
    S) - 1``."""
    return [(q * count // S, (q + 1) * count // S) for q in range(S)]


def _plan(n_rows, block, N):
    S = cbs.sum_rows_plan(n_rows, block, N)
    assert 1 <= S <= ck._MAX_GRID_Y
    assert S == 1 or 4 * S * N <= ck.STEP_SCRATCH_BYTES
    return S


@pytest.mark.parametrize("width", [1, 3, 24, 128, 400])
@pytest.mark.parametrize("block", [96, 256, 512, 1024])
@pytest.mark.parametrize("n_rows", [1, 7, 256, 2048])
def test_sum_plan_covers_every_kept_tile_once_in_order(n_rows, block, width):
    """Every count up to the width (and above: a count the CSR form does not
    clamp) is cut into S ranges that tile it once, in order, of lengths
    within one of each other."""
    S = _plan(n_rows, block, n_rows * block)
    for count in sorted({0, 1, 2, width // 2, width - 1, width, width + 5}):
        ranges = _ranges(count, S)
        seen = [t for t0, t1 in ranges for t in range(t0, t1)]
        assert seen == list(range(count))
        lengths = [t1 - t0 for t0, t1 in ranges]
        assert max(lengths) - min(lengths) <= 1


@pytest.mark.parametrize("n_rows, block", [(1, 96), (4, 256), (256, 512), (196, 512)])
def test_sum_plan_fills_the_card_where_rows_are_few(n_rows, block):
    """Few row tiles (the public ops at 1e5: 256 of 512) still give a
    launch of at least two blocks an SM, and about the block target."""
    S = _plan(n_rows, block, n_rows * block)
    blocks = n_rows * -(-block // 256)
    assert blocks * S >= min(CARD_BLOCKS, cbs._SUM_BLOCKS)
    assert blocks * S < cbs._SUM_BLOCKS + blocks


def test_sum_plan_keeps_one_range_at_the_2e6_tables():
    """bench.py's first fine table at 2e6 (2048 row tiles of 1024) holds
    8,192 blocks: one range, no scratch, no merge."""
    assert _plan(2048, 1024, 2048 * 1024) == 1


@pytest.mark.parametrize("n_rows, block", [(4, 256), (256, 512), (1, 96)])
def test_sum_plan_under_a_small_budget(n_rows, block, monkeypatch):
    """A budget of a few ranges' partials: fewer ranges, under it; one
    (no scratch) where it holds not two."""
    N = n_rows * block
    monkeypatch.setattr(ck, "STEP_SCRATCH_BYTES", 3 * 4 * N)
    assert 1 <= _plan(n_rows, block, N) <= 3
    monkeypatch.setattr(ck, "STEP_SCRATCH_BYTES", 2 * 4 * N - 1)
    assert _plan(n_rows, block, N) == 1


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("n_rows, block", [(4, 256), (256, 512), (1024, 1024)])
def test_apply_plan_holds_its_channels_under_the_budget(n_rows, block, C, monkeypatch):
    """Kernel 8 takes kernel 12's ranges, each range's partials ``C``
    channels wide: ``4 S N C`` bytes under the budget, the same cut as
    kernel 12's where the budget does not bind, and one range (no scratch)
    where it holds not two."""
    N = n_rows * block
    S = cbs.sum_rows_plan(n_rows, block, N, C)
    assert S == 1 or 4 * S * N * C <= ck.STEP_SCRATCH_BYTES
    if 4 * cbs.sum_rows_plan(n_rows, block, N) * N * C <= ck.STEP_SCRATCH_BYTES:
        assert S == cbs.sum_rows_plan(n_rows, block, N)
    monkeypatch.setattr(ck, "STEP_SCRATCH_BYTES", 2 * 4 * N * C - 1)
    assert cbs.sum_rows_plan(n_rows, block, N, C) == 1


def _sum_table(block, seed, n_tiles=6, m_tiles=7, cap=5):
    N, M = n_tiles * block, m_tiles * block
    x, y, _ = problem(N, M, seed=seed)
    f, g, la, lb = potentials(N, M, seed=seed + 1)
    cols, counts = kept_table(n_tiles, m_tiles, cap, seed=seed + 2)
    counts[0], counts[1], counts[2] = cap + 2, 0, 1  # above the width, none, one
    pts = [torch.from_numpy(a).double() for a in (x, y, la + f / 0.1, lb + g / 0.1)]
    return pts, torch.from_numpy(cols), torch.from_numpy(counts)


@pytest.mark.parametrize("block", [96, 256])
def test_sum_plan_is_the_same_for_the_sparse_and_walk_forms(block):
    """The plan reads the shapes the two forms share (row tiles, block, N),
    and the decoded unclipped walk has the table's clamped counts: both
    forms cut every row alike."""
    (x, y, _, _), cols, counts = _sum_table(block, seed=block)
    tbl = cbs.walk_plan(cols, counts, cols.shape[1])
    nI = cbs._check_walk("test", x, y, tbl, block, block)
    assert nI == cols.shape[0]
    assert cbs.sum_rows_plan(nI, block, x.shape[0]) == cbs.sum_rows_plan(cols.shape[0], block, x.shape[0])
    dense, walk = cbs._dense_rows(cols, counts), cbs._walk_rows(tbl, nI)
    assert torch.equal(dense[2], walk[2])
    for I in range(nI):
        c = int(dense[2][I])
        assert torch.equal(dense[0][dense[1][I] : dense[1][I] + c], walk[0][walk[1][I] : walk[1][I] + c])


def _mirror(x, y, phi, psi, eps, rows, block, S):
    """float64 mirror of kernel 12: each row tile's S ranges of kept tiles
    summed apart, then the partials added in range order from 0."""
    phi, psi = _fold_norms(x, phi, eps, 2), _fold_norms(y, psi, eps, 2)
    cols, start, cnt = (t.long() for t in rows)
    out = torch.zeros(x.shape[0], dtype=torch.float64)
    lanes = torch.arange(block)
    for I in range(cnt.shape[0]):
        sl = slice(I * block, (I + 1) * block)
        acc = torch.zeros(block, dtype=torch.float64)
        for t0, t1 in _ranges(int(cnt[I]), S):
            part = torch.zeros(block, dtype=torch.float64)
            for k in range(t0, t1):
                idx = cols[start[I] + k] * block + lanes
                part += torch.exp(_log_weights_blk(x[sl], phi[sl], y[idx], psi[idx], eps, 2)).sum(1)
            acc = acc + part
        out[sl] = acc
    return out


@pytest.mark.parametrize("S", [1, 2, 3, 8])
@pytest.mark.parametrize("block", [96, 256])
def test_sum_split_and_merge_mirror_matches_both_twins(block, S):
    """The split into S ranges and their fixed-order merge, in float64,
    equals the twins of both forms to 1e-12."""
    (x, y, phi, psi), cols, counts = _sum_table(block, seed=3 * block + S)
    eps = 0.1
    tbl = cbs.walk_plan(cols, counts, cols.shape[1])
    got = _mirror(x, y, phi, psi, eps, cbs._dense_rows(cols, counts), block, S)
    got_w = _mirror(x, y, phi, psi, eps, cbs._walk_rows(tbl, cols.shape[0]), block, S)
    ref = cbs.absorbed_sum_sparse_blocked(x, y, phi, psi, eps, cols, counts, 2, block)
    ref_w = cbs.absorbed_sum_walk_blocked(x, y, phi, psi, eps, tbl, 2, block)
    for a, b in ((got, ref), (got_w, ref_w), (got_w, ref)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0.0)
    assert not got[block : 2 * block].any()  # the row tile of no kept tile


def test_walk_rows_plain_is_the_cpu_path():
    """On the CPU the decode is its PyTorch form."""
    cols, counts = kept_table(5, 6, 4, seed=0)
    tbl = cbs.walk_plan(torch.from_numpy(cols), torch.from_numpy(counts), 2)
    for a, b in zip(cbs._walk_rows(tbl, 5), cbs._walk_rows_plain(tbl, 5)):
        assert torch.equal(a, b)
