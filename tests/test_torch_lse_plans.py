"""Host-side code of the LSE kernels (kernel 1, and kernel 7 with kernel 9
on it): kernel 1's column slices (``lse_plan``), kernel 7's ranges of kept
tiles (``lse_tiles_plan``), the points as both read them
(``_lse_points``), and the split-and-merge of their partial (max, sum)
pairs.

No JAX, no card: the plans are checked for coverage, fill and scratch; a
float64 mirror of the kernels' split and fixed-order merge is held
against the plain twins ``lse_blocked`` and ``lse_tiles_blocked``.
"""

import math

import numpy as np
import pytest
import torch

from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
from geomloss_tpu_torch.ops import cuda_kernels as ck
from torch_parity_utils import kept_table, problem

SIZES = [1, 63, 64, 65, 255, 257, 4096, 16384, 100_000]
#: Blocks of two register-tiled blocks on each of the H100's 132 SMs.
CARD_BLOCKS = 2 * 132


def _slices(N, M):
    """Kernel 1's column slices of ``lse_plan``, checked: a multiple of a
    64-column pass wide, each non-empty, covering every column once."""
    S, width = ck.lse_plan(N, M)
    assert width > 0 and width % 64 == 0 and S >= 1
    cols = np.zeros(M, np.int64)
    out = []
    for s in range(S):
        lo, hi = s * width, min(M, (s + 1) * width)
        assert lo < hi
        cols[lo:hi] += 1
        out.append((lo, hi))
    assert (cols == 1).all()
    # Partials only with several slices, under the scratch budget.
    assert S == 1 or 8 * S * N <= ck.STEP_SCRATCH_BYTES
    return out


@pytest.mark.parametrize("M", SIZES)
@pytest.mark.parametrize("N", SIZES)
def test_lse_plan_covers_every_column_once(N, M):
    _slices(N, M)


@pytest.mark.parametrize("n", [4096, 16384])
def test_lse_plan_fills_the_card_at_the_coarse_and_mid_sweeps(n):
    """bench.py's coarse sweeps (4,096 points, at 1e5 and at 2e6) and the
    mid cloud (16,384 points at 2e6): at least two blocks an SM."""
    assert len(_slices(n, n)) * -(-n // 256) >= CARD_BLOCKS


def test_lse_plan_holds_its_block_target_at_1e5():
    """At 1e5 points (391 row blocks) two slices: the target, under twice it."""
    n = 100_000
    blocks = len(_slices(n, n)) * -(-n // 256)
    assert ck._LSE_BLOCKS <= blocks < 2 * ck._LSE_BLOCKS


@pytest.mark.parametrize("N, M", [(4096, 4096), (300, 100_000), (16384, 16384), (1, 65)])
def test_lse_plan_under_a_small_budget(N, M, monkeypatch):
    """A budget of a few slices' partials: fewer slices, under it; none
    (one slice, no scratch) where it holds not one."""
    budget = 3 * 8 * N
    monkeypatch.setattr(ck, "STEP_SCRATCH_BYTES", budget)
    assert 2 <= len(_slices(N, M)) <= 3 or M <= 64
    monkeypatch.setattr(ck, "STEP_SCRATCH_BYTES", 8 * N - 1)
    assert len(_slices(N, M)) == 1


def _ranges(n_rows, block_n, width, N):
    """Kernel 7's ranges of kept tiles of ``lse_tiles_plan``, checked: they
    cover the table's width once, none empty, under the budget."""
    S, span = cbs.lse_tiles_plan(n_rows, block_n, width, N)
    assert S >= 1 and span >= 1
    cover = np.zeros(max(width, 1), np.int64)
    out = []
    for q in range(S):
        lo, hi = q * span, min(width, (q + 1) * span)
        assert lo < hi or width == 0
        cover[lo:hi] += 1
        out.append((lo, hi))
    assert width == 0 or (cover == 1).all()
    assert S == 1 or 8 * S * N <= ck.STEP_SCRATCH_BYTES
    return out


@pytest.mark.parametrize(
    "n_rows, block_n, width",
    [(1, 256, 1), (3, 256, 7), (196, 512, 196), (2048, 1024, 64), (98, 1024, 24), (5, 100, 0), (4, 300, 9)],
)
def test_lse_tiles_plan_covers_every_kept_tile_once(n_rows, block_n, width):
    ranges = _ranges(n_rows, block_n, width, n_rows * block_n)
    blocks = n_rows * -(-block_n // 256)
    if blocks >= cbs._LSE_TILES_BLOCKS:
        assert len(ranges) == 1  # the mid path's extrapolations at 2e6: one launch, no merge
    elif width:
        want = min(width, -(-cbs._LSE_TILES_BLOCKS // blocks))
        assert len(ranges) == -(-width // -(-width // want))


def test_lse_tiles_plan_under_a_small_budget(monkeypatch):
    N = 196 * 512
    monkeypatch.setattr(ck, "STEP_SCRATCH_BYTES", 4 * 8 * N)
    assert len(_ranges(196, 512, 196, N)) <= 4
    monkeypatch.setattr(ck, "STEP_SCRATCH_BYTES", 0)
    assert len(_ranges(196, 512, 196, N)) == 1


# ------------------------------------------------------------------------------
#  The split and the merge, mirrored in float64
# ------------------------------------------------------------------------------


def _partial(arg):
    """(m, s) of the LSE of ``arg``'s rows over its columns, in stages of
    256 columns as the kernels take them: the running max, the sum
    rescaled where a stage raises it; (-inf, 0) for a row of -inf."""
    m = torch.full(arg.shape[:1], -math.inf, dtype=arg.dtype)
    s = torch.zeros_like(m)
    for j0 in range(0, arg.shape[1], 256):
        blk = arg[:, j0 : j0 + 256]
        m_new = torch.maximum(m, blk.max(1).values)
        base = torch.where(torch.isneginf(m_new), 0.0, m_new)
        s = s * torch.exp(m - base) + torch.exp(blk - base[:, None]).sum(1)
        m = m_new
    return m, s


def _merge(parts):
    """The merge kernel's fixed order: the largest max, then the sums
    rescaled to it added in slice order; ``m + log s``."""
    mm = torch.stack([m for m, _ in parts]).max(0).values
    ss = torch.zeros_like(mm)
    for m, s in parts:
        ss = ss + torch.where(torch.isneginf(mm), 0.0, s * torch.exp(m - mm))
    return mm + torch.log(ss)


def _arg(x, y, h, eps, p):
    """Natural-log weights ``h_j - C_p(x_i, y_j) / eps``, float64."""
    sq = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    return h[None, :] - (sq / 2 if p == 2 else torch.sqrt(torch.clamp(sq, min=1e-8))) / eps


def _assert_lse_equal(got, ref):
    assert not torch.isnan(got).any() and not torch.isnan(ref).any()
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(got[fin], ref[fin], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("neg_inf", ["none", "slices", "all"])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("N, M", [(300, 4096), (70, 1000), (257, 65)])
def test_lse_split_and_merge_match_the_twin(N, M, p, neg_inf):
    """Kernel 1's split over the plan's slices, then the merge, equals
    ``lse_blocked``: with zero-weight columns (bias -inf) filling whole
    slices and part of another, and with every bias -inf (-inf out, no
    NaN)."""
    x, y, h = (torch.tensor(a, dtype=torch.float64) for a in problem(N, M, seed=N + M + p))
    slices = _slices(N, M)
    if neg_inf == "slices":
        h[: slices[min(1, len(slices) - 1)][1]] = -math.inf
        h[-7:] = -math.inf
    elif neg_inf == "all":
        h[:] = -math.inf
    eps = 0.2
    arg = _arg(x, y, h, eps, p)
    got = _merge([_partial(arg[:, lo:hi]) for lo, hi in slices])
    _assert_lse_equal(got, ck.lse_blocked(x, y, h, eps, p))
    if neg_inf == "all":
        assert torch.isneginf(got).all()


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("block_n, block_m", [(256, 128), (100, 48), (300, 512)])
def test_lse_tiles_split_and_merge_match_the_twin(block_n, block_m, p):
    """Kernel 7's ranges of kept tiles (a row tile's kept tiles end to end,
    split by ``lse_tiles_plan``, counts clamped at the width), then the
    merge, equal ``lse_tiles_blocked``; a row tile whose kept tiles all
    have bias -inf gives -inf."""
    n_tiles, m_tiles, cap = 4, 7, 5
    x, y, h = (torch.tensor(a, dtype=torch.float64) for a in problem(n_tiles * block_n, m_tiles * block_m, seed=p))
    cols, counts = (torch.from_numpy(a) for a in kept_table(n_tiles, m_tiles, cap, seed=block_m + p))
    counts[0] = cap + 2  # clamped at the width
    counts[2] = 1
    h[cols[2, 0] * block_m : (cols[2, 0] + 1) * block_m] = -math.inf
    eps = 0.1 if p == 2 else 0.3
    N = x.shape[0]
    ranges = _ranges(n_tiles, block_n, cols.shape[1], N)
    assert len(ranges) > 1
    got = torch.empty(N, dtype=torch.float64)
    for I in range(n_tiles):
        rows = slice(I * block_n, (I + 1) * block_n)
        kept = cols[I, : min(int(counts[I]), cols.shape[1])].long()
        parts = []
        for lo, hi in ranges:
            idx = (kept[lo:hi, None] * block_m + torch.arange(block_m)).reshape(-1)
            parts.append(_partial(_arg(x[rows], y[idx], h[idx], eps, p)))
        got[rows] = _merge(parts)
    ref = cbs.lse_tiles_blocked(x, y, h, eps, cols, counts, block_n, block_m, p)
    _assert_lse_equal(got, ref)
    assert torch.isneginf(got[2 * block_n : 3 * block_n]).all()


# ------------------------------------------------------------------------------
#  The points kernels 1 and 7 read
# ------------------------------------------------------------------------------


@pytest.mark.parametrize("p, D", [(2, 1), (2, 3), (2, 4), (2, 11), (1, 1), (1, 3), (1, 4), (1, 12)])
def test_lse_points_staged_widths_are_read_raw(p, D):
    """Up to three float4s a point (D + 1 floats at p = 2: a row carries
    minus its running max in the last slot) the kernels read the raw
    points: float32 contiguous ones go through untouched (no PyTorch
    launch)."""
    x = torch.rand(50, D)
    y = torch.rand(30, D)
    (xf, yf), ld, kv = ck._lse_points("test", x, y, p=p)
    assert (ld, kv) == (D, -(-(D + (p == 2)) // 4))
    assert xf.data_ptr() == x.data_ptr() and yf.data_ptr() == y.data_ptr()


@pytest.mark.parametrize("p, D", [(2, 12), (1, 13), (2, 17), (1, 32), (2, 31), (2, 32)])
def test_lse_points_wide_widths_are_padded_to_float4s(p, D):
    """Wider points are read as float4 vectors: zero-padded to 4 kv floats
    (not copied where they are already so laid out), float64 made
    float32."""
    x = torch.rand(50, D, dtype=torch.float64)
    y = torch.rand(30, D)
    (xf, yf), ld, kv = ck._lse_points("test", x, y, p=p)
    assert kv == -(-(D + (p == 2)) // 4) and ld == 4 * kv
    for got, src in ((xf, x), (yf, y)):
        assert got.dtype == torch.float32 and got.is_contiguous() and got.shape == (src.shape[0], ld)
        assert torch.equal(got[:, :D], src.float()) and not got[:, D:].any()
    assert (yf.data_ptr() == y.data_ptr()) == (D == ld)
