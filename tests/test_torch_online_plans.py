"""Host-side code of the online apply kernel (kernel 4): its column slices
and row chunks (``apply_plan``). Its channel groups, shared with kernel 8,
are tested in ``test_torch_packing.py``.

No JAX, no card: the plan is checked for coverage and its scratch budget.
"""

import numpy as np
import pytest

from geomloss_tpu_torch.ops import cuda_kernels as ck

RAGGED_M = [1, 255, 257, 10_003, 100_000]


def _check_plan(N, M, C):
    R, S, width = ck.apply_plan(N, M, C)
    nb = -(-N // 256)
    assert width % 256 == 0 and width > 0 and 1 <= R <= nb
    # The slices [s width, min(M, (s + 1) width)) cover every column once:
    # all are non-empty and the last one ends at M.
    cols = np.zeros(M, np.int64)
    for s in range(S):
        lo, hi = s * width, min(M, (s + 1) * width)
        assert lo < hi
        cols[lo:hi] += 1
    assert (cols == 1).all()
    # The chunks of row blocks cover every row block once.
    blocks = np.zeros(nb, np.int64)
    for b0 in range(0, nb, R):
        blocks[b0 : b0 + R] += 1
    assert (blocks == 1).all()
    if S == 1:
        assert R == nb  # no scratch: one launch writes the output
    else:
        _, Cp = ck._channel_groups(C)
        assert 4 * S * Cp * R * 256 <= ck.STEP_SCRATCH_BYTES or R == 1
    if R == nb:
        # A launch fills the card where M allows.
        assert nb * S >= min(ck._STEP_BLOCKS, nb * -(-M // 256))
    return R, S, width


@pytest.mark.parametrize("C", [1, 4, 33])
@pytest.mark.parametrize("N", [1, 300, 10_000, 100_000])
@pytest.mark.parametrize("M", RAGGED_M)
def test_apply_plan_covers_every_column_once(M, N, C):
    _check_plan(N, M, C)


@pytest.mark.parametrize("M", RAGGED_M)
def test_apply_plan_chunks_under_a_small_budget(M, monkeypatch):
    """A budget of a few row blocks' partials: several chunks, each under it."""
    monkeypatch.setattr(ck, "STEP_SCRATCH_BYTES", 3 * 4 * 8 * 256 * 8)
    R, S, _ = _check_plan(4_099, M, 5)
    if S > 1:
        assert R < -(-4_099 // 256)
