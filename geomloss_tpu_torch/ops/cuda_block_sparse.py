r"""Hand-written Hopper kernels of the block-sparse paths, and their twins.

Five CUDA kernels (``csrc/block_sparse_kernels.cu``, besides the segment
sum of kernels 5 and 6) replace the eight kernels of
:mod:`geomloss_tpu.ops.block_sparse`:

============================  =============================================
wrapper                       TPU kernel it replaces
============================  =============================================
:func:`absorbed_sum_tiles`    ``_absorbed_sum_walk_banded`` /
                              ``_pair_walk_banded_kernel``
:func:`gibbs_apply_tiles`     ``gibbs_apply_walk_banded`` /
                              ``_apply_walk_banded_kernel``
:func:`lse_tiles`             ``lse_walk`` / ``_lse_walk_kernel``
:func:`lse_sparse`            ``lse_sparse`` / ``_lse_sparse_kernel``, on
                              kernel 7's CUDA kernel (the same function
                              over the same table)
:func:`gibbs_apply_sparse`    ``gibbs_apply_sparse`` /
                              ``_apply_sparse_kernel``
:func:`gibbs_apply_walk`      ``gibbs_apply_walk`` / ``_apply_walk_kernel``,
                              on kernel 8's CUDA kernel over the decoded
                              walk table
:func:`absorbed_sum_sparse`   ``_absorbed_sum`` / ``_row_sum_sparse_kernel``
:func:`absorbed_sum_walk`     ``_absorbed_sum_walk`` /
                              ``_row_sum_walk_kernel``, on kernel 12's CUDA
                              kernel over the decoded walk table
============================  =============================================

:func:`lse_tiles`, :func:`lse_sparse`, :func:`gibbs_apply_sparse` and
:func:`absorbed_sum_sparse` are one-direction reductions over the kept
source tiles of a ``(cols, cnt)`` table, with row tiles of ``block_n``
and source tiles of ``block_m`` points (the mid path's extrapolations
onto the fine cloud, the truncated softmin and the truncated MMD
matvecs, the public sparse Sinkhorn steps). :func:`gibbs_apply_walk` and
:func:`absorbed_sum_walk` compute the same functions over a
:func:`walk_plan` table, the JAX package's packed step lists: the wrapper
decodes it on the device into the same CSR form (:func:`_walk_rows`), so
a walk differs from a ``(cols, cnt)`` table only by the tiles its
per-chunk budget clipped. On the card the decode is one kernel launch;
its PyTorch form (:func:`_walk_rows_plain`) is the CPU path.

The other two visit the kept tile pairs of a truncation table given as
CSR lists: row tile ``I`` (``tile`` consecutive sorted points) visits the
column tiles ``cols[I, k]`` for ``k < cnt[I]`` (the TPU's band-major
packing, ``walk_plan_banded``, has no counterpart). With ``tri=True`` the
problem is symmetric and only the kept entries with ``cols[I, k] >= I``
are visited: the column direction then supplies the mirrored lower
triangle, and a diagonal tile contributes to the row direction only. They
launch the table's slots compacted on the device, the live ones first, in
chunks whose partial sums stay under :data:`TILES_SCRATCH_BYTES`
(:func:`_chunks`). Their CUDA kernels, and kernel 8's, are
register-tiled pair blocks that read packed points
(``cuda_kernels._pair_vectors``), so they take any point dimension; so is
kernel 7 (kernel 1's LSE stage, over the raw points and a row tile's
kept tiles laid end to end, long rows split across blocks:
:func:`lse_tiles_plan`); and so is kernel 12 (kernel 5's stage without
column sums, each row's kept tiles cut into :func:`sum_rows_plan`'s
ranges).

Each wrapper takes its plain PyTorch twin (``*_blocked``, same signature, a
loop over row tiles in the input dtype) only for tensors that lie on the
CPU. For CUDA tensors it launches the kernel, or raises. Results are raw
sums of the absorbed weights (no floor, no normalization): bitwise
reproducible, since every partial sum is written once and added up in a
fixed order.
"""

import torch

from ..utils import profiling
from . import cuda_kernels as ck
from .cuda_kernels import (
    LOG2E,
    _apply_weights_blk,
    _cdiv,
    _check_cuda,
    _even_chunks,
    _f32,
    _fold_norms,
    _group_channels,
    _log_weights_blk,
    _pair_vectors,
    _ungroup_channels,
)

__all__ = [
    "absorbed_sum_tiles",
    "absorbed_sum_tiles_blocked",
    "gibbs_apply_tiles",
    "gibbs_apply_tiles_blocked",
    "lse_tiles",
    "lse_tiles_blocked",
    "lse_sparse",
    "lse_tiles_plan",
    "sum_rows_plan",
    "gibbs_apply_sparse",
    "gibbs_apply_sparse_blocked",
    "gibbs_apply_walk",
    "gibbs_apply_walk_blocked",
    "absorbed_sum_sparse",
    "absorbed_sum_sparse_blocked",
    "absorbed_sum_walk",
    "absorbed_sum_walk_blocked",
    "walk_plan",
    "MAX_WALK_ROWS",
    "kept_pairs",
    "TILES_SCRATCH_BYTES",
    "build",
    "launch_counts",
    "reset_launch_counts",
]

#: Rows per CUDA block.
_ROWS = 256

#: Scratch budget of one chunk of :func:`absorbed_sum_tiles` or
#: :func:`gibbs_apply_tiles`: the row and column partial sums of the live
#: slots one launch takes stay under it (one slot's are taken whatever
#: their size).
TILES_SCRATCH_BYTES = 256 << 20
#: Blocks per launch kernel 7 aims for when it splits its rows' kept tiles
#: into ranges: more than kernel 1's, since a range past a short row's
#: count is an empty block, and the long rows' ranges must still be short.
_LSE_TILES_BLOCKS = 4096
#: Blocks per launch kernel 12 aims for when it cuts each row's kept tiles
#: into ranges (:func:`sum_rows_plan`).
_SUM_BLOCKS = 4096

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`
#: (a view of the counters ``kernels.launches.<wrapper>``).
launch_counts = profiling.TotalsView(ck.LAUNCHES, (
    "absorbed_sum_tiles", "gibbs_apply_tiles", "lse_tiles", "lse_sparse", "gibbs_apply_sparse", "gibbs_apply_walk",
    "absorbed_sum_sparse", "absorbed_sum_walk", "walk_rows",
))


def reset_launch_counts():
    launch_counts.reset()


_P, _I, _F = ck._P, ck._I, ck._F
_LIB = ck.KernelLibrary(
    "block_sparse_kernels",
    {
        # xv, yv, rb, cb, slot_i, slot_j, rowpart, colpart, nslots, tile, kv,
        # p, tri, row_off, c2, stream
        "gl_absorbed_sum_tiles": [_P] * 8 + [_I] * 6 + [_F, _P],
        # xv, yv, rb, cb, vy, vx, slot_i, slot_j, rowpart, colpart, nslots,
        # tile, kv, mode, tri, row_off, c2, stream
        "gl_gibbs_apply_tiles": [_P] * 10 + [_I] * 6 + [_F, _P],
        # x, y, h, cols, cnt, out, part, n_rows, ck, block_n, block_m,
        # n_split, span, ld, D, kv, p, c2, stream
        "gl_lse_tiles": [_P] * 7 + [_I] * 10 + [_F, _P],
        # xv, yv, rb, cb, v, cols, row_start, cnt, order, out, part, n_rows,
        # block_n, block_m, n_split, kv, ch, mode, c2, stream
        "gl_gibbs_apply_sparse": [_P] * 11 + [_I] * 7 + [_F, _P],
        # xv, yv, rb, cb, cols, row_start, cnt, out, part, n_rows, block_n,
        # block_m, n_split, kv, p, c2, stream
        "gl_absorbed_sum_sparse": [_P] * 9 + [_I] * 6 + [_F, _P],
        # tbl, cols, start, cnt, nc, T_c, rows_c, nI, stream
        "gl_walk_rows": [_P] * 4 + [_I] * 4 + [_P],
        # parts, order, offsets, out, nseg, L, nsub, stream
        "gl_segment_sum": [_P] * 4 + [_I] * 3 + [_P],
    },
)


def build():
    """Compile (once per source version) and load the block-sparse kernels."""
    return _LIB.build()


# ==============================================================================
#  Kept pairs and the chunks of kernels 5 and 6
# ==============================================================================


def _check_table(name, x, y, cols, cnt, tile, tri, row_offset=0):
    N, M = x.shape[0], y.shape[0]
    if N % tile or M % tile:
        raise ValueError(f"{name}: point counts ({N}, {M}) must be multiples of the tile ({tile}).")
    if cols.ndim != 2 or cols.shape[0] != N // tile or tuple(cnt.shape) != (N // tile,):
        raise ValueError(f"{name}: cols must be (N / tile, ck) and cnt (N / tile,).")
    if row_offset < 0 or (tri and row_offset + N // tile > M // tile):
        raise ValueError(
            f"{name}: a triangle table's row tiles (offset {row_offset}, {N // tile} tiles) must lie within "
            f"the {M // tile} column tiles of its symmetric problem."
        )


def kept_pairs(cols, cnt, tri=False, row_offset=0):
    """Column tile of each slot ``I * ck + k`` of a table, ``-1`` where the
    slot is dead: ``k >= cnt[I]``, or ``cols[I, k] < row_offset + I`` with
    ``tri`` (the table's rows are the global row tiles ``row_offset + I``
    of a symmetric problem, a shard of its triangle table).

    Returns an ``(nI * ck,)`` int32 tensor on the table's device.
    """
    nI, ck_ = cols.shape
    k = torch.arange(ck_, device=cols.device)
    live = k[None, :] < cnt.to(cols.device)[:, None]
    if tri:
        live &= cols >= row_offset + torch.arange(nI, device=cols.device)[:, None]
    return torch.where(live, cols, -1).to(torch.int32).reshape(-1).contiguous()


#: Row tile of the slots past the live ones in :func:`_live_slots` (after
#: every real row tile, so the row offsets leave them out).
_DEAD_ROW = torch.iinfo(torch.int32).max


def _live_slots(cols, cnt, tri, row_offset=0):
    """The table's slots with the live ones first, in table (row-major)
    order: their (local) row and column tiles, two ``(nI * ck,)`` int32
    tensors, the dead slots behind them as row ``_DEAD_ROW`` and column
    ``-1``. Compacted on the device (a stable sort), so that the host never
    waits for the live count."""
    slot_j = kept_pairs(cols, cnt, tri, row_offset)
    order = torch.sort((slot_j < 0).to(torch.uint8), stable=True).indices
    sj = slot_j[order]
    si = torch.where(sj >= 0, order // cols.shape[1], _DEAD_ROW)
    return si.to(torch.int32).contiguous(), sj.contiguous()


def _offsets(keys, n):
    """Start of each key ``0 .. n`` in sorted ``keys``: ``(n + 1,)`` int32,
    by binary search (no device-to-host sync)."""
    return torch.searchsorted(keys, torch.arange(n + 1, device=keys.device, dtype=keys.dtype)).to(torch.int32)


def _column_index(si, sj, nJ, tri, row_offset=0):
    """Slots of a chunk grouped by column tile, in slot order: ``(order,
    offsets)``. Column tile ``J`` sums the partials of
    ``order[offsets[J]:offsets[J+1]]``; dead and (``tri``) diagonal slots,
    ``J == row_offset + I``, are left out."""
    out = sj < 0
    if tri:
        out |= sj - row_offset == si
    key = torch.where(out, nJ, sj.long())
    key, order = torch.sort(key, stable=True)
    return order.to(torch.int32).contiguous(), _offsets(key, nJ).contiguous()


def _segment_sum(parts, index, out, L, nsub):
    """``out[g] += `` the sums of ``parts`` (``(n, nsub, L)`` float32) over
    the segments of ``index = (order, offsets)``."""
    order, offsets = index
    _LIB.launch(
        "segment_sum", parts.data_ptr(), order.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), out.shape[0], L, nsub,
    )


def _chunks(slot_i, slot_j, nI, nJ, tri, slot_bytes, row_offset=0):
    """The launches of kernel 5 or 6 over the slots of :func:`_live_slots`:
    ``(R, chunks, live)``, ``R`` slots of scratch, for each chunk ``(q0, n,
    row index, column index)``, and whether the chunks hold live slots
    only (the host read the live count). The row index sums a chunk's row
    partials into its row tiles (live slots are in row-major order), the
    column index its column partials into its column tiles; both leave the
    dead slots out.

    A table whose slots all fit :data:`TILES_SCRATCH_BYTES` is one launch
    over every slot, the dead ones returning at once: the host never waits
    (the sizes where the host sets the pace). A larger table reads its live
    count once and launches the live slots only, in chunks under the
    budget: there the device sets the pace, and dead slots cost no launch.
    """
    n = slot_i.shape[0]
    live = n * slot_bytes > TILES_SCRATCH_BYTES
    if live:
        n = int((slot_j >= 0).sum())
        profiling.count("host.reads")
    # Chunks of equal size up to one, at least one slot each:
    R = _even_chunks(max(n, 1), TILES_SCRATCH_BYTES // slot_bytes)
    ident = torch.arange(R, dtype=torch.int32, device=slot_i.device)
    out = []
    for q0 in range(0, n, R):
        si, sj = slot_i[q0 : min(q0 + R, n)], slot_j[q0 : min(q0 + R, n)]
        out.append((q0, si.shape[0], (ident, _offsets(si, nI)), _column_index(si, sj, nJ, tri, row_offset)))
    return R, out, live


def _count_slot_pairs(n, live, cnt, slot_j, tri, row_offset, tile):
    """Counts the point pairs of one launch of kernel 5 or 6 over ``n``
    slots: ``n`` tile pairs where they are all live (the host read the live
    count), else the table's live slots, a device sum once per table
    (while recording)."""
    if live:
        profiling.count("kernels.pairs", n * tile * tile)
    elif profiling.recording():
        live_slots = profiling.table_sum(cnt, ("live", tri, row_offset), lambda: (slot_j >= 0).sum())
        profiling.count("kernels.pairs", live_slots, tile * tile)


# ==============================================================================
#  CSR tables of kernels 8 and 12; walk tables
# ==============================================================================
#
# Kernels 8 and 12 read a table as ``rows = (cols, row_start, cnt)``, three
# int32 tensors: row tile I visits ``cols[row_start[I] + k]`` for ``k <
# cnt[I]``. A ``(cols, counts)`` table is that with ``row_start = I * ck``
# (:func:`_dense_rows`); a walk table decodes into it (:func:`_walk_rows`).

#: Row tiles per walk chunk (the JAX package's ``MAX_WALK_ROWS``, its SMEM
#: budget of one launch); the tables of :func:`walk_plan` carry it.
MAX_WALK_ROWS = 1024

#: Fields of a packed walk step: ``fl << 26 | row << 13 | jt``.
_WALK_BITS = 13
_WALK_MASK = (1 << _WALK_BITS) - 1


def _dense_rows(cols, cnt):
    """CSR form of a ``(cols, cnt)`` table, counts clamped at its width."""
    nI, width = cols.shape
    start = torch.arange(nI, dtype=torch.int32, device=cols.device) * width
    cnt = torch.clamp(cnt.to(device=cols.device, dtype=torch.int32), max=width)
    return cols.to(torch.int32).reshape(-1).contiguous(), start, cnt.contiguous()


def walk_plan(cols, counts, t_mean):
    """Pack a ``(cols, counts)`` table into the JAX package's per-chunk
    step lists, bit for bit: ``(nc, T_c)`` int32 with ``T_c = rows_c *
    t_mean`` and ``rows_c = min(nI, MAX_WALK_ROWS)``.

    Each step packs ``fl << 26 | row << 13 | jt``: ``fl`` 1 for the first
    step of a row, 0 for a continuation, 2 for dead padding (which repeats
    the chunk's last real step); ``row`` the row tile within its chunk;
    ``jt`` the column tile. A chunk keeping more than ``T_c`` tiles clips
    every row proportionally (each keeps at least its first tile); padded
    rows of the last chunk keep column tile 0. Raises ``ValueError`` where
    a row or column tile does not fit in 13 bits.
    """
    nI, cap = cols.shape
    rows_c = min(nI, MAX_WALK_ROWS)
    nc = _cdiv(nI, rows_c)
    nIp = nc * rows_c
    cols, counts = cols.to(torch.int32), counts.to(torch.int32)
    profiling.count("host.reads")
    if rows_c > 1 << _WALK_BITS or int(cols.max()) > _WALK_MASK:
        raise ValueError(f"walk_plan: row and column tiles must fit in {_WALK_BITS} bits.")
    if nIp != nI:
        cols = torch.nn.functional.pad(cols, (0, 0, 0, nIp - nI))
        counts = torch.nn.functional.pad(counts, (0, nIp - nI), value=1)
    T_c = rows_c * t_mean
    dev = cols.device

    cnt = counts.reshape(nc, rows_c)
    colc = cols.reshape(nc, rows_c * cap)
    tot = cnt.sum(dim=1)
    # The proportional clip, in float32 as in the JAX package:
    scale = (T_c - rows_c) / torch.clamp(tot - rows_c, min=1).to(torch.float32)
    clipped = 1 + ((cnt - 1).to(torch.float32) * torch.clamp(scale, max=1.0)[:, None]).to(torch.int32)
    cnt = torch.clamp(torch.where(tot[:, None] > T_c, clipped, cnt), max=cap).long()

    offs = torch.cumsum(cnt, dim=1) - cnt
    # Run starts; a start past the chunk's steps is dropped (an extra slot):
    ind = torch.zeros((nc, T_c + 1), dtype=torch.long, device=dev)
    ind.scatter_add_(1, torch.clamp(offs, max=T_c), torch.ones_like(offs))
    row = torch.cumsum(ind[:, :T_c], dim=1) - 1  # clamps at the chunk's end
    k = torch.arange(T_c, device=dev)[None, :] - offs.gather(1, row)
    cnt_r = cnt.gather(1, row)
    dead = k >= cnt_r
    jt = colc.gather(1, row * cap + torch.minimum(k, cnt_r - 1)).long()
    fl = torch.where(dead, 2, (k == 0).long())
    return ((fl << 26) | (row << _WALK_BITS) | jt).to(torch.int32)


def _walk_rows_plain(tbl, nI):
    """CSR form of a :func:`walk_plan` table of ``nI`` row tiles, in
    PyTorch on the table's device, without a device-to-host read: the flat
    column tiles, each row's first step (``fl == 1``) and its live steps
    (``fl != 2``), whose steps must be consecutive, as :func:`walk_plan`
    lays them out. The padded rows of the last chunk are left out; a row
    with no step keeps nothing. The CPU path of :func:`_walk_rows` and the
    reference of its kernel."""
    nc, T_c = tbl.shape
    rows_c = min(nI, MAX_WALK_ROWS)
    w = tbl.reshape(-1).to(torch.int32)
    fl = (w >> 26) & 3
    step = torch.arange(w.numel(), device=w.device)
    row = (step // max(T_c, 1)) * rows_c + ((w >> _WALK_BITS) & _WALK_MASK).long()
    live = (fl != 2) & (row < nI)
    cnt = torch.zeros(nI + 1, dtype=torch.int32, device=w.device)
    cnt.scatter_add_(0, torch.where(live, row, nI), live.to(torch.int32))
    start = torch.zeros(nI + 1, dtype=torch.long, device=w.device)
    start.scatter_(0, torch.where(live & (fl == 1), row, nI), step)
    return (w & _WALK_MASK).contiguous(), start[:nI].to(torch.int32).contiguous(), cnt[:nI].contiguous()


def _walk_rows(tbl, nI):
    """:func:`_walk_rows_plain`'s CSR form of a walk table: on a CUDA
    table one launch of the decode kernel (counted under
    ``"walk_rows"``), else the PyTorch form."""
    if not tbl.is_cuda:
        return _walk_rows_plain(tbl, nI)
    nc, T_c = tbl.shape
    w = tbl.to(torch.int32).contiguous()
    i32 = dict(dtype=torch.int32, device=tbl.device)
    cols, start, cnt = torch.empty(nc * T_c, **i32), torch.empty(nI, **i32), torch.empty(nI, **i32)
    with torch.cuda.device(tbl.device):
        _LIB.launch(
            "walk_rows", w.data_ptr(), cols.data_ptr(), start.data_ptr(), cnt.data_ptr(), nc, T_c,
            min(nI, MAX_WALK_ROWS), nI, count="walk_rows",
        )
    return cols, start, cnt


# ==============================================================================
#  Plain twins: a loop over row tiles, in the input dtype
# ==============================================================================


def _row_tiles(cols, cnt, tri, row_offset=0):
    """``(I, J)`` for each (local) row tile with kept tiles: ``J`` the kept
    column tiles (a long tensor on the CPU, in table order)."""
    slot_j = kept_pairs(cols.cpu(), cnt.cpu(), tri, row_offset).view(cols.shape).long()
    for I in range(cols.shape[0]):
        J = slot_j[I][slot_j[I] >= 0]
        if J.numel():
            yield I, J


def absorbed_sum_tiles_blocked(x, y, phi, psi, eps, cols, cnt, p=2, tile=512, tri=False, row_offset=0):
    """Plain twin of :func:`absorbed_sum_tiles`."""
    _check_table("absorbed_sum_tiles", x, y, cols, cnt, tile, tri, row_offset)
    dt = ck._acc(x, y, phi, psi)
    x, y = x.to(dt), y.to(dt)
    phi = _fold_norms(x, phi.to(dt), eps, p)
    psi = _fold_norms(y, psi.to(dt), eps, p)
    r = torch.zeros_like(phi).view(-1, tile)
    c = torch.zeros_like(psi).view(-1, tile)
    for I, J in _row_tiles(cols, cnt, tri, row_offset):
        rows = slice(I * tile, (I + 1) * tile)
        idx = (J.to(x.device)[:, None] * tile + torch.arange(tile, device=x.device)).view(-1)
        W = torch.exp(_log_weights_blk(x[rows], phi[rows], y[idx], psi[idx], eps, p))
        r[I] += W.sum(1)
        cs = W.sum(0).view(-1, tile)
        if tri:
            cs = torch.where((J == row_offset + I).to(x.device)[:, None], 0.0, cs)
        # Distinct column tiles within a row tile: a plain indexed update.
        c[J.to(x.device)] += cs
    return r.view(-1).to(phi.dtype), c.view(-1).to(psi.dtype)


def gibbs_apply_tiles_blocked(
    x, y, phi, psi, Vy, Vx, eps, cols, cnt, p=2, kind="gibbs", tile=512, tri=False, row_offset=0
):
    """Plain twin of :func:`gibbs_apply_tiles`."""
    _check_table("gibbs_apply_tiles", x, y, cols, cnt, tile, tri, row_offset)
    _check_kind(kind)
    dt = ck._acc(x, y, phi, psi, Vy, Vx)
    x, y, phi, psi, Vy, Vx = (t.to(dt) for t in (x, y, phi, psi, Vy, Vx))
    if p == 2:
        phi, psi = _fold_norms(x, phi, eps, 2), _fold_norms(y, psi, eps, 2)
    C = Vy.shape[1]
    Rr = torch.zeros((x.shape[0] // tile, tile, C), dtype=dt, device=x.device)
    Rc = torch.zeros((y.shape[0] // tile, tile, C), dtype=dt, device=x.device)
    for I, J in _row_tiles(cols, cnt, tri, row_offset):
        rows = slice(I * tile, (I + 1) * tile)
        idx = (J.to(x.device)[:, None] * tile + torch.arange(tile, device=x.device)).view(-1)
        w = _apply_weights_blk(x[rows], phi[rows], y[idx], psi[idx], eps, p, kind)
        Rr[I] += w @ Vy[idx]
        cs = (w.T @ Vx[rows]).view(-1, tile, C)
        if tri:
            cs = torch.where((J == row_offset + I).to(x.device)[:, None, None], 0.0, cs)
        Rc[J.to(x.device)] += cs
    return Rr.view(-1, C).to(Vy.dtype), Rc.view(-1, C).to(Vx.dtype)


def _check_sparse_table(name, x, y, cols, cnt, block_n, block_m):
    N, M = x.shape[0], y.shape[0]
    if block_n < 1 or block_m < 1 or N % block_n or M % block_m:
        raise ValueError(
            f"{name}: point counts ({N}, {M}) must be multiples of the tiles ({block_n}, {block_m})."
        )
    if cols.ndim != 2 or cols.shape[0] != N // block_n or tuple(cnt.shape) != (N // block_n,):
        raise ValueError(f"{name}: cols must be (N / block_n, ck) and cnt (N / block_n,).")


def _csr_rows(rows, block_m, device):
    """``(I, idx)`` for each row tile of a CSR table ``rows = (cols,
    row_start, cnt)``: ``idx`` the source points of its kept tiles, in
    table order."""
    cols, start, cnt = (t.cpu().long() for t in rows)
    lanes = torch.arange(block_m, device=device)
    for I in range(cnt.shape[0]):
        J = cols[start[I] : start[I] + cnt[I]].to(device)
        yield I, (J[:, None] * block_m + lanes).view(-1)


def lse_tiles_blocked(x, y, h, eps, cols, cnt, block_n, block_m, p=2):
    """Plain twin of :func:`lse_tiles`: a loop over row tiles, each a
    ``logsumexp`` over its gathered kept source tiles, in the input dtype."""
    _check_sparse_table("lse_tiles", x, y, cols, cnt, block_n, block_m)
    if tuple(h.shape) != (y.shape[0],):
        raise ValueError("lse_tiles: h must be (M,).")
    dt = ck._acc(x, y, h)
    x, y = x.to(dt), y.to(dt)
    h = _fold_norms(y, h.to(dt), eps, p)
    out = torch.empty(x.shape[0], dtype=dt, device=x.device)
    zero = torch.zeros(block_n, dtype=dt, device=x.device)
    for I, idx in _csr_rows(_dense_rows(cols, cnt), block_m, x.device):
        rows = slice(I * block_n, (I + 1) * block_n)
        arg = _log_weights_blk(x[rows], zero, y[idx], h[idx], eps, p)
        out[rows] = torch.logsumexp(arg, dim=1)
    # p=2: the row term -|x|^2/(2 eps) comes out of the LSE.
    return _fold_norms(x, out, eps, p)


def _apply_rows_blocked(x, y, phi, psi, V, eps, rows, p, kind, block_n, block_m):
    """Plain twin of kernel 8 over a CSR table: a loop over row tiles, each
    an apply of its gathered kept source tiles, in the input dtype."""
    dt = ck._acc(x, y, phi, psi, V)
    x, y, phi, psi, Va = (t.to(dt) for t in (x, y, phi, psi, V))
    if p == 2 and kind in ("gibbs", "gibbs_grad"):
        phi, psi = _fold_norms(x, phi, eps, 2), _fold_norms(y, psi, eps, 2)
    out = torch.zeros((x.shape[0], V.shape[1]), dtype=dt, device=x.device)
    for I, idx in _csr_rows(rows, block_m, x.device):
        sl = slice(I * block_n, (I + 1) * block_n)
        out[sl] = _apply_weights_blk(x[sl], phi[sl], y[idx], psi[idx], eps, p, kind) @ Va[idx]
    return out.to(V.dtype)


def _sum_rows_blocked(x, y, phi, psi, eps, rows, p, block_n, block_m):
    """Plain twin of kernel 12 over a CSR table: raw absorbed row sums, a
    loop over row tiles in the input dtype."""
    dt = ck._acc(x, y, phi, psi)
    x, y = x.to(dt), y.to(dt)
    phi = _fold_norms(x, phi.to(dt), eps, p)
    psi = _fold_norms(y, psi.to(dt), eps, p)
    out = torch.zeros(x.shape[0], dtype=dt, device=x.device)
    for I, idx in _csr_rows(rows, block_m, x.device):
        sl = slice(I * block_n, (I + 1) * block_n)
        out[sl] = torch.exp(_log_weights_blk(x[sl], phi[sl], y[idx], psi[idx], eps, p)).sum(1)
    return out.to(phi.dtype)


def gibbs_apply_sparse_blocked(
    x, y, phi, psi, V, eps, cols, counts, p=2, kind="gibbs", block_n=256, block_m=512
):
    """Plain twin of :func:`gibbs_apply_sparse`."""
    _check_apply("gibbs_apply_sparse", x, y, phi, psi, V, kind)
    _check_sparse_table("gibbs_apply_sparse", x, y, cols, counts, block_n, block_m)
    return _apply_rows_blocked(x, y, phi, psi, V, eps, _dense_rows(cols, counts), p, kind, block_n, block_m)


def gibbs_apply_walk_blocked(x, y, phi, psi, V, eps, tbl, p=2, kind="gibbs", block_n=512, block_m=512):
    """Plain twin of :func:`gibbs_apply_walk`."""
    _check_apply("gibbs_apply_walk", x, y, phi, psi, V, kind)
    rows = _walk_rows(tbl, _check_walk("gibbs_apply_walk", x, y, tbl, block_n, block_m))
    return _apply_rows_blocked(x, y, phi, psi, V, eps, rows, p, kind, block_n, block_m)


def absorbed_sum_sparse_blocked(x, y, phi, psi, eps, cols, counts, p=2, block=512):
    """Plain twin of :func:`absorbed_sum_sparse`."""
    _check_biases("absorbed_sum_sparse", x, y, phi, psi)
    _check_sparse_table("absorbed_sum_sparse", x, y, cols, counts, block, block)
    return _sum_rows_blocked(x, y, phi, psi, eps, _dense_rows(cols, counts), p, block, block)


def absorbed_sum_walk_blocked(x, y, phi, psi, eps, tbl, p=2, block=512):
    """Plain twin of :func:`absorbed_sum_walk`."""
    _check_biases("absorbed_sum_walk", x, y, phi, psi)
    rows = _walk_rows(tbl, _check_walk("absorbed_sum_walk", x, y, tbl, block, block))
    return _sum_rows_blocked(x, y, phi, psi, eps, rows, p, block, block)


def _check_kind(kind):
    if kind not in ("gibbs", "gibbs_grad"):
        raise ValueError(f"Unknown gibbs_apply_tiles kind: {kind!r}")


def _check_biases(name, x, y, phi, psi):
    if tuple(phi.shape) != (x.shape[0],) or tuple(psi.shape) != (y.shape[0],):
        raise ValueError(f"{name}: phi must be (N,) and psi (M,).")


def _check_apply(name, x, y, phi, psi, V, kind):
    ck._check_kind(kind)
    _check_biases(name, x, y, phi, psi)
    if V.ndim != 2 or V.shape[0] != y.shape[0]:
        raise ValueError(f"{name}: phi must be (N,), psi (M,) and V (M, C).")


def _check_walk(name, x, y, tbl, block_n, block_m):
    """Checks of a walk table's call; returns its row tiles ``N / block_n``."""
    N, M = x.shape[0], y.shape[0]
    if block_n < 1 or block_m < 1 or N % block_n or M % block_m:
        raise ValueError(
            f"{name}: point counts ({N}, {M}) must be multiples of the tiles ({block_n}, {block_m})."
        )
    nI = N // block_n
    if tbl.ndim != 2 or tbl.shape[0] != _cdiv(nI, min(nI, MAX_WALK_ROWS)):
        raise ValueError(f"{name}: tbl must be a walk_plan table of N / block_n row tiles, (nc, T_c).")
    return nI


# ==============================================================================
#  Kernel wrappers
# ==============================================================================


def _tables(name, x, y, cols, cnt, tile, tri, row_offset):
    """Checks, and the launch geometry: ``(slot_i, slot_j, nI, nJ, nsub)``."""
    _check_table(name, x, y, cols, cnt, tile, tri, row_offset)
    if tile % 128:
        raise NotImplementedError(f"{name}: the tile must be a multiple of 128 (got {tile}).")
    _check_cuda(name, x, y, cols, cnt)
    slot_i, slot_j = _live_slots(cols, cnt, tri, row_offset)
    return slot_i, slot_j, cols.shape[0], y.shape[0] // tile, _cdiv(tile, _ROWS)


def absorbed_sum_tiles(x, y, phi, psi, eps, cols, cnt, p=2, tile=512, tri=False, row_offset=0):
    """Absorbed row and column sums over the kept tile pairs of a table:

    ``r_i = sum_{j kept for i} W_ij``, ``c_j = sum_{i kept for j} W_ij``,
    ``W_ij = exp(phi_i + psi_j - C_p(x_i, y_j)/eps)``.

    Args: x ``(N, D)``, y ``(M, D)`` sorted and padded to multiples of
    ``tile``; phi ``(N,)``, psi ``(M,)``; cols ``(N/tile, ck)`` and cnt
    ``(N/tile,)`` the kept-tile table; ``tri`` a triangle table of a
    symmetric problem (``y`` is ``x``; ``r + c`` is then the full sum).
    ``row_offset``: the rows are the global row tiles ``row_offset + I`` of
    the symmetric problem (a shard of its triangle table, against the
    whole cloud ``y``): kept entries ``cols[I, k] >= row_offset + I``, the
    diagonal ``J == row_offset + I``. It changes nothing without ``tri``.
    Returns ``(r, c)`` in phi's and psi's dtype.
    """
    if not x.is_cuda:
        return absorbed_sum_tiles_blocked(x, y, phi, psi, eps, cols, cnt, p, tile, tri, row_offset)
    slot_i, slot_j, nI, nJ, nsub = _tables("absorbed_sum_tiles", x, y, cols, cnt, tile, tri, row_offset)
    _check_cuda("absorbed_sum_tiles", x, phi, psi)
    eps = float(eps)
    xv, yv, rb, cb, kv = _pair_vectors(x, y, phi, psi, eps, p)
    f32 = dict(dtype=torch.float32, device=x.device)
    R, chunks, live = _chunks(slot_i, slot_j, nI, nJ, tri, 4 * tile * (1 + nsub), row_offset)
    # Partials of one chunk of live slots, added into r and c in slot order
    # before the next chunk (deterministic, bounded):
    rowpart = torch.empty((R, 1, tile), **f32)
    colpart = torch.empty((R, nsub, tile), **f32)
    r = torch.zeros((nI, tile), **f32)
    c = torch.zeros((nJ, tile), **f32)
    with torch.cuda.device(x.device):
        for q0, n, rows, cols_ix in chunks:
            _LIB.launch(
                "absorbed_sum_tiles", xv.data_ptr(), yv.data_ptr(), rb.data_ptr(),
                cb.data_ptr(), slot_i[q0:].data_ptr(), slot_j[q0:].data_ptr(),
                rowpart.data_ptr(), colpart.data_ptr(), n, tile, kv, p, int(tri), row_offset, LOG2E / eps,
                count="absorbed_sum_tiles",
            )
            _count_slot_pairs(n, live, cnt, slot_j, tri, row_offset, tile)
            _segment_sum(rowpart, rows, r, tile, 1)
            _segment_sum(colpart, cols_ix, c, tile, nsub)
    return r.view(-1).to(phi.dtype), c.view(-1).to(psi.dtype)


_APPLY_MODES = {("gibbs", 2): 0, ("gibbs_grad", 2): 0, ("gibbs", 1): 1, ("gibbs_grad", 1): 2}


def gibbs_apply_tiles(
    x, y, phi, psi, Vy, Vx, eps, cols, cnt, p=2, kind="gibbs", tile=512, tri=False, row_offset=0
):
    """Both contractions of the raw absorbed weights over the kept pairs:

    ``R_row[i] = sum_{j kept for i} w_ij Vy[j]`` and
    ``R_col[j] = sum_{i kept for j} w_ij Vx[i]``, with
    ``w_ij = exp(phi_i + psi_j - C_p(x_i, y_j)/eps)`` (``kind='gibbs'``),
    divided by ``|x_i - y_j|`` for p=1 ``kind='gibbs_grad'`` (zero below
    a squared distance of 1e-6).

    Args: as :func:`absorbed_sum_tiles` (``row_offset`` included), plus
    Vy ``(M, C)`` and Vx ``(N, C)``; channels go through the kernel in
    groups of four.
    Returns ``(R_row (N, C), R_col (M, C))`` in Vy's and Vx's dtype.
    """
    _check_kind(kind)
    if not x.is_cuda:
        return gibbs_apply_tiles_blocked(x, y, phi, psi, Vy, Vx, eps, cols, cnt, p, kind, tile, tri, row_offset)
    slot_i, slot_j, nI, nJ, nsub = _tables("gibbs_apply_tiles", x, y, cols, cnt, tile, tri, row_offset)
    _check_cuda("gibbs_apply_tiles", x, phi, psi, Vy, Vx)
    C = Vy.shape[1]
    if Vx.shape != (x.shape[0], C) or Vy.shape[0] != y.shape[0]:
        raise ValueError("gibbs_apply_tiles: Vy must be (M, C) and Vx (N, C).")
    mode = _APPLY_MODES[(kind, p)]
    eps = float(eps)
    xv, yv, rb, cb, kv = _pair_vectors(x, y, phi, psi, eps, 2 if mode == 0 else 1)
    G = ck._CHANNELS
    Cp = _cdiv(C, G) * G
    Vyp = torch.nn.functional.pad(_f32(Vy), (0, Cp - C))
    Vxp = torch.nn.functional.pad(_f32(Vx), (0, Cp - C))
    f32 = dict(dtype=torch.float32, device=x.device)
    R, chunks, live = _chunks(slot_i, slot_j, nI, nJ, tri, 4 * G * tile * (1 + nsub), row_offset)
    rowpart = torch.empty((R, 1, tile * G), **f32)
    colpart = torch.empty((R, nsub, G * tile), **f32)
    rows_out, cols_out = [], []
    with torch.cuda.device(x.device):
        for c0 in range(0, Cp, G):
            vy = Vyp[:, c0 : c0 + G].contiguous()
            vx = Vxp[:, c0 : c0 + G].contiguous()
            r = torch.zeros((nI, tile * G), **f32)
            c = torch.zeros((nJ, G * tile), **f32)
            for q0, n, rows, cols_ix in chunks:
                _LIB.launch(
                    "gibbs_apply_tiles", xv.data_ptr(), yv.data_ptr(), rb.data_ptr(),
                    cb.data_ptr(), vy.data_ptr(), vx.data_ptr(),
                    slot_i[q0:].data_ptr(), slot_j[q0:].data_ptr(), rowpart.data_ptr(),
                    colpart.data_ptr(), n, tile, kv, mode, int(tri), row_offset, LOG2E / eps,
                    count="gibbs_apply_tiles",
                )
                _count_slot_pairs(n, live, cnt, slot_j, tri, row_offset, tile)
                _segment_sum(rowpart, rows, r, tile * G, 1)
                _segment_sum(colpart, cols_ix, c, G * tile, nsub)
            rows_out.append(r.view(-1, G))
            cols_out.append(c.view(nJ, G, tile).transpose(1, 2).reshape(-1, G))
    R_row = torch.cat(rows_out, dim=1)[:, :C]
    R_col = torch.cat(cols_out, dim=1)[:, :C]
    return R_row.to(Vy.dtype), R_col.to(Vx.dtype)


def lse_tiles_plan(n_rows, block_n, width, N):
    """Ranges of kept tiles of kernel 7 over a table of ``n_rows`` row
    tiles of ``block_n`` points and ``width`` columns, ``N`` rows in all:
    ``(S, span)``. Block ``(I, h, q)`` takes the kept tiles ``q span ..
    (q + 1) span - 1`` of row tile ``I`` (those below its count), so a
    launch holds about :data:`_LSE_TILES_BLOCKS` blocks where the width
    allows and no block more than ``span`` kept tiles. With more than one
    range, each writes its rows' (max, sum) pairs, ``8 S N`` bytes of
    scratch, at most ``cuda_kernels.STEP_SCRATCH_BYTES``. Read from the
    width alone: the host never waits for the counts."""
    blocks = n_rows * _cdiv(block_n, _ROWS)
    S = max(1, min(width, _cdiv(_LSE_TILES_BLOCKS, blocks), ck._MAX_GRID_Y, ck.STEP_SCRATCH_BYTES // (8 * N)))
    span = max(1, _cdiv(width, S))
    return max(1, _cdiv(width, span)), span


def _lse_launch(x, y, h, eps, cols, cnt, block_n, block_m, p, count):
    _check_sparse_table(count, x, y, cols, cnt, block_n, block_m)
    if tuple(h.shape) != (y.shape[0],):
        raise ValueError(f"{count}: h must be (M,).")
    _check_cuda(count, x, y, h, cols, cnt)
    eps = float(eps)
    (xf, yf), ld, kv = ck._lse_points(count, x, y, p=p)
    hf = _f32(h)
    cols_i = cols.to(torch.int32).contiguous()
    cnt_i = cnt.to(torch.int32).contiguous()
    N = xf.shape[0]
    n_rows, width = cols.shape
    S, span = lse_tiles_plan(n_rows, block_n, width, N)
    out = torch.empty(N, dtype=torch.float32, device=x.device)
    part = torch.empty((S, N, 2), dtype=torch.float32, device=x.device) if S > 1 else out
    with torch.cuda.device(x.device):
        _LIB.launch(
            "lse_tiles", xf.data_ptr(), yf.data_ptr(), hf.data_ptr(), cols_i.data_ptr(), cnt_i.data_ptr(),
            out.data_ptr(), part.data_ptr(), n_rows, width, block_n, block_m, S, span, ld, x.shape[1], kv, p,
            LOG2E / eps, count=count,
        )
    if profiling.recording():
        profiling.count("kernels.pairs", profiling.kept_tiles(cnt, width), block_n * block_m)
    return out.to(x.dtype)


def lse_tiles(x, y, h, eps, cols, cnt, block_n, block_m, p=2):
    """Truncated LSE over the kept source tiles of each row tile:

    ``out_i = log sum_{j in kept tiles of I} exp(h_j - C_p(x_i, y_j)/eps)``
    for row ``i`` of row tile ``I``, the kept tiles being
    ``cols[I, k]``, ``k < cnt[I]`` (every count at least 1).

    Args: x ``(N, D)`` rows in tiles of ``block_n`` points, y ``(M, D)``
    sources in tiles of ``block_m`` points, h ``(M,)``; cols
    ``(N / block_n, ck)`` and cnt ``(N / block_n,)`` the table.
    Returns ``(N,)`` in x's dtype.
    """
    if not x.is_cuda:
        return lse_tiles_blocked(x, y, h, eps, cols, cnt, block_n, block_m, p)
    return _lse_launch(x, y, h, eps, cols, cnt, block_n, block_m, p, "lse_tiles")


def lse_sparse(x, y, h, eps, cols, counts, p=2, block_n=256, block_m=512):
    """The truncated LSE of the JAX package's ``lse_sparse`` (argument
    order and defaults included): :func:`lse_tiles`'s function over the
    same table, launched on the same CUDA kernel and counted under
    ``"lse_sparse"``."""
    if not x.is_cuda:
        return lse_tiles_blocked(x, y, h, eps, cols, counts, block_n, block_m, p)
    return _lse_launch(x, y, h, eps, cols, counts, block_n, block_m, p, "lse_sparse")


def gibbs_apply_sparse(
    x, y, phi, psi, V, eps, cols, counts, p=2, kind="gibbs", block_n=256, block_m=512
):
    """Truncated ``O_i = sum_j w_ij V_j`` over the kept source tiles of each
    row tile, ``cols[I, k]`` for ``k < counts[I]``, with the weight kinds
    of :func:`geomloss_tpu_torch.ops.softmin.gibbs_apply`: ``gibbs``,
    ``gibbs_grad`` (p in {1, 2}), ``energy`` and ``inv_dist``.

    Args: x ``(N, D)`` rows in tiles of ``block_n`` points, y ``(M, D)``
    sources in tiles of ``block_m`` points, phi ``(N,)``, psi ``(M,)``,
    V ``(M, C)``; cols ``(N / block_n, ck)`` and counts ``(N / block_n,)``
    the table. One channel goes through the kernel alone, more in groups
    of four.
    Returns ``(N, C)`` in V's dtype.
    """
    _check_apply("gibbs_apply_sparse", x, y, phi, psi, V, kind)
    _check_sparse_table("gibbs_apply_sparse", x, y, cols, counts, block_n, block_m)
    if not x.is_cuda:
        return gibbs_apply_sparse_blocked(x, y, phi, psi, V, eps, cols, counts, p, kind, block_n, block_m)
    _check_cuda("gibbs_apply_sparse", x, y, phi, psi, V, cols, counts)
    kept = profiling.kept_tiles(counts, cols.shape[1]) if profiling.recording() else None
    return _apply_rows(x, y, phi, psi, V, eps, _dense_rows(cols, counts), p, kind, block_n, block_m,
                       "gibbs_apply_sparse", kept)


def gibbs_apply_walk(x, y, phi, psi, V, eps, tbl, p=2, kind="gibbs", block_n=512, block_m=512):
    """:func:`gibbs_apply_sparse`'s function over a :func:`walk_plan`
    table ``tbl`` (the JAX package's ``gibbs_apply_walk``, argument order
    and defaults included): the table is decoded on the device
    (:func:`_walk_rows`) and kernel 8's CUDA kernel runs over it, counted
    under ``"gibbs_apply_walk"``. Rows the walk's budget clipped visit
    their kept tiles only."""
    _check_apply("gibbs_apply_walk", x, y, phi, psi, V, kind)
    nI = _check_walk("gibbs_apply_walk", x, y, tbl, block_n, block_m)
    if not x.is_cuda:
        return gibbs_apply_walk_blocked(x, y, phi, psi, V, eps, tbl, p, kind, block_n, block_m)
    _check_cuda("gibbs_apply_walk", x, y, phi, psi, V, tbl)
    rows = _walk_rows(tbl, nI)
    return _apply_rows(x, y, phi, psi, V, eps, rows, p, kind, block_n, block_m, "gibbs_apply_walk",
                       _walk_kept(tbl, rows))


def _walk_kept(tbl, rows):
    """The kept tiles of a decoded walk table, a device sum once per table
    (while recording), else ``None``."""
    return profiling.table_sum(tbl, "kept", lambda: rows[2].sum()) if profiling.recording() else None


def _apply_rows(x, y, phi, psi, V, eps, rows, p, kind, block_n, block_m, count, kept=None, order=None):
    """Kernel 8 over a CSR table, one launch per channel group
    (``cuda_kernels._group_channels``), each row's kept tiles cut into
    :func:`sum_rows_plan`'s ranges (merged in the launch), the row tiles in
    order of decreasing kept count (a sort on the device), or in
    ``order``. ``kept``, the table's kept tiles (a 0-d device tensor, while
    recording), counts each launch's point pairs."""
    mode = ck._APPLY_MODES[(kind, p)]
    eps = float(eps)
    xv, yv, rb, cb, kv = _pair_vectors(x, y, phi, psi, eps, 2 if mode == 0 else 1)
    v = _group_channels(V)
    ng, _, G = v.shape
    cols, start, cnt = rows
    N, n_rows = x.shape[0], cnt.shape[0]
    if order is None:
        order = torch.argsort(cnt, descending=True, stable=True).to(torch.int32)
    S = sum_rows_plan(n_rows, block_n, N, G)
    c2 = LOG2E / eps if mode <= 2 else 0.0
    out = torch.empty((ng, N, G), dtype=torch.float32, device=x.device)
    part = torch.empty((S, N, G), dtype=torch.float32, device=x.device) if S > 1 else out
    with torch.cuda.device(x.device):
        for g in range(ng):
            _LIB.launch(
                "gibbs_apply_sparse", xv.data_ptr(), yv.data_ptr(), rb.data_ptr(), cb.data_ptr(),
                v[g].data_ptr(), cols.data_ptr(), start.data_ptr(), cnt.data_ptr(), order.data_ptr(),
                out[g].data_ptr(), part.data_ptr(), n_rows, block_n, block_m, S, kv, G, mode, c2, count=count,
            )
            if kept is not None:
                profiling.count("kernels.pairs", kept, block_n * block_m)
    return _ungroup_channels(out, V.shape[1]).to(V.dtype)


def sum_rows_plan(n_rows, block_n, N, C=1):
    """Ranges of kernels 12 and 8 over a table of ``n_rows`` row tiles of
    ``block_n`` points, ``N`` rows in all: ``S``. Block ``(I, h, q)`` takes
    the kept tiles ``floor(q c / S) .. floor((q + 1) c / S) - 1`` of row
    tile ``I``, ``c`` its count, so a launch holds about
    :data:`_SUM_BLOCKS` blocks where the rows are short of it and every
    row is cut into ``S`` ranges of about equal length. With ``S > 1``,
    each range writes its rows' partials of ``C`` channels, ``4 S N C``
    bytes of scratch, at most ``cuda_kernels.STEP_SCRATCH_BYTES``. Read
    from the shapes alone, which a ``(cols, counts)`` table and its walk
    share: the host never waits for the counts, and the two forms cut
    their rows alike."""
    blocks = n_rows * _cdiv(block_n, _ROWS)
    scratch = ck.STEP_SCRATCH_BYTES // (4 * C * max(N, 1))
    return max(1, min(_cdiv(_SUM_BLOCKS, max(blocks, 1)), ck._MAX_GRID_Y, scratch))


def _sum_rows(x, y, phi, psi, eps, rows, p, block_n, block_m, count, kept=None):
    """Kernel 12 over a CSR table: raw absorbed row sums, float32, one
    launch and, where :func:`sum_rows_plan` cuts the rows into ranges,
    their merge; ``kept`` as :func:`_apply_rows`'."""
    eps = float(eps)
    xv, yv, rb, cb, kv = _pair_vectors(x, y, phi, psi, eps, p)
    cols, start, cnt = rows
    N, n_rows = x.shape[0], cnt.shape[0]
    S = sum_rows_plan(n_rows, block_n, N)
    out = torch.empty(N, dtype=torch.float32, device=x.device)
    part = torch.empty((S, N), dtype=torch.float32, device=x.device) if S > 1 else out
    with torch.cuda.device(x.device):
        _LIB.launch(
            "absorbed_sum_sparse", xv.data_ptr(), yv.data_ptr(), rb.data_ptr(), cb.data_ptr(),
            cols.data_ptr(), start.data_ptr(), cnt.data_ptr(), out.data_ptr(), part.data_ptr(), n_rows,
            block_n, block_m, S, kv, p, LOG2E / eps, count=count,
        )
    if kept is not None:
        profiling.count("kernels.pairs", kept, block_n * block_m)
    return out.to(phi.dtype)


def absorbed_sum_sparse(x, y, phi, psi, eps, cols, counts, p=2, block=512):
    """Absorbed row sums over the kept tiles of a ``(cols, counts)`` table:

    ``r_i = sum_{j kept for i} exp(phi_i + psi_j - C_p(x_i, y_j)/eps)``,
    row tile ``I`` keeping the column tiles ``cols[I, k]``, ``k <
    counts[I]``, tiles of ``block`` points on both sides. Raw sums, no
    floor and no max pass (the JAX package's ``_absorbed_sum`` returns them
    floored at 1e-37).

    Args: x ``(N, D)``, y ``(M, D)``, phi ``(N,)``, psi ``(M,)``; cols
    ``(N / block, ck)`` and counts ``(N / block,)``; any point dimension
    and any ``block`` that divides N and M.
    Returns ``(N,)`` in phi's dtype.
    """
    _check_biases("absorbed_sum_sparse", x, y, phi, psi)
    _check_sparse_table("absorbed_sum_sparse", x, y, cols, counts, block, block)
    if not x.is_cuda:
        return absorbed_sum_sparse_blocked(x, y, phi, psi, eps, cols, counts, p, block)
    _check_cuda("absorbed_sum_sparse", x, y, phi, psi, cols, counts)
    kept = profiling.kept_tiles(counts, cols.shape[1]) if profiling.recording() else None
    return _sum_rows(x, y, phi, psi, eps, _dense_rows(cols, counts), p, block, block, "absorbed_sum_sparse", kept)


def absorbed_sum_walk(x, y, phi, psi, eps, tbl, p=2, block=512):
    """:func:`absorbed_sum_sparse`'s function over a :func:`walk_plan`
    table ``tbl`` (the JAX package's ``_absorbed_sum_walk``, without its
    floor): the table is decoded on the device (:func:`_walk_rows`) and
    kernel 12's CUDA kernel runs over it, counted under
    ``"absorbed_sum_walk"``."""
    _check_biases("absorbed_sum_walk", x, y, phi, psi)
    nI = _check_walk("absorbed_sum_walk", x, y, tbl, block, block)
    if not x.is_cuda:
        return absorbed_sum_walk_blocked(x, y, phi, psi, eps, tbl, p, block)
    _check_cuda("absorbed_sum_walk", x, y, phi, psi, tbl)
    rows = _walk_rows(tbl, nI)
    return _sum_rows(x, y, phi, psi, eps, rows, p, block, block, "absorbed_sum_walk", _walk_kept(tbl, rows))
