r"""Block-sparse kernel truncation of the multiscale fine phase.

Counterpart of :mod:`geomloss_tpu.ops.block_sparse` for the multiscale
paths. Points are spatially sorted and cut into fixed kernel tiles; each
row tile ``I`` keeps the column tiles of a top-k keep score
(``masks_from_coarse`` on the coarse state, ``build_tile_masks`` on the
fine potentials of the mid path), and the fine Sinkhorn steps and the last
extrapolation visit the kept tile pairs only. The mid path's detached
extrapolations onto the fine cloud visit the source tiles that
``extrap_cols`` keeps (kernel 7, ``softmin_extrap_truncated``); custom
costs run a gather-based truncated LSE with no kernel
(``lse_sparse_custom``). The truncated MMD losses keep tile pairs by a
pure distance rule (``masks_from_geometry``) and apply their kernel over
the kept pairs (``kernel_matvec_sparse``, kernel 8); ``softmin_sparse`` is
the differentiable truncated softmin over the same kind of table (kernel 7
forward, kernel 8 backward).

A table is a pair ``(cols, cnt)``: ``cols`` ``(nI, ck)`` int32 holds each
row tile's column tiles in keep-score order and row tile ``I`` visits the
first ``cnt[I]`` of them. The JAX package packs the same tables into
band-major step lists for the TPU's sequential grid (``walk_plan_banded``);
the CUDA kernels (:mod:`.cuda_block_sparse`) walk the CSR lists directly,
so that packing has no counterpart, and neither have the TPU's budget
limits on the tables (``MAX_TABLE_ROWS`` and the SMEM clamps on ``cap`` of
``build_tile_masks`` and ``masks_from_geometry``). On the multiscale
paths every kept tile is visited: the per-chunk step budget of
``walk_plan``, which clips kept tiles when a chunk of rows keeps more than
its mean budget, has no counterpart there, and a table built with no
``cap`` is as wide as its largest kept count (:func:`kept_width`), where
the JAX package's default widths keep each row's best-scored tiles.

The public block-sparse Sinkhorn ops of the JAX package have their
counterparts too (kernels 10-12): ``sinkhorn_step_sparse`` and the
``softmin_extrapolation_sparse`` family over ``(cols, counts)`` tables,
``sinkhorn_step_walk`` and the ``softmin_extrapolation_walk`` family over
:func:`walk_plan` tables. A walk table is the JAX package's table format,
built bit for bit as there, budget included: the walk ops honour its clip.
The function names follow the JAX package's, ``walk_banded`` included, so
that each counterpart can be found.
"""

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..utils import profiling
from . import cuda_block_sparse as cbs
from .cuda_kernels import SUM_FLOOR, _absorbed_update
from .costs import cost_routines

__all__ = [
    "TileMask",
    "tile_stats",
    "masks_from_geometry",
    "lse_sparse",
    "gibbs_apply_sparse",
    "softmin_sparse",
    "kernel_matvec_sparse",
    "retighten_counts",
    "masks_from_coarse",
    "build_tile_masks",
    "keep_slack",
    "extrap_cols",
    "extrap_cap",
    "kept_width",
    "softmin_extrap_truncated",
    "lse_sparse_custom",
    "sinkhorn_step_walk_banded",
    "sinkhorn_step_walk_banded_sym",
    "softmin_extrapolation_walk_banded",
    "softmin_extrapolation_walk_banded_sym",
    "sinkhorn_step_sparse",
    "softmin_extrapolation_sparse",
    "softmin_extrapolation_sparse_sym",
]

NEG_INF = -1e30

#: Bound on the sub-blocks of the tile-geometry statistics: keep scores are
#: built at sub-block granularity (``(n_stat, n_stat)``) and max-pooled to
#: kernel tiles.
MAX_STAT_BLOCKS = 8192

#: Elements of the packed cost block that one chunk of
#: :func:`lse_sparse_custom` evaluates (row tiles x tile x kept columns).
CUSTOM_CHUNK_ELEMS = 1 << 24


class TileMask(NamedTuple):
    """Block-sparsity pattern of a truncated pairwise interaction.

    ``cols/counts`` drive the row-major traversal (reduce over y for each x
    tile); ``colsT/countsT`` the transposed one. ``vals/valsT`` are the
    sorted keep scores behind ``cols`` — they let :func:`retighten_counts`
    re-threshold the same tables at later annealing temperatures.
    """

    cols: torch.Tensor  # (N/bn, cap) int32
    counts: torch.Tensor  # (N/bn,) int32
    colsT: torch.Tensor  # (M/bm, capT) int32
    countsT: torch.Tensor  # (M/bm,) int32
    vals: torch.Tensor = None  # (N/bn, cap) keep scores (sorted desc)
    valsT: torch.Tensor = None  # (M/bm, capT)

    def transpose(self):
        """The same pattern for the (y-rows, x-cols) direction."""
        return TileMask(
            cols=self.colsT, counts=self.countsT, colsT=self.cols, countsT=self.counts,
            vals=self.valsT, valsT=self.vals,
        )


def tile_stats(x, block):
    """Per-tile centroids ``(N/block, D)`` and radii ``(N/block,)`` of a
    (padded) sorted point cloud, ``N`` a multiple of ``block``."""
    N, D = x.shape
    xt = x.reshape(N // block, block, D)
    cent = xt.mean(dim=1)
    rad = torch.sqrt(((xt - cent[:, None, :]) ** 2).sum(-1)).amax(dim=1)
    return cent, rad


def _cols_from_score(score, cap):
    """Top-``cap`` column tiles of each row of a keep score.

    The order is a stable descending sort, which breaks ties towards the
    lower column index as ``lax.top_k`` does, so the tables equal the JAX
    package's bit for bit. Entries past the kept count repeat the last
    kept tile.
    """
    cap = min(cap, score.shape[1])
    vals, idx = torch.sort(score, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :cap], idx[:, :cap]
    counts = torch.clamp((vals > 0).sum(dim=1), min=1)
    last = idx.gather(1, (counts - 1)[:, None])
    cols = torch.where(vals > 0, idx, last).to(torch.int32)
    return cols, counts.to(torch.int32), vals


def _tile_mask(score, cap, sym):
    """The :class:`TileMask` of a tile keep score (``> 0``: kept), ``cap``
    tiles wide in both directions; ``sym``: the transposed table is the same
    table. Counted as one table built (``tables.row_tiles``,
    ``tables.kept_tiles``: its row direction)."""
    cols, counts, vals = _cols_from_score(score, cap)
    if sym:
        colsT, countsT, valsT = cols, counts, vals
    else:
        colsT, countsT, valsT = _cols_from_score(score.T, cap)
    profiling.count_table(counts, cols.shape[1])
    return TileMask(cols=cols, counts=counts, colsT=colsT, countsT=countsT, vals=vals, valsT=valsT)


def kept_width(score, floor, transposed=True):
    """Default width of a table over the keep scores ``score`` (``> 0``:
    kept): ``floor``, or, where a row (or, with ``transposed``, a column)
    keeps more tiles, that count rounded up to a multiple of 8, so that no
    kept tile is dropped. One host read (counted as ``host.reads``).

    The JAX package's default widths are the floors alone, and a row that
    keeps more keeps its best-scored tiles. Dropping the others gave wrong
    values: data along curves keeps many more tiles a row than surfaces do
    (the gallery's fiber bundles), and the gaussian MMD's geometry tables,
    clipped at their floor of 8 on two spheres of 8,192 points, put the
    loss 148 % off the exact one (``tests/test_torch_table_widths.py``).
    Where every row fits the floor, the tables are the JAX package's.
    """
    kept = score > 0
    most = kept.sum(1).max()
    if transposed:
        most = torch.maximum(most, kept.sum(0).max())
    profiling.count("host.reads")
    return max(floor, -(-int(most) // 8) * 8)


def retighten_counts(vals, delta):
    """Per-row kept-tile counts after shifting every keep score by ``delta``.

    The truncation score moves by a *uniform* ``truncate * (eps' - eps)``
    when the temperature changes, so the order of ``cols`` is unchanged and
    only the threshold moves: the same tables serve every annealing step.
    """
    return torch.clamp((vals + delta > 0).sum(dim=1), min=1).to(torch.int32)


def _stat_block(npad, block):
    """Sub-block size of the keep-score geometry: 64 points, doubled until
    at most :data:`MAX_STAT_BLOCKS` sub-blocks, and never above the tile.

    Sub-blocks are tight along the space-filling curve, where a few seam
    tiles span two far-apart patches: a tile-level centroid bound would be
    vacuous there and let the top-k keep an arbitrary tile set.
    """
    sb = 64
    while npad // sb > MAX_STAT_BLOCKS:
        sb *= 2
    return min(sb, block)


def _tile_maxpool(score, bpt):
    """Max-pool an ``(nI bpt, nJ bpt)`` sub-block score to ``(nI, nJ)`` tiles."""
    if bpt == 1:
        return score
    nI, nJ = score.shape[0] // bpt, score.shape[1] // bpt
    return score.reshape(nI, bpt, nJ, bpt).amax(dim=(1, 3))


def _sq_centroids(cx, cy):
    """Squared distances between centroids, in the expansion form of the
    JAX package (so that the keep scores are the same numbers)."""
    return (cx**2).sum(-1)[:, None] + (cy**2).sum(-1)[None, :] - 2.0 * (cx @ cy.T)


def _pair_dist_lb(cx, rx, cy, ry):
    """Lower bound on the pointwise distances between two block partitions:
    centroid distance minus the two radii, clipped at 0."""
    dist = torch.sqrt(torch.clamp(_sq_centroids(cx, cy), min=1e-12))
    return torch.clamp(dist - rx[:, None] - ry[None, :], min=0.0)


def _seam_cost(C, cx, rx, cy, ry, s, p):
    """The keep rules' cost between two block partitions: ``C``, the cost
    at the centroids' distance, where neither block's radius passes the
    slack ``s``; elsewhere ``C(d)``, ``d`` the centroids' distance less the
    part of each radius beyond ``s``, clipped at 0."""
    over_x, over_y = torch.clamp(rx - s, min=0.0), torch.clamp(ry - s, min=0.0)
    d = torch.sqrt(torch.clamp(_sq_centroids(cx, cy), min=1e-12))
    d = d.sub_(over_x[:, None]).sub_(over_y[None, :]).clamp_(min=0.0)
    return torch.where((over_x > 0)[:, None] | (over_y > 0)[None, :], d * d / 2 if p == 2 else d, C)


def masks_from_coarse(
    cx, cy, f_c, g_c, w_x, w_y, eps, p, truncate, blocks_per_tile, cap=None, sym=False,
    cost=None, r_x=None, r_y=None, eps_min=None,
):
    """Tile masks of the classic path from the coarse state: the
    reference's pointwise keep rule on the cluster blocks, less the seam
    radii.

    A pair of cluster blocks ``(k, l)`` scores ``f_c[k] + g_c[l] - C(d) +
    truncate * eps``, max-pooled onto kernel tiles of ``blocks_per_tile``
    consecutive blocks. ``d`` is the distance of the blocks' centroids less
    the part of each block's radius (``r_x``, ``r_y``) beyond the slack
    ``s`` (:func:`keep_slack` at ``eps_min``), clipped at 0. Where neither
    radius passes ``s``, ``C(d)`` is the JAX package's centroid cost to the
    bit; with no radii, or ``eps_min = math.inf``, the tables are the JAX
    package's rule.

    Guarantee: for every point pair ``(i, j)`` of a dropped tile pair,
    ``i`` of block ``k`` and ``j`` of block ``l``, ``f_c[k] + g_c[l] -
    C(|x_i - y_j| + 2 s) <= -truncate * eps``, since ``|x_i - y_j| >= d -
    2 s`` (the radii bound every point of positive weight). So the coarse
    potentials, read on the blocks' points, keep every point pair the
    pointwise rule keeps, up to the slack: at p = 1 the best pointwise
    score lies at most ``2 s = truncate * eps_min`` above ``-truncate *
    eps``; at p = 2 at most ``2 s (|x_i - y_j| + s)`` above it, as in
    :func:`build_tile_masks`. The cluster blocks are ``block_size``
    consecutive points of the sort order, and one that straddles a jump of
    it (a seam) has its centroid far from all its points: the centroid rule
    alone scored its nearest tiles below zero at any table width (1.78 eps
    off the solve that keeps every tile on the gallery's fiber bundles at
    8,160 points and tile 32, ``tools/mid_keep_rule_torch.py``; 1.07 eps on
    the label transfer at 1,000,020 points on an H100).

    A custom ``cost`` callable (``(B, N, D), (B, M, D) -> (B, N, M)``) is
    evaluated between the centroids, as the reference's custom-cost
    truncation does, and keeps the centroid rule (the radii are not read):
    a user cost gives no bound in the distance.

    Args:
        cx, cy: ``(K_x, D)`` / ``(K_y, D)`` block centroids (sorted order).
        f_c, g_c: coarse dual potentials on the centroids.
        w_x, w_y: coarse block weights (zero = padding, never kept).
        blocks_per_tile: tile // block_size.
        cap: bound on kept column tiles per row tile; a row that keeps
            more keeps its best-scored ``cap`` (default: an eighth of the
            column tiles, between 32 and 128, widened by
            :func:`kept_width` to the largest kept count).
        sym: the problem is symmetric (``cy is cx``, ``g_c is f_c``): the
            transposed table is the same table.
        r_x, r_y: ``(K_x,)`` / ``(K_y,)`` block radii, the largest distance
            of a point of positive weight to its block's centroid
            (``models/multiscale.py::block_radii``); ``None``: the JAX
            package's centroid rule.
        eps_min: the finest temperature the table serves (default
            ``eps``): ``s`` depends on it alone, so that
            :func:`retighten_counts`' shift stays uniform.

    Returns:
        :class:`TileMask`.
    """
    C = cost_routines[p](cx, cy) if cost is None else cost(cx[None], cy[None])[0]
    if cost is None and r_x is not None:
        C = _seam_cost(C, cx, r_x, cy, r_y, keep_slack(eps if eps_min is None else eps_min, p, truncate), p)
    score = f_c[:, None] + g_c[None, :] - C + truncate * eps
    valid = (w_x > 0)[:, None] & (w_y > 0)[None, :]
    score = torch.where(valid, score, torch.full_like(score, NEG_INF))
    Kx, Ky = score.shape
    nI, nJ = Kx // blocks_per_tile, Ky // blocks_per_tile
    score_t = score.reshape(nI, blocks_per_tile, nJ, blocks_per_tile).amax(dim=(1, 3))
    if cap is None:
        cap = kept_width(score_t, max(32, min(nJ // 8, 128)))
    return _tile_mask(score_t, cap, sym)


def keep_slack(eps_min, p, truncate):
    """Slack of :func:`build_tile_masks`' keep rule: half the keep radius
    at ``eps_min``, the distance ``C^-1(truncate * eps_min)`` (``sqrt(2
    truncate eps_min)`` at p = 2, ``truncate * eps_min`` at p = 1).
    ``eps_min = math.inf`` gives an infinite slack."""
    return 0.5 * (math.sqrt(2.0 * truncate * eps_min) if p == 2 else truncate * eps_min)


def build_tile_masks(x, y, f, g, eps, p, truncate, block, cap=None, w_x=None, w_y=None, sym=False, floor=None,
                     eps_min=None):
    """Both traversal directions of the truncation pattern of the mid path,
    from the fine potentials.

    The keep score of a pair of sub-blocks (:func:`_stat_block`) is ``max f
    + max g - C(d) + truncate * eps``, max-pooled to tiles of ``block``
    points, the same side for rows and columns. ``d`` is the distance of
    the sub-blocks' centroids less the part of each sub-block's radius
    beyond the slack ``s`` (:func:`keep_slack`: half the keep radius at
    ``eps_min``), clipped at 0. Where neither radius passes ``s``, ``C(d)``
    is the JAX package's centroid rule to the bit (the expansion form
    :func:`_sq_centroids`), so those tables are the JAX package's.

    Guarantee: every pair of points ``(i, j)`` of a dropped tile pair has
    ``f_i + g_j - C(|x_i - y_j| + 2 s) <= -truncate * eps``, since
    ``|x_i - y_j| >= d - 2 s``. At p = 1 the best pointwise score ``f_i +
    g_j - C_ij`` thus lies at most ``2 s = truncate * eps_min`` above
    ``-truncate * eps``; at p = 2 at most ``2 s (|x_i - y_j| + s)`` above
    it (``2 s`` is one keep radius at ``eps_min``). No sub-block loses its
    nearest tiles because its centroid lies away from its points: one that
    straddles a jump of the sort order (a seam) has a large radius, and
    the centroid rule alone scored its nearest tiles below zero at any
    table width (445.6 eps off the solve that keeps every tile, on the
    gallery's fiber bundles at 8,160 points and tile 32;
    ``tools/mid_keep_rule_torch.py``).

    The JAX package rejected the full radii (``s = 0``): they kept ~2.4x
    the tiles, filled its fixed ``cap``, and its top-k then dropped true
    neighbours. The port's widths grow to the largest kept count
    (:func:`kept_width`), so a wider rule costs time, not accuracy, and the
    slack keeps that cost small where the sub-blocks are narrower than the
    keep radius: on an H100 (``chip_smoke.py``) the mean kept tiles a row
    grew 1.21x at 2e6 points and 1.17x at 4e6 on two spheres (blur 0.05,
    tile 1024), 1.10x on the gallery's fibers at 2.1e6 points, and the
    potentials came within 1e-3 eps of the solve that keeps every tile
    (0.71 and 4.75 eps before). At 1e7 points (blur 0.02) the sub-blocks
    are whole tiles of 2,048 points, as wide as the keep radius: the mean
    grew 2.55x, since there the centroid rule also drops the nearest tiles
    of sub-blocks that straddle no jump (its loss was 102x the every-tile
    solve's; this rule's is 1.0e-5 from it, ``tools/keep_rule_gaps_torch.py``).

    ``eps_min`` (default ``eps``) is the finest temperature the table
    serves: ``s`` depends on it alone, so :func:`retighten_counts`' shift
    stays uniform across the temperatures, and ``s`` is at most half the
    keep radius at each of them. ``eps_min = math.inf`` is the JAX
    package's rule. With point weights ``w_x`` / ``w_y``, zero-weight
    (padding) points are left out of the potential maxima, the centroids
    and the radii, and pure-padding tiles are never kept. ``sym``: the
    problem is symmetric (``y is x``, ``g is f``), the transposed table is
    the same table.

    ``cap`` bounds the kept tiles per row tile, a row that keeps more
    keeping its best-scored ``cap``. With no ``cap``, the width is
    ``floor`` (default an eighth of the column tiles, between 32 and 128;
    the mid path's ``mid_cap``) widened by :func:`kept_width` to the
    largest kept count. The JAX package also clamps ``cap`` to its SMEM
    budget (at most 219 tiles per row at 1024-row chunks); the CSR tables
    of the CUDA kernels have no such budget.
    """
    nJ = y.shape[0] // block
    sb = _stat_block(max(x.shape[0], y.shape[0]), block)
    bpt = block // sb

    def blk_stats(pts, v, w):
        nt = pts.shape[0] // sb
        pb = pts.reshape(nt, sb, -1)
        if w is None:
            cent = pb.mean(dim=1)
            rad = torch.sqrt(((pb - cent[:, None, :]) ** 2).sum(-1)).amax(dim=1)
            return cent, v.reshape(nt, sb).amax(dim=1), rad, torch.ones(nt, dtype=torch.bool, device=pts.device)
        wt = torch.clamp(w.reshape(nt, sb), min=0.0)
        wsum = wt.sum(dim=1)
        cent = (pb * wt[..., None]).sum(dim=1) / torch.clamp(wsum, min=1e-30)[:, None]
        # Pure-padding blocks: park at the plain mean (never kept anyway).
        cent = torch.where(wsum[:, None] > 0, cent, pb.mean(dim=1))
        vm = torch.where(wt > 0, v.reshape(nt, sb), NEG_INF).amax(dim=1)
        rad = torch.where(wt > 0, torch.sqrt(((pb - cent[:, None, :]) ** 2).sum(-1)), 0.0).amax(dim=1)
        return cent, vm, rad, wsum > 0

    cx, f_max, rx, x_mass = blk_stats(x, f, w_x)
    cy, g_max, ry, y_mass = blk_stats(y, g, w_y)
    sq = torch.clamp(_sq_centroids(cx, cy), min=0.0)
    C_c = sq / 2 if p == 2 else torch.sqrt(torch.clamp(sq, min=1e-12))
    del sq
    C_c = _seam_cost(C_c, cx, rx, cy, ry, keep_slack(eps if eps_min is None else eps_min, p, truncate), p)
    score = f_max[:, None] + g_max[None, :] - C_c + truncate * eps
    score = torch.where(x_mass[:, None] & y_mass[None, :], score, NEG_INF)
    score = _tile_maxpool(score, bpt)

    if cap is None:
        cap = kept_width(score, floor if floor is not None else max(32, min(nJ // 8, 128)))
    return _tile_mask(score, cap, sym)


def extrap_cap(n_src_tiles):
    """Floor of the width of an :func:`extrap_cols` table: a quarter of the
    source tiles, rounded up to a multiple of 8, between 8 and 64."""
    return max(8, min(64, -(-(n_src_tiles // 4) // 8) * 8))


def extrap_cols(x_rows, y_src, h, eps, truncate, block_n, block_m, cap=None, p=2, radii=True):
    """Kept source tiles of a one-direction truncated softmin onto a fine
    cloud: ``S_i = -eps log sum_j exp(h_j - C_ij/eps)`` over a small source
    cloud (pooled mid blocks), for row tiles of ``block_n`` fine points and
    source tiles of ``block_m`` points.

    Keep rule: a source tile ``J`` survives for row tile ``I`` when an
    upper bound ``U`` on its scores ``h_j - C_ij/eps`` lies within
    ``truncate`` nats of a lower bound ``L`` on the row's best score. Both
    are taken on sub-blocks (:func:`_stat_block` rows, 32 sources) from
    their centroids' distance ``dist`` and radii ``r_x``, ``r_y``: ``U =
    h_max - C(max(0, dist - r_x - r_y))/eps``, max-pooled over the tiles,
    and ``L = max h_max - C(dist + r_x + r_y)/eps`` over the sources, the
    weakest row sub-block of the tile.

    Guarantee: for every row point ``i`` of ``I`` and source point ``j`` of
    a dropped ``J``, ``h_j - C_ij/eps <= max_j' (h_j' - C_ij'/eps) -
    truncate``: each dropped term is at most ``exp(-truncate)`` times the
    row's largest. The JAX package's ``U`` takes the centroid distance with
    no radius (``radii=False``, its tables bit for bit), which is no upper
    bound for a sub-block that straddles a jump of the sort order (a seam,
    whose centroid lies far from its points): on the gallery's fiber
    bundles at 8,160 points it dropped tiles that put the mid path 0.745
    eps off the solve that keeps every tile (``tools/mid_keep_rule_torch.py``).

    ``cap`` bounds the kept source tiles per row tile, a row that keeps
    more keeping its best-scored ``cap``; with no ``cap``, the width is
    :func:`extrap_cap` widened by :func:`kept_width` to the largest kept
    count.

    Returns ``(cols, counts)``: ``(N / block_n, min(width, M / block_m))``
    int32 and ``(N / block_n,)`` int32, every count at least 1.
    """
    N, M = x_rows.shape[0], y_src.shape[0]
    sbx = _stat_block(N, block_n)
    bpt = block_n // sbx
    sby = min(32, block_m)
    spt = block_m // sby
    cx, rx = tile_stats(x_rows, sbx)
    cy, ry = tile_stats(y_src, sby)
    h_smax = h.reshape(M // sby, sby).amax(dim=1)

    dist = torch.sqrt(torch.clamp(_sq_centroids(cx, cy), min=1e-12))
    rr = rx[:, None] + ry[None, :]

    def C_of(d):
        return 0.5 * d**2 if p == 2 else d

    U = h_smax[None, :] - C_of(torch.clamp(dist - rr, min=0.0) if radii else dist) / eps
    L = h_smax[None, :] - C_of(dist + rr) / eps
    thr = L.amax(dim=1)
    if spt > 1:
        U = U.reshape(U.shape[0], -1, spt).amax(dim=2)
    if bpt > 1:
        U = U.reshape(-1, bpt, U.shape[1]).amax(dim=1)
        # Valid for every row of the tile: the weakest sub-block.
        thr = thr.reshape(-1, bpt).amin(dim=1)
    score = U - thr[:, None] + truncate
    if cap is None:
        cap = kept_width(score, extrap_cap(M // block_m), transposed=False)
    cols, counts, _ = _cols_from_score(score, cap)
    return cols, counts


def softmin_extrap_truncated(rows_pts, src_pts, h, eps, truncate, block_n, p=2, block_m=128, cap=24,
                             impl="auto"):
    """Detached truncated one-direction softmin onto a fine cloud,
    ``-eps lse`` over the source tiles :func:`extrap_cols` keeps for each
    row tile (kernel 7, :func:`.cuda_block_sparse.lse_tiles`); ``cap=None``
    widens the table to the largest kept count. ``impl``: ``"blocked"``
    runs the plain twin."""
    cols, counts = extrap_cols(rows_pts, src_pts, h, eps, truncate, block_n, block_m, cap, p=p)
    fn = cbs.lse_tiles_blocked if impl in ("blocked", "dense") else cbs.lse_tiles
    return -eps * fn(rows_pts, src_pts, h, eps, cols, counts, block_n, block_m, p)


def lse_sparse_custom(x, y, h, eps, cols, counts, cost, block):
    """Truncated LSE with a user cost callable, ``log sum_j exp(h_j -
    C(x_i, y_j)/eps)`` over the first ``counts[I]`` column tiles
    ``cols[I, :]`` of each row tile (tiles of ``block`` points on both
    sides). No kernel: the kept column tiles of a chunk of row tiles are
    gathered into a packed block and ``cost((c, block, D), (c, cap *
    block, D)) -> (c, block, cap * block)`` is evaluated on it, followed by
    a masked ``logsumexp``. Plain autograd gives the gradient; each chunk
    is recomputed in the backward pass (activation checkpointing), so
    memory stays ``O(chunk x cap x block^2)`` with at most
    :data:`CUSTOM_CHUNK_ELEMS` elements per chunk.
    """
    N, D = x.shape
    M = y.shape[0]
    nI, cap = cols.shape
    yt = y.reshape(M // block, block, D)
    ht = h.reshape(M // block, block)
    xt = x.reshape(nI, block, D)
    cols = cols.long()
    per = block * cap * block
    chunk = max(1, CUSTOM_CHUNK_ELEMS // per)
    slot = torch.arange(cap, device=cols.device)

    def tiles(xi, ci, ni):
        c = xi.shape[0]
        yg = yt[ci].reshape(c, cap * block, D)
        hg = ht[ci].reshape(c, cap * block)
        C = cost(xi, yg)
        # Frozen entries past the kept count are masked out:
        live = (slot[None, :] < ni[:, None]).repeat_interleave(block, dim=1)
        scores = torch.where(live[:, None, :], hg[:, None, :] - C / eps, NEG_INF)
        return torch.logsumexp(scores, dim=-1).to(h.dtype)

    outs = []
    for i0 in range(0, nI, chunk):
        args = (xt[i0 : i0 + chunk], cols[i0 : i0 + chunk], counts[i0 : i0 + chunk])
        if torch.is_grad_enabled():
            outs.append(checkpoint(tiles, *args, use_reentrant=False))
        else:
            outs.append(tiles(*args))
    return torch.cat(outs).reshape(-1)


# ==============================================================================
#  Fine Sinkhorn steps over the kept tile pairs
# ==============================================================================


def _absorbed_sums(x, y, phi, psi, eps, cols, cnt, p, tile, tri, impl, row_offset=0):
    """Kernel 5 (its plain twin for ``impl`` blocked or dense); a
    ``row_offset`` places a shard of a triangle table's rows."""
    fn = cbs.absorbed_sum_tiles_blocked if impl in ("blocked", "dense") else cbs.absorbed_sum_tiles
    return fn(x, y, phi, psi, eps, cols, cnt, p, tile, tri, row_offset)


def _gibbs_apply(x, y, phi, psi, Vy, Vx, eps, cols, cnt, p, kind, tile, tri, impl, row_offset=0):
    """Kernel 6, as :func:`_absorbed_sums` runs kernel 5."""
    fn = cbs.gibbs_apply_tiles_blocked if impl in ("blocked", "dense") else cbs.gibbs_apply_tiles
    return fn(x, y, phi, psi, Vy, Vx, eps, cols, cnt, p, kind, tile, tri, row_offset)


def sinkhorn_step_walk_banded(eps, x, y, a_log, b_log, f, g, cols, cnt, p=2, tile=512, impl="auto"):
    """Both softmin directions of one Jacobi Sinkhorn iteration over the
    kept tile pairs of ``(cols, cnt)``, from one pass (kernel 5):

    ``S_xy = f + eps (a_log - log r)``, ``S_yx = g + eps (b_log - log c)``.

    ``impl``: ``"blocked"`` runs the plain twin, anything else the kernel
    (which takes the twin itself for CPU tensors).
    """
    phi = a_log + f / eps
    psi = b_log + g / eps
    r, c = _absorbed_sums(x, y, phi, psi, eps, cols, cnt, p, tile, False, impl)
    return _absorbed_update(f, a_log, eps, r), _absorbed_update(g, b_log, eps, c)


def sinkhorn_step_walk_banded_sym(eps, x, a_log, f, cols, cnt, p=2, tile=512, impl="auto"):
    """Symmetric absorbed step over a triangle table: the row direction
    covers the kept ``col >= row`` tiles and the column direction supplies
    the mirrored lower-triangle contributions, ``s = r + c``."""
    phi = a_log + f / eps
    r, c = _absorbed_sums(x, x, phi, phi, eps, cols, cnt, p, tile, True, impl)
    return _absorbed_update(f, a_log, eps, r + c)


# ==============================================================================
#  Differentiable last extrapolation
# ==============================================================================
#
# Gradient semantics as :mod:`.softmin`: S_xy differentiates w.r.t. x only
# and S_yx w.r.t. y only; potentials, weights and eps are constants. The
# backward passes apply the RAW absorbed weights in one pass over the kept
# pairs (kernel 6) with the ones channel, V = [1, y] and [1, x], and divide
# by the forward pass's sums: dx = u (x R_0 - R_1:) / r. The form
# u (x - R_1: / r) of the JAX package turns a float32 error in a row's
# normalization into an error of |y| over the (small) displacement.


def _forward_sums(f, loga, eps, S):
    """Row sums of the forward pass, from its output:
    ``S = f + eps (loga - log r)``."""
    return torch.clamp(torch.exp(loga + (f - S) / eps), min=SUM_FLOOR)


def _ones(v):
    return torch.cat([torch.ones_like(v[:, :1]), v], dim=-1)


def _dx(x, R, r, u):
    return u[:, None] * (x * R[:, :1] - R[:, 1:]) / r[:, None]


@profiling.autograd_spans
class _SoftminExtrapolationWalkBanded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, f, g, loga, logb, eps, cols, cnt, p, tile, impl):
        S_xy, S_yx = sinkhorn_step_walk_banded(
            eps, x, y, loga, logb, f, g, cols, cnt, p, tile, impl
        )
        ctx.save_for_backward(x, y, f, g, loga, logb, cols, cnt, S_xy, S_yx)
        ctx.eps, ctx.p, ctx.tile, ctx.impl = eps, p, tile, impl
        return S_xy, S_yx

    @staticmethod
    def backward(ctx, u_f, u_g):
        x, y, f, g, loga, logb, cols, cnt, S_xy, S_yx = ctx.saved_tensors
        eps, p = ctx.eps, ctx.p
        kind = "gibbs" if p == 2 else "gibbs_grad"
        Rr, Rc = _gibbs_apply(
            x, y, loga + f / eps, logb + g / eps, _ones(y), _ones(x), eps, cols, cnt,
            p, kind, ctx.tile, False, ctx.impl,
        )
        dx = _dx(x, Rr, _forward_sums(f, loga, eps, S_xy), u_f).to(x.dtype)
        dy = _dx(y, Rc, _forward_sums(g, logb, eps, S_yx), u_g).to(y.dtype)
        return (dx, dy) + (None,) * 10


def softmin_extrapolation_walk_banded(x, y, f, g, loga, logb, eps, cols, cnt, p, tile, impl="auto"):
    r"""Raw softmin pair ``(S_xy, S_yx)`` of the differentiable last
    extrapolation over the kept tile pairs: the forward is one pass of
    kernel 5, the backward one pass of kernel 6 for both gradients."""
    return _SoftminExtrapolationWalkBanded.apply(
        x, y, f, g, loga, logb, eps, cols, cnt, p, tile, impl
    )


@profiling.autograd_spans
class _SoftminExtrapolationWalkBandedSym(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, f, loga, eps, cols, cnt, p, tile, impl):
        S = sinkhorn_step_walk_banded_sym(eps, x, loga, f, cols, cnt, p, tile, impl)
        ctx.save_for_backward(x, f, loga, cols, cnt, S)
        ctx.eps, ctx.p, ctx.tile, ctx.impl = eps, p, tile, impl
        return S

    @staticmethod
    def backward(ctx, u):
        x, f, loga, cols, cnt, S = ctx.saved_tensors
        eps, p = ctx.eps, ctx.p
        kind = "gibbs" if p == 2 else "gibbs_grad"
        phi = loga + f / eps
        V = _ones(x)
        Rr, Rc = _gibbs_apply(x, x, phi, phi, V, V, eps, cols, cnt, p, kind, ctx.tile, True, ctx.impl)
        # Upper-triangle rows plus the mirrored lower-triangle columns:
        dx = _dx(x, Rr + Rc, _forward_sums(f, loga, eps, S), u).to(x.dtype)
        return (dx,) + (None,) * 8


def softmin_extrapolation_walk_banded_sym(x, f, loga, eps, cols, cnt, p, tile, impl="auto"):
    """Symmetric-problem (debias) variant of
    :func:`softmin_extrapolation_walk_banded` over a triangle table."""
    return _SoftminExtrapolationWalkBandedSym.apply(x, f, loga, eps, cols, cnt, p, tile, impl)


# ==============================================================================
#  Truncated softmin and MMD matvec over (cols, counts) tables
# ==============================================================================
#
# Row tiles of ``block`` points visit the first ``counts[I]`` column tiles
# ``cols[I, :]`` (tiles of ``block`` points too); the transposed direction
# reads ``colsT/countsT``. Forward passes run kernel 7's CUDA kernel
# (``lse_sparse``) or kernel 8 (``gibbs_apply_sparse``); backward passes
# are kernel 8 applies, only those whose gradients autograd asks for (the
# gaussian matvec makes its dx apply in the forward instead).
# ``impl``: ``"blocked"`` (or ``"dense"``) runs the plain twins.

gibbs_apply_sparse = cbs.gibbs_apply_sparse


def _sparse_apply(impl):
    return cbs.gibbs_apply_sparse_blocked if impl in ("blocked", "dense") else cbs.gibbs_apply_sparse


def lse_sparse(x, y, h, eps, cols, counts, p=2, block_n=256, block_m=512, impl="auto"):
    """Truncated ``log sum_j exp(h_j - C_p(x_i, y_j)/eps)`` over the column
    tiles in ``cols`` (:func:`.cuda_block_sparse.lse_sparse`)."""
    if impl in ("blocked", "dense"):
        return cbs.lse_tiles_blocked(x, y, h, eps, cols, counts, block_n, block_m, p)
    return cbs.lse_sparse(x, y, h, eps, cols, counts, p, block_n, block_m)


@profiling.spanned("multiscale.tables")
def masks_from_geometry(x, y, radius, block, cap=None, w_x=None, w_y=None, sym=False, stat_block=None):
    """Tile masks from a pure distance rule: keep the tile pairs whose
    smallest possible pointwise distance (centroid distance minus both
    radii, on sub-blocks of :func:`_stat_block` points, max-pooled to tiles
    of ``block``) lies below ``radius``. Zero-weight (padding) sub-blocks
    are never kept; ``sym``: ``y`` is ``x``, the transposed table is the
    same table. ``cap`` bounds the kept tiles per row, a row that keeps
    more keeping its best-scored ``cap`` (default: an eighth of the column
    tiles, between 8 and 128, widened by :func:`kept_width` to the largest
    kept count; the forward and backward passes then read the same pairs).

    The JAX package also clamps ``cap`` to its SMEM budget,
    ``400_000 // (4 min(max(nI, nJ), 1024))``: it binds from 1024 row
    tiles on (97 instead of 128); the CSR tables of the CUDA kernels have
    no such budget.
    """
    nJ = y.shape[0] // block
    sb = stat_block if stat_block is not None else _stat_block(max(x.shape[0], y.shape[0]), block)
    cx, rx = tile_stats(x, sb)
    cy, ry = tile_stats(y, sb)
    score = radius - _pair_dist_lb(cx, rx, cy, ry)  # > 0 <=> kept

    def blk_mass(w, pts):
        nt = pts.shape[0] // sb
        if w is None:
            return torch.ones(nt, dtype=torch.bool, device=pts.device)
        return (w.reshape(nt, sb) > 0).any(dim=1)

    valid = blk_mass(w_x, x)[:, None] & blk_mass(w_y, y)[None, :]
    score = _tile_maxpool(torch.where(valid, score, NEG_INF), block // sb)
    if cap is None:
        cap = kept_width(score, max(8, min(nJ // 8, 128)))
    return _tile_mask(score, cap, sym)


@profiling.autograd_spans
class _LseSparseDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, h, eps, cols, counts, colsT, countsT, p, block, impl):
        out = lse_sparse(x, y, h, eps, cols, counts, p, block, block, impl)
        ctx.save_for_backward(x, y, h, cols, counts, colsT, countsT, out)
        ctx.eps, ctx.p, ctx.block, ctx.impl = eps, p, block, impl
        return out

    @staticmethod
    def backward(ctx, u):
        # The analytic backward of ops/softmin.py::_LsePoints, restricted to
        # the kept tiles: w_ij = exp(h_j - C_ij/eps - out_i).
        x, y, h, cols, counts, colsT, countsT, out = ctx.saved_tensors
        eps, p, b = ctx.eps, ctx.p, ctx.block
        need_x, need_y, need_h = ctx.needs_input_grad[:3]
        apply = _sparse_apply(ctx.impl)
        phi, psi = -out, h
        kind = "gibbs" if p == 2 else "gibbs_grad"
        dx = dy = dh = None
        if need_x:
            R = apply(x, y, phi, psi, _ones(y), eps, cols, counts, p, kind, b, b)
            dx = (-(u / eps)[:, None] * (x * R[:, :1] - R[:, 1:])).to(x.dtype)
        if need_y or (need_h and p == 2):
            Tq = apply(y, x, psi, phi, u[:, None] * _ones(x), eps, colsT, countsT, p, kind, b, b)
            if need_y:
                dy = (-(1.0 / eps) * (y * Tq[:, :1] - Tq[:, 1:])).to(y.dtype)
            if need_h:
                dh = Tq[:, 0].to(h.dtype)
        if need_h and p == 1:
            dh = apply(y, x, psi, phi, u[:, None], eps, colsT, countsT, p, "gibbs", b, b)[:, 0].to(h.dtype)
        return (dx, dy, dh) + (None,) * 8


def softmin_sparse(eps, C_xy, h, p=2, block=256, impl="auto"):
    """Truncated softmin ``-eps log sum_j exp(h_j - C_p(x_i, y_j)/eps)``
    over the kept tiles of ``C_xy = (x, y, mask)``, ``mask`` a
    :class:`TileMask` of the (x-rows, y-cols) direction (tiles of
    ``block`` points on both sides); differentiable in ``x``, ``y`` and
    ``h``, the backward passes reading ``mask.colsT/countsT`` for the
    transposed direction."""
    x, y, mask = C_xy
    out = _LseSparseDiff.apply(
        x, y, h, eps, mask.cols, mask.counts, mask.colsT, mask.countsT, p, block, impl
    )
    return -eps * out


@profiling.autograd_spans
class _KernelMatvecSparse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, v, eps, cols, counts, colsT, countsT, p, block, impl, fold):
        ctx.eps, ctx.p, ctx.block, ctx.impl = eps, p, block, impl
        apply = _sparse_apply(impl)
        zx, zy = x.new_zeros(x.shape[0]), y.new_zeros(y.shape[0])
        profiling.count("matvec.forwards")
        if fold:
            # The backward's dx apply (p = 2), whose channel 0 is the output:
            profiling.count("matvec.grad_in_forward")
            R = apply(x, y, zx, zy, v[:, None] * _ones(y), eps, cols, counts, p, "gibbs", block, block)
            ctx.save_for_backward(x, y, v, cols, counts, colsT, countsT, R)
            return R[:, 0]
        ctx.save_for_backward(x, y, v, cols, counts, colsT, countsT, None)
        return apply(x, y, zx, zy, v[:, None], eps, cols, counts, p, "gibbs", block, block)[:, 0]

    @staticmethod
    def backward(ctx, u):
        # O_i = sum_j w_ij v_j with w_ij = exp(-C_p(x_i, y_j)/eps):
        #   dv_j = sum_i w_ij u_i                            (transposed apply)
        #   dx_i = -(u_i / eps) sum_j w'_ij v_j (x_i - y_j)
        #   dy_j = -(1 / eps) sum_i w'_ij u_i (y_j - x_i)
        # where w' = w for p=2 and w/d for p=1, in the ones-channel form
        # x R_0 - R_1: (the JAX package's form too). R is the forward's
        # where it folded, None otherwise.
        x, y, v, cols, counts, colsT, countsT, R = ctx.saved_tensors
        eps, p, b = ctx.eps, ctx.p, ctx.block
        need_x, need_y, need_v = ctx.needs_input_grad[:3]
        apply = _sparse_apply(ctx.impl)
        zx, zy = x.new_zeros(x.shape[0]), y.new_zeros(y.shape[0])
        kind = "gibbs" if p == 2 else "gibbs_grad"
        dx = dy = dv = None
        if need_x:
            if R is None:
                R = apply(x, y, zx, zy, v[:, None] * _ones(y), eps, cols, counts, p, kind, b, b)
            dx = (-(u / eps)[:, None] * (x * R[:, :1] - R[:, 1:])).to(x.dtype)
        if need_y or (need_v and p == 2):
            T = apply(y, x, zy, zx, u[:, None] * _ones(x), eps, colsT, countsT, p, kind, b, b)
            if need_y:
                dy = (-(v / eps)[:, None] * (y * T[:, :1] - T[:, 1:])).to(y.dtype)
            if need_v:
                dv = T[:, 0].to(v.dtype)
        if need_v and p == 1:
            dv = apply(y, x, zy, zx, u[:, None], eps, colsT, countsT, p, "gibbs", b, b)[:, 0].to(v.dtype)
        return (dx, dy, dv) + (None,) * 9


def kernel_matvec_sparse(x, y, v, eps, mask, p=2, block=512, impl="auto"):
    """Differentiable truncated Gibbs-kernel matvec
    ``O_i = sum_j exp(-C_p(x_i, y_j)/eps) v_j`` over the kept tiles of
    ``mask`` (gaussian: p=2, eps=blur^2; laplacian: p=1, eps=blur).

    With p = 2, grad enabled and ``x`` requiring grad, the forward folds
    in the gradient's channels: one apply of ``V = v [1, y]`` (four
    channels) gives ``O`` in channel 0 and keeps the rest for ``dx``, so
    the backward makes no apply for ``x``. A forward that no backward
    follows then pays the four-channel apply instead of the one-channel
    one; under ``torch.no_grad()`` it pays nothing more. p = 1 (whose
    gradient weighs the pairs by ``w / d``) never folds.
    """
    fold = p == 2 and torch.is_grad_enabled() and x.requires_grad
    return _KernelMatvecSparse.apply(
        x, y, v, eps, mask.cols, mask.counts, mask.colsT, mask.countsT, p, block, impl, fold
    )


# ==============================================================================
#  Public sparse and walk Sinkhorn ops (kernels 10-12)
# ==============================================================================
#
# One-direction absorbed softmins over a ``(cols, counts)`` table (kernel
# 12, ``_absorbed_sum``) or a :func:`walk_plan` table (kernel 10,
# ``_absorbed_sum_walk``), tiles of ``block`` points on both sides; the
# transposed direction reads ``mask.colsT/countsT`` or ``tblT``. Their
# backward passes apply the raw weights with the ones channel (kernel 8 or
# kernel 11) and divide by the forward pass's sums, as the banded
# extrapolation above (``_dx``), where the JAX package takes ``u (x - R)``
# with row-normalised weights for p = 2. ``impl``: ``"blocked"`` (or
# ``"dense"``) runs the plain twins.

walk_plan = cbs.walk_plan


def _absorbed_sum(x, y, phi, psi, eps, cols, counts, p, block, impl="auto"):
    """``r_i = sum_j exp(phi_i + psi_j - C_ij/eps)`` over the kept tiles of
    ``(cols, counts)``, floored at 1e-37 (kernel 12)."""
    fn = cbs.absorbed_sum_sparse_blocked if impl in ("blocked", "dense") else cbs.absorbed_sum_sparse
    return torch.clamp(fn(x, y, phi, psi, eps, cols, counts, p, block), min=SUM_FLOOR)


def _absorbed_sum_walk(x, y, phi, psi, eps, tbl, p, block, impl="auto"):
    """:func:`_absorbed_sum` over a :func:`walk_plan` table (kernel 10)."""
    fn = cbs.absorbed_sum_walk_blocked if impl in ("blocked", "dense") else cbs.absorbed_sum_walk
    return torch.clamp(fn(x, y, phi, psi, eps, tbl, p, block), min=SUM_FLOOR)


def gibbs_apply_walk(x, y, phi, psi, V, eps, tbl, p=2, kind="gibbs", block_n=512, block_m=512, impl="auto"):
    """:func:`gibbs_apply_sparse` over a :func:`walk_plan` table (kernel 11,
    :func:`.cuda_block_sparse.gibbs_apply_walk`)."""
    fn = cbs.gibbs_apply_walk_blocked if impl in ("blocked", "dense") else cbs.gibbs_apply_walk
    return fn(x, y, phi, psi, V, eps, tbl, p, kind, block_n, block_m)


def sinkhorn_step_sparse(eps, x, y, a_log, b_log, f, g, mask, p=2, block=512, sym=False, impl="auto"):
    """Both raw softmin values of one truncated Sinkhorn iteration over the
    kept tiles of ``mask`` (a :class:`TileMask`): ``S_xy = f + eps (a_log -
    log r)`` from ``mask.cols/counts``, ``S_yx = g + eps (b_log - log c)``
    from ``mask.colsT/countsT``; ``sym`` returns ``(S_xy, None)``."""
    phi = a_log + f / eps
    psi = b_log + g / eps
    S_xy = _absorbed_update(f, a_log, eps, _absorbed_sum(x, y, phi, psi, eps, mask.cols, mask.counts, p, block, impl))
    if sym:
        return S_xy, None
    c = _absorbed_sum(y, x, psi, phi, eps, mask.colsT, mask.countsT, p, block, impl)
    return S_xy, _absorbed_update(g, b_log, eps, c)


def sinkhorn_step_walk(eps, x, y, a_log, b_log, f, g, tbl, tblT, p=2, block=512, sym=False, impl="auto"):
    """:func:`sinkhorn_step_sparse` over the :func:`walk_plan` tables
    ``tbl`` (rows of x) and ``tblT`` (rows of y)."""
    phi = a_log + f / eps
    psi = b_log + g / eps
    S_xy = _absorbed_update(f, a_log, eps, _absorbed_sum_walk(x, y, phi, psi, eps, tbl, p, block, impl))
    if sym:
        return S_xy, None
    c = _absorbed_sum_walk(y, x, psi, phi, eps, tblT, p, block, impl)
    return S_xy, _absorbed_update(g, b_log, eps, c)


def _table_ops(table, eps, p, block, impl):
    """The row sums and the apply of one direction over ``table``: a
    ``(cols, counts)`` pair or a :func:`walk_plan` table."""
    if isinstance(table, torch.Tensor):
        def sums(x, y, phi, psi):
            return _absorbed_sum_walk(x, y, phi, psi, eps, table, p, block, impl)

        def apply(x, y, phi, psi, V, kind):
            return gibbs_apply_walk(x, y, phi, psi, V, eps, table, p, kind, block, block, impl)
    else:
        cols, counts = table

        def sums(x, y, phi, psi):
            return _absorbed_sum(x, y, phi, psi, eps, cols, counts, p, block, impl)

        def apply(x, y, phi, psi, V, kind):
            return _sparse_apply(impl)(x, y, phi, psi, V, eps, cols, counts, p, kind, block, block)
    return sums, apply


@profiling.autograd_spans
class _AbsorbedSoftminRows(torch.autograd.Function):
    """``S = f + eps (loga - log r)`` with ``r`` the absorbed row sums over
    a table; differentiable in x only (y gets zeros where asked)."""

    @staticmethod
    def forward(ctx, x, y, f, g, loga, logb, eps, ops, p):
        sums, apply = ops
        S = _absorbed_update(f, loga, eps, sums(x, y, loga + f / eps, logb + g / eps))
        ctx.save_for_backward(x, y, f, g, loga, logb, S)
        ctx.eps, ctx.p, ctx.apply_rows = eps, p, apply
        return S

    @staticmethod
    def backward(ctx, u):
        x, y, f, g, loga, logb, S = ctx.saved_tensors
        eps = ctx.eps
        dx = dy = None
        if ctx.needs_input_grad[0]:
            kind = "gibbs" if ctx.p == 2 else "gibbs_grad"
            R = ctx.apply_rows(x, y, loga + f / eps, logb + g / eps, _ones(y), kind)
            dx = _dx(x, R, _forward_sums(f, loga, eps, S), u).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dy = torch.zeros_like(y)
        return (dx, dy) + (None,) * 7


def _softmin_rows(x, y, f, g, loga, logb, eps, table, p, block, impl):
    return _AbsorbedSoftminRows.apply(x, y, f, g, loga, logb, eps, _table_ops(table, eps, p, block, impl), p)


def softmin_extrapolation_sparse(x, y, f, g, loga, logb, eps, cols, counts, colsT, countsT, p, block, impl="auto"):
    r"""Raw softmin pair ``(S_xy, S_yx)`` of the truncated differentiable
    last extrapolation (:func:`sinkhorn_step_sparse`'s values): ``S_xy``
    differentiates w.r.t. x only, ``S_yx`` w.r.t. y only; potentials,
    weights and eps are constants."""
    S_xy = _softmin_rows(x, y.detach(), f, g, loga, logb, eps, (cols, counts), p, block, impl)
    S_yx = _softmin_rows(y, x.detach(), g, f, logb, loga, eps, (colsT, countsT), p, block, impl)
    return S_xy, S_yx


def softmin_extrapolation_sparse_sym(x, f, loga, eps, cols, counts, p, block, impl="auto"):
    """Symmetric-problem (debias) truncated extrapolation over a full
    (not triangle) table: one direction, the second cloud detached."""
    return _softmin_rows(x, x.detach(), f, f, loga, loga, eps, (cols, counts), p, block, impl)


def softmin_extrapolation_sparse_dir(x, y, f, g, loga, logb, eps, cols, counts, p, block, impl="auto"):
    """One direction of the truncated differentiable extrapolation, over
    the rows of x: gradient to x only (y gets zeros)."""
    return _softmin_rows(x, y, f, g, loga, logb, eps, (cols, counts), p, block, impl)


def softmin_extrapolation_walk(x, y, f, g, loga, logb, eps, tbl, tblT, p, block, impl="auto"):
    """:func:`softmin_extrapolation_sparse` over :func:`walk_plan` tables."""
    S_xy = _softmin_rows(x, y.detach(), f, g, loga, logb, eps, tbl, p, block, impl)
    S_yx = _softmin_rows(y, x.detach(), g, f, logb, loga, eps, tblT, p, block, impl)
    return S_xy, S_yx


def softmin_extrapolation_walk_sym(x, f, loga, eps, tbl, p, block, impl="auto"):
    """:func:`softmin_extrapolation_sparse_sym` over a :func:`walk_plan`
    table."""
    return _softmin_rows(x, x.detach(), f, f, loga, loga, eps, tbl, p, block, impl)
