r"""Block-sparse kernel truncation of the multiscale fine phase.

Counterpart of :mod:`geomloss_tpu.ops.block_sparse` for the classic
multiscale path. Points are spatially sorted and cut into fixed kernel
tiles; each row tile ``I`` keeps the column tiles of a top-k keep score
(``masks_from_coarse``), and the fine Sinkhorn steps and the last
extrapolation visit the kept tile pairs only.

A table is a pair ``(cols, cnt)``: ``cols`` ``(nI, ck)`` int32 holds each
row tile's column tiles in keep-score order and row tile ``I`` visits the
first ``cnt[I]`` of them. The JAX package packs the same tables into
band-major step lists for the TPU's sequential grid (``walk_plan_banded``);
the CUDA kernels (:mod:`.cuda_block_sparse`) walk the CSR lists directly,
so that packing has no counterpart, and neither have the TPU's budget
limits on the tables (``MAX_TABLE_ROWS`` and the SMEM clamp on ``cap``).
The function names follow the JAX package's, ``walk_banded`` included, so
that each counterpart can be found.
"""

from typing import NamedTuple

import torch

from . import cuda_block_sparse as cbs
from .cuda_kernels import SUM_FLOOR, _absorbed_update
from .costs import cost_routines

__all__ = [
    "TileMask",
    "tile_stats",
    "retighten_counts",
    "masks_from_coarse",
    "sinkhorn_step_walk_banded",
    "sinkhorn_step_walk_banded_sym",
    "softmin_extrapolation_walk_banded",
    "softmin_extrapolation_walk_banded_sym",
]

NEG_INF = -1e30


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


def retighten_counts(vals, delta):
    """Per-row kept-tile counts after shifting every keep score by ``delta``.

    The truncation score moves by a *uniform* ``truncate * (eps' - eps)``
    when the temperature changes, so the order of ``cols`` is unchanged and
    only the threshold moves: the same tables serve every annealing step.
    """
    return torch.clamp((vals + delta > 0).sum(dim=1), min=1).to(torch.int32)


def masks_from_coarse(
    cx, cy, f_c, g_c, w_x, w_y, eps, p, truncate, blocks_per_tile, cap=None, sym=False
):
    """Tile masks from the reference's *pointwise* centroid keep rule.

    ``f_c[k] + g_c[l] > C(c_k, c_l) - truncate * eps`` on the cluster-block
    centroids, max-pooled onto kernel tiles of ``blocks_per_tile``
    consecutive blocks.

    Args:
        cx, cy: ``(K_x, D)`` / ``(K_y, D)`` block centroids (sorted order).
        f_c, g_c: coarse dual potentials on the centroids.
        w_x, w_y: coarse block weights (zero = padding, never kept).
        blocks_per_tile: tile // block_size.
        cap: bound on kept column tiles per row tile (default: an eighth of
            the column tiles, between 32 and 128).
        sym: the problem is symmetric (``cy is cx``, ``g_c is f_c``): the
            transposed table is the same table.

    Returns:
        :class:`TileMask`.
    """
    C = cost_routines[p](cx, cy)
    score = f_c[:, None] + g_c[None, :] - C + truncate * eps
    valid = (w_x > 0)[:, None] & (w_y > 0)[None, :]
    score = torch.where(valid, score, torch.full_like(score, NEG_INF))
    Kx, Ky = score.shape
    nI, nJ = Kx // blocks_per_tile, Ky // blocks_per_tile
    score_t = score.reshape(nI, blocks_per_tile, nJ, blocks_per_tile).amax(dim=(1, 3))
    if cap is None:
        cap = max(32, min(nJ // 8, 128))
    cols, counts, vals = _cols_from_score(score_t, cap)
    if sym:
        colsT, countsT, valsT = cols, counts, vals
    else:
        colsT, countsT, valsT = _cols_from_score(score_t.T, cap)
    return TileMask(
        cols=cols, counts=counts, colsT=colsT, countsT=countsT, vals=vals, valsT=valsT
    )


# ==============================================================================
#  Fine Sinkhorn steps over the kept tile pairs
# ==============================================================================


def _absorbed_sums(x, y, phi, psi, eps, cols, cnt, p, tile, tri, impl):
    fn = cbs.absorbed_sum_tiles_blocked if impl in ("blocked", "dense") else cbs.absorbed_sum_tiles
    return fn(x, y, phi, psi, eps, cols, cnt, p, tile, tri)


def _gibbs_apply(x, y, phi, psi, Vy, Vx, eps, cols, cnt, p, kind, tile, tri, impl):
    fn = cbs.gibbs_apply_tiles_blocked if impl in ("blocked", "dense") else cbs.gibbs_apply_tiles
    return fn(x, y, phi, psi, Vy, Vx, eps, cols, cnt, p, kind, tile, tri)


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
