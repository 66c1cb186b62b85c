"""The truncated gaussian kernel norm (MMD) and its gradient in x, in
plain PyTorch.

``SamplesLoss("gaussian", blur=s, truncate=t, backend="multiscale")`` is

    1/2 <a, K_xx a> + 1/2 <b, K_yy b> - <a, K_xy b>,
    k(x, y) = exp(-|x - y|^2 / (2 s^2)),

where each matrix keeps only the pairs of tiles that the truncation keeps:
both clouds are cut into tiles of consecutive points of their Hilbert
order (:mod:`spatial`, padded with zero-weight points), and a pair of
tiles is kept where some pair of their sub-blocks may lie closer than
``t s`` (centroid distance less both radii, from the float32 points).
Every point pair of a kept tile pair counts in full.

That truncation is the port's own, not upstream GeomLoss's (which keeps
the pairs of voxel-grid clusters): the tile side (:func:`spatial.auto_tile`),
the sub-blocks (:func:`stat_block`), the Hilbert order and the keep rule
define which pairs the value holds, so they are frozen here. The dropped
pairs lie beyond ``t s`` and weigh up to ``exp(-t^2 / 2)`` each, more
than float32's rounding, so no limit could judge the port against the
untruncated MMD. A program that keeps other tiles needs a reference file
of its own. The reference computes the rule itself from the raw clouds,
with the same float32 arithmetic (a pair of sub-blocks at the radius to
the last bit would otherwise flip), then every kept sum in float64.

The gradient in ``x_i`` is ``a_i / s^2 (sum_j b_j k_ij (x_i - y_j) -
sum_k a_k k_ik (x_i - x_k))`` over the kept pairs of ``x_i``'s tile.
"""

import torch

from . import pairs, spatial

#: Bound on the sub-blocks of the tile geometry.
MAX_STAT_BLOCKS = 8192


def stat_block(npad, tile):
    """Sub-block side: 64 points, doubled until at most
    :data:`MAX_STAT_BLOCKS` sub-blocks, never above the tile."""
    sb = 64
    while npad // sb > MAX_STAT_BLOCKS:
        sb *= 2
    return min(sb, tile)


def _stats(pts, sb):
    n, D = pts.shape
    blk = pts.reshape(n // sb, sb, D)
    cent = blk.mean(dim=1)
    rad = torch.sqrt(((blk - cent[:, None, :]) ** 2).sum(-1)).amax(dim=1)
    return cent, rad


def kept_tile_pairs(x_s, a_s, y_s, b_s, radius, tile):
    """``(nI, nJ)`` bool: the tile pairs the truncation keeps (float32
    sorted, padded clouds and their weights)."""
    sb = stat_block(max(x_s.shape[0], y_s.shape[0]), tile)
    cx, rx = _stats(x_s, sb)
    cy, ry = _stats(y_s, sb)
    sq = (cx**2).sum(-1)[:, None] + (cy**2).sum(-1)[None, :] - 2.0 * (cx @ cy.T)
    lb = torch.clamp(torch.sqrt(torch.clamp(sq, min=1e-12)) - rx[:, None] - ry[None, :], min=0.0)
    score = radius - lb
    vx = (a_s.reshape(-1, sb) > 0).any(dim=1)
    vy = (b_s.reshape(-1, sb) > 0).any(dim=1)
    score = torch.where(vx[:, None] & vy[None, :], score, -1e30)
    bpt = tile // sb
    nI, nJ = score.shape[0] // bpt, score.shape[1] // bpt
    return score.reshape(nI, bpt, nJ, bpt).amax(dim=(1, 3)) > 0


def _sums(x, y, v, keep, tile, s2, rows_at, tf32):
    """``sum_j v_j k_ij`` for every row of ``x`` over its tile's kept tiles
    of ``y``; for the rows marked by ``rows_at``, also ``sum_j v_j k_ij
    y_j`` (in row order)."""
    out = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    firsts = []
    ysq = (y * y).sum(1) / (2 * s2)
    xsq = (x * x).sum(1) / (2 * s2)
    col_of = torch.arange(y.shape[0], device=y.device).reshape(-1, tile)
    for I in range(keep.shape[0]):
        r0, r1 = I * tile, (I + 1) * tile
        cols = col_of[keep[I].nonzero()[:, 0]].reshape(-1)
        yc = y.index_select(0, cols)
        k = torch.exp(pairs.cross(x[r0:r1], yc, tf32) / s2 - ysq.index_select(0, cols)[None, :] - xsq[r0:r1, None])
        vc = v.index_select(0, cols)
        out[r0:r1] = pairs.cross(k, vc[None, :], tf32)[:, 0]
        sel = rows_at[r0:r1].nonzero()[:, 0] if rows_at is not None else None
        if sel is not None and sel.numel():
            firsts.append(pairs.cross(k.index_select(0, sel), (vc[:, None] * yc).T.contiguous(), tf32))
        del k
    if rows_at is None:
        return out
    return out, (torch.cat(firsts) if firsts else x.new_zeros((0, x.shape[1])))


def compute(inputs, call, grad_rows, dtype=torch.float64, tf32=False):
    """The value and the gradient rows ``grad_rows`` (indices into ``x``)
    of the truncated gaussian MMD of the weighted clouds of ``inputs``
    (``a``, ``x``, ``b``, ``y``), computed in ``dtype`` (``tf32``: float32
    with TF32 matrix products, the control). Returns ``(value, grad)`` as
    :func:`sinkhorn.compute`."""
    a_in, x, b_in, y = inputs["a"], inputs["x"], inputs["b"], inputs["y"]
    if call.get("loss") != "gaussian" or call.get("backend") != "multiscale" or call.get("truncate") is None:
        raise NotImplementedError("the reference covers the truncated gaussian MMD on the multiscale route")
    N, D = x.shape
    M = y.shape[0]
    blur = call.get("blur", 0.05)
    s2 = blur * blur
    tile = spatial.auto_tile(max(N, M))
    dev = x.device
    a_s, x_s, ox = spatial.sorted_padded(a_in, x, tile)
    b_s, y_s, oy = spatial.sorted_padded(b_in, y, tile)
    radius = call["truncate"] * blur
    keep_xx = kept_tile_pairs(x_s, a_s, x_s, a_s, radius, tile)
    keep_xy = kept_tile_pairs(x_s, a_s, y_s, b_s, radius, tile)
    keep_yy = kept_tile_pairs(y_s, b_s, y_s, b_s, radius, tile)

    a64, x64, b64, y64 = (t.to(dtype) for t in (a_s, x_s, b_s, y_s))
    pos = torch.empty(ox.shape[0], dtype=torch.long, device=dev)
    pos[ox] = torch.arange(ox.shape[0], device=dev)
    at = torch.zeros(ox.shape[0], dtype=torch.bool, device=dev)
    at[pos[grad_rows]] = True

    Kxx_a, Kxx_ax = _sums(x64, x64, a64, keep_xx, tile, s2, at, tf32)
    Kxy_b, Kxy_by = _sums(x64, y64, b64, keep_xy, tile, s2, at, tf32)
    Kyy_b = _sums(y64, y64, b64, keep_yy, tile, s2, None, tf32)
    value = 0.5 * torch.dot(a64, Kxx_a) + 0.5 * torch.dot(b64, Kyy_b) - torch.dot(a64, Kxy_b)

    xa = x64[at]
    grad = a64[at][:, None] / s2 * (xa * (Kxy_b[at] - Kxx_a[at])[:, None] - (Kxy_by - Kxx_ax))
    rank = torch.cumsum(at.long(), 0) - 1
    return float(value), grad[rank[pos[grad_rows]]]
